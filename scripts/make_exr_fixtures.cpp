// Writes the OpenEXR test fixtures of tests/data/exr/ with the OpenEXR
// library (3.x), and the values they hold as expected.npy.
//
//   c++ -O1 -std=c++17 -I/usr/include/OpenEXR -I/usr/include/Imath \
//       scripts/make_exr_fixtures.cpp -o make_exr_fixtures \
//       -lOpenEXR -lImath -lIex -lIlmThread
//   ./make_exr_fixtures tests/data/exr
//
// Supported kinds (arnerf_tpu_torch/image_io.py reads them), W x H = 21 x 35
// so that ZIP's 16-line and PIZ's 32-line blocks end in a partial one:
//   {none,rle,zips,zip,piz}_{half,float}_{rgb,rgba}.exr
//   zip_half_rgba_window.exr      dataWindow (4, -3) - (24, 31)
//   zips_half_rgba_decreasing.exr lineOrder DECREASING_Y
//   zip_mixed_rgbaz.exr           R, G HALF; B, A FLOAT; an extra UINT "Z"
//   piz_mixed_{rgb,rgba}.exr      R, G HALF; B (, A) FLOAT; an extra UINT "Z"
// and three PIZ files whose values are their own, in <name>.npy (float32,
// H x W x channels):
//   piz_half_rgba_window.exr  21 x 45 at dataWindow (5, -7) - (25, 37):
//                             a full 32-line block and a 13-line one
//   piz_half_rgb_raw.exr      21 x 64: a block of random HALF words, which
//                             OpenEXR stores raw, then a compressed one
//   piz_float_rgb_wav16.exr   256 x 32 FLOAT ramps with noise in the low
//                             word: over 2^14 distinct words, so the block
//                             takes the 16-bit wavelet
// Kinds the reader refuses (8 x 8): pxr24, b44, b44a, dwaa, dwab
// compression; tiled, multi-part and deep files; a luminance-only file; UINT
// colour channels.
//
// expected.npy is float32 (2, H, W, 4), channels R, G, B, A: [0] the values
// of the FLOAT channels, [1] the same values rounded to HALF as the HALF
// channels hold them. RGB spans 1e-4 to 6e4 on smooth ramps (so that every
// codec compresses) with a block of zeros; A steps through 0 ... 1.
// expected_piz.npy holds the same for the piz_{half,float,mixed}_* files
// (master_piz: RGB in [0.5, 1.25], so that PIZ compresses).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <ImfChannelList.h>
#include <ImfDeepFrameBuffer.h>
#include <ImfDeepScanLineOutputFile.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfMultiPartOutputFile.h>
#include <ImfOutputFile.h>
#include <ImfOutputPart.h>
#include <ImfPartType.h>
#include <ImfTiledOutputFile.h>
#include <half.h>

namespace {

const int W = 21, H = 35;
std::string dir;

float master(int y, int x, int c) {
  if (c == 3) return (float)((3 * x + y) % 11) / 10.0f;
  if (x < 3 && y < 5) return 0.0f;
  const int step = (x + 2 * y + 7 * c) % 97;
  return (float)std::pow(10.0, -4.0 + 8.78 * step / 96.0);
}

// The PIZ files' channels. OpenEXR stores every PIZ block of master()'s
// values raw: its HALF words span 0x068d..0x7b53, so each block's bitmap
// alone (3.8 KB) is nearly the block's size. These ramps span [0.5, 1.25]
// plus FLOAT detail below HALF's precision, and compress.
float master_piz(int y, int x, int c) {
  if (c == 3) return (float)((3 * x + y) % 11) / 10.0f;
  if (x < 3 && y < 5) return 0.0f;
  const int step = (x + 2 * y + 7 * c) % 97;
  return 0.5f + step / 128.0f + (float)((x * y) % 5) * std::ldexp(1.0f, -20);
}

// Pixel planes of one file: float and half copies of the master channels,
// and a UINT plane.
struct Planes {
  std::vector<float> f[4];
  std::vector<half> h[4];
  std::vector<uint32_t> u;
  Planes(int w, int hgt, bool piz = false) {
    for (int c = 0; c < 4; c++) {
      f[c].resize((size_t)w * hgt);
      h[c].resize((size_t)w * hgt);
      for (int y = 0; y < hgt; y++)
        for (int x = 0; x < w; x++) {
          f[c][(size_t)y * w + x] = piz ? master_piz(y % H, x % W, c)
                                        : master(y % H, x % W, c);
          h[c][(size_t)y * w + x] = half(f[c][(size_t)y * w + x]);
        }
    }
    u.resize((size_t)w * hgt);
    for (size_t i = 0; i < u.size(); i++)
      u[i] = piz ? (uint32_t)i : (uint32_t)(i * 2654435761u);
  }
};

const char* NAMES[4] = {"R", "G", "B", "A"};

// types[c]: HALF or FLOAT for R, G, B, A; n = 3 or 4 colour channels.
void add_slices(Imf::FrameBuffer& fb, Imf::ChannelList& ch, Planes& p,
                const Imf::PixelType* types, int n, int w, int x0, int y0) {
  for (int c = 0; c < n; c++) {
    ch.insert(NAMES[c], Imf::Channel(types[c]));
    const bool hf = types[c] == Imf::HALF;
    char* base = hf ? (char*)p.h[c].data() : (char*)p.f[c].data();
    const size_t xs = hf ? sizeof(half) : sizeof(float);
    fb.insert(NAMES[c],
              Imf::Slice(types[c], base - (x0 + (ptrdiff_t)y0 * w) * xs, xs,
                         xs * w));
  }
}

void write_scanline(const std::string& name, Imf::Compression comp,
                    const Imf::PixelType* types, int n, int w, int hgt,
                    int x0, int y0, Imf::LineOrder order, bool uint_z,
                    bool luminance, Planes& p) {
  Imf::Header hdr(w, hgt);
  hdr.dataWindow() = Imath::Box2i(Imath::V2i(x0, y0),
                                  Imath::V2i(x0 + w - 1, y0 + hgt - 1));
  hdr.displayWindow() = Imath::Box2i(Imath::V2i(0, 0), Imath::V2i(31, 31));
  hdr.compression() = comp;
  hdr.lineOrder() = order;
  Imf::FrameBuffer fb;
  if (luminance) {
    hdr.channels().insert("Y", Imf::Channel(Imf::HALF));
    fb.insert("Y", Imf::Slice(Imf::HALF, (char*)p.h[0].data(), sizeof(half),
                              sizeof(half) * w));
  } else {
    add_slices(fb, hdr.channels(), p, types, n, w, x0, y0);
  }
  if (uint_z) {
    hdr.channels().insert("Z", Imf::Channel(Imf::UINT));
    fb.insert("Z", Imf::Slice(Imf::UINT,
                              (char*)p.u.data() - (x0 + (ptrdiff_t)y0 * w) * 4,
                              4, 4 * (size_t)w));
  }
  Imf::OutputFile file((dir + "/" + name).c_str(), hdr);
  file.setFrameBuffer(fb);
  file.writePixels(hgt);
}

void scanline(const std::string& name, Imf::Compression comp,
              const Imf::PixelType* types, int n, int w = W, int hgt = H,
              int x0 = 0, int y0 = 0,
              Imf::LineOrder order = Imf::INCREASING_Y, bool uint_z = false,
              bool luminance = false) {
  Planes p(w, hgt, comp == Imf::PIZ_COMPRESSION);
  write_scanline(name, comp, types, n, w, hgt, x0, y0, order, uint_z,
                 luminance, p);
}

// A float32 .npy of the given shape.
void write_npy(const std::string& name, const std::vector<float>& data,
               const std::vector<int>& shape) {
  std::string dims;
  for (int d : shape) dims += std::to_string(d) + ", ";
  std::string header = "{'descr': '<f4', 'fortran_order': False, "
                       "'shape': (" + dims.substr(0, dims.size() - 2) +
                       "), }";
  while ((10 + header.size() + 1) % 64) header += ' ';
  header += '\n';
  FILE* f = fopen((dir + "/" + name).c_str(), "wb");
  fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  const uint16_t len = (uint16_t)header.size();
  fwrite(&len, 2, 1, f);
  fwrite(header.data(), 1, header.size(), f);
  fwrite(data.data(), 4, data.size(), f);
  fclose(f);
}

// The values of the first n channels of planes p (HALF or FLOAT as
// `types` says), H x W x n, as <stem>.npy beside <stem>.exr.
void write_values(const std::string& stem, const Planes& p,
                  const Imf::PixelType* types, int n, int w, int hgt) {
  std::vector<float> v;
  for (int y = 0; y < hgt; y++)
    for (int x = 0; x < w; x++)
      for (int c = 0; c < n; c++) {
        const size_t i = (size_t)y * w + x;
        v.push_back(types[c] == Imf::HALF ? (float)p.h[c][i] : p.f[c][i]);
      }
  write_npy(stem + ".npy", v, {hgt, w, n});
}

uint32_t mix(uint32_t x) {      // a 32-bit integer hash
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  return x ^ (x >> 16);
}

void piz_specials(const Imf::PixelType* hf, const Imf::PixelType* fl) {
  {  // two blocks, the second 13 lines, in an offset data window
    const int w = W, hgt = 45;
    Planes p(w, hgt, true);
    write_scanline("piz_half_rgba_window.exr", Imf::PIZ_COMPRESSION, hf, 4, w,
                   hgt, 5, -7, Imf::INCREASING_Y, false, false, p);
    write_values("piz_half_rgba_window", p, hf, 4, w, hgt);
  }
  {  // random finite HALF words in the first block: stored raw
    const int w = W, hgt = 64;
    Planes p(w, hgt, true);
    for (int c = 0; c < 3; c++)
      for (int i = 0; i < w * 32; i++) {
        uint16_t bits = (uint16_t)mix(i * 3 + c);
        if (((bits >> 10) & 0x1f) == 0x1f) bits &= 0xbfff;  // no inf / NaN
        p.h[c][i].setBits(bits);
      }
    write_scanline("piz_half_rgb_raw.exr", Imf::PIZ_COMPRESSION, hf, 3, w,
                   hgt, 0, 0, Imf::INCREASING_Y, false, false, p);
    write_values("piz_half_rgb_raw", p, hf, 3, w, hgt);
  }
  {  // FLOAT ramps with a bit of noise: 24,576 distinct low words
    const int w = 256, hgt = 32;
    Planes p(w, hgt);
    for (int c = 0; c < 3; c++)
      for (int i = 0; i < w * hgt; i++) {
        const uint32_t bits =
            0x3f800000u + 2u * (3u * i + c) + (mix(i * 3 + c) & 1);
        memcpy(&p.f[c][i], &bits, 4);
      }
    write_scanline("piz_float_rgb_wav16.exr", Imf::PIZ_COMPRESSION, fl, 3, w,
                   hgt, 0, 0, Imf::INCREASING_Y, false, false, p);
    write_values("piz_float_rgb_wav16", p, fl, 3, w, hgt);
  }
}

void tiled(const std::string& name) {
  Imf::Header hdr(8, 8);
  hdr.setTileDescription(Imf::TileDescription(4, 4, Imf::ONE_LEVEL));
  Planes p(8, 8);
  Imf::FrameBuffer fb;
  const Imf::PixelType t[3] = {Imf::HALF, Imf::HALF, Imf::HALF};
  add_slices(fb, hdr.channels(), p, t, 3, 8, 0, 0);
  Imf::TiledOutputFile file((dir + "/" + name).c_str(), hdr);
  file.setFrameBuffer(fb);
  file.writeTiles(0, file.numXTiles() - 1, 0, file.numYTiles() - 1);
}

void multipart(const std::string& name) {
  std::vector<Imf::Header> hdrs;
  Planes p(8, 8);
  const Imf::PixelType t[3] = {Imf::HALF, Imf::HALF, Imf::HALF};
  for (int i = 0; i < 2; i++) {
    Imf::Header hdr(8, 8);
    hdr.setName("part" + std::to_string(i));
    hdr.setType(Imf::SCANLINEIMAGE);
    Imf::FrameBuffer unused;
    add_slices(unused, hdr.channels(), p, t, 3, 8, 0, 0);
    hdrs.push_back(hdr);
  }
  Imf::MultiPartOutputFile file((dir + "/" + name).c_str(), hdrs.data(),
                                (int)hdrs.size());
  for (int i = 0; i < 2; i++) {
    Imf::OutputPart part(file, i);
    Imf::FrameBuffer fb;
    Imf::ChannelList unused;
    add_slices(fb, unused, p, t, 3, 8, 0, 0);
    part.setFrameBuffer(fb);
    part.writePixels(8);
  }
}

void deep(const std::string& name) {
  const int w = 8, hgt = 8;
  Imf::Header hdr(w, hgt);
  hdr.setType(Imf::DEEPSCANLINE);
  hdr.compression() = Imf::ZIPS_COMPRESSION;
  hdr.channels().insert("R", Imf::Channel(Imf::HALF));
  std::vector<unsigned int> counts((size_t)w * hgt, 1);
  std::vector<half> samples((size_t)w * hgt, half(0.5f));
  std::vector<half*> ptrs((size_t)w * hgt);
  for (size_t i = 0; i < ptrs.size(); i++) ptrs[i] = &samples[i];
  Imf::DeepFrameBuffer fb;
  fb.insertSampleCountSlice(Imf::Slice(Imf::UINT, (char*)counts.data(),
                                       sizeof(unsigned int),
                                       sizeof(unsigned int) * w));
  fb.insert("R", Imf::DeepSlice(Imf::HALF, (char*)ptrs.data(),
                                sizeof(half*), sizeof(half*) * w,
                                sizeof(half)));
  Imf::DeepScanLineOutputFile file((dir + "/" + name).c_str(), hdr);
  file.setFrameBuffer(fb);
  file.writePixels(hgt);
}

void write_expected(const std::string& name, bool piz) {
  std::vector<float> v;
  for (int k = 0; k < 2; k++)
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++)
        for (int c = 0; c < 4; c++) {
          const float f = piz ? master_piz(y, x, c) : master(y, x, c);
          v.push_back(k ? (float)half(f) : f);
        }
  write_npy(name, v, {2, H, W, 4});
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    fprintf(stderr, "usage: %s <output directory>\n", argv[0]);
    return 2;
  }
  dir = argv[1];
  const struct {
    const char* name;
    Imf::Compression comp;
  } codecs[] = {{"none", Imf::NO_COMPRESSION},
                {"rle", Imf::RLE_COMPRESSION},
                {"zips", Imf::ZIPS_COMPRESSION},
                {"zip", Imf::ZIP_COMPRESSION},
                {"piz", Imf::PIZ_COMPRESSION}};
  const Imf::PixelType hf[4] = {Imf::HALF, Imf::HALF, Imf::HALF, Imf::HALF};
  const Imf::PixelType fl[4] = {Imf::FLOAT, Imf::FLOAT, Imf::FLOAT,
                                Imf::FLOAT};
  for (const auto& c : codecs)
    for (int type = 0; type < 2; type++)
      for (int n = 3; n <= 4; n++)
        scanline(std::string(c.name) + (type ? "_float" : "_half") +
                     (n == 4 ? "_rgba" : "_rgb") + ".exr",
                 c.comp, type ? fl : hf, n);
  scanline("zip_half_rgba_window.exr", Imf::ZIP_COMPRESSION, hf, 4, W, H, 4,
           -3);
  scanline("zips_half_rgba_decreasing.exr", Imf::ZIPS_COMPRESSION, hf, 4, W,
           H, 0, 0, Imf::DECREASING_Y);
  const Imf::PixelType mixed[4] = {Imf::HALF, Imf::HALF, Imf::FLOAT,
                                   Imf::FLOAT};
  scanline("zip_mixed_rgbaz.exr", Imf::ZIP_COMPRESSION, mixed, 4, W, H, 0, 0,
           Imf::INCREASING_Y, true);
  for (int n = 3; n <= 4; n++)
    scanline(std::string("piz_mixed_") + (n == 4 ? "rgba" : "rgb") + ".exr",
             Imf::PIZ_COMPRESSION, mixed, n, W, H, 0, 0, Imf::INCREASING_Y,
             true);
  piz_specials(hf, fl);

  const struct {
    const char* name;
    Imf::Compression comp;
  } refused[] = {{"pxr24", Imf::PXR24_COMPRESSION},
                 {"b44", Imf::B44_COMPRESSION},
                 {"b44a", Imf::B44A_COMPRESSION},
                 {"dwaa", Imf::DWAA_COMPRESSION},
                 {"dwab", Imf::DWAB_COMPRESSION}};
  for (const auto& c : refused)
    scanline(std::string("unsupported_") + c.name + ".exr", c.comp, hf, 3, 8,
             8);
  tiled("unsupported_tiled.exr");
  multipart("unsupported_multipart.exr");
  deep("unsupported_deep.exr");
  scanline("unsupported_luminance.exr", Imf::ZIP_COMPRESSION, hf, 3, 8, 8, 0,
           0, Imf::INCREASING_Y, false, true);
  const Imf::PixelType ui[3] = {Imf::UINT, Imf::UINT, Imf::UINT};
  scanline("unsupported_uint.exr", Imf::ZIP_COMPRESSION, ui, 3, 8, 8);
  write_expected("expected.npy", false);
  write_expected("expected_piz.npy", true);
  return 0;
}
