// Host-side image decoding for the port's dataset loaders, with no library
// beyond libc, libstdc++ and pthread (the GPU machine has no libpng,
// libjpeg, OpenEXR, OpenCV or PIL). Counterpart of arnerf_tpu/native/dataio.cpp,
// which links libpng, libjpeg and OpenEXR.
//
//  * PNG: the scanline unfilter (filter types 0-4, PNG spec section 9) of a
//    zlib stream that Python's zlib has already inflated.
//  * JPEG: a baseline / extended sequential Huffman decoder (SOF0, SOF1,
//    8-bit): restart markers, 1 or 3 components, 4:4:4, 4:2:2 or 4:2:0,
//    libjpeg's integer "islow" IDCT (jidctint.c), its fancy (triangle)
//    upsampling (jdsample.c) and its YCbCr->RGB tables (jdcolor.c), so the
//    pixels are those libjpeg(-turbo) gives with its default settings, which
//    is what imageio (through PIL) returns.
//  * OpenEXR: single-part scanline files with HALF and FLOAT channels, raw,
//    RLE, or ZIP / ZIPS data that Python's zlib has inflated (exr_decode).
//  * dataio_decode_batch: a loop over many files on a pool of threads. It is
//    called through ctypes, which releases the GIL for the call.
//
// Build: arnerf_tpu_torch/build.py (host compiler, -O3 -shared -fPIC
// -pthread -std=c++17), at first use.

#include <algorithm>
#include <cmath>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- PNG ----

int png_unfilter(const uint8_t* in, int64_t in_len, uint8_t* out, int h,
                 int64_t rowbytes, int bpp) {
  if (h <= 0 || rowbytes <= 0 || bpp <= 0) return 1;
  if (in_len < (int64_t)h * (rowbytes + 1)) return 1;
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = in + (int64_t)y * (rowbytes + 1);
    const int ft = src[0];
    src++;
    uint8_t* cur = out + (int64_t)y * rowbytes;
    const uint8_t* prev = y ? cur - rowbytes : zero.data();
    switch (ft) {
      case 0:
        memcpy(cur, src, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(src[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + ((left + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev[i];
          const int c = i >= bpp ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return 2;  // unknown filter type
    }
  }
  return 0;
}

// --------------------------------------------------------------- JPEG ----

// status codes, mapped to messages by arnerf_tpu_torch/image_io.py
enum {
  JPEG_OK = 0,
  JPEG_CORRUPT = 1,      // truncated or malformed stream
  JPEG_PROGRESSIVE = 2,  // SOF2 and up: progressive, lossless, arithmetic
  JPEG_COMPONENTS = 3,   // not 1 or 3 components (CMYK, YCCK, 2)
  JPEG_SAMPLING = 4,     // sampling factors other than 4:4:4/4:2:2/4:2:0
  JPEG_NOT_JPEG = 5,
  JPEG_PRECISION = 6,    // not 8-bit samples
  JPEG_BUFFER = 7,       // output buffer of the wrong size
};

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in a corrupt stream (as libjpeg's table)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t lookup_len[512];   // 9-bit lookahead: code length, 0 = longer
  uint8_t lookup_val[512];
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];

  bool build(const uint8_t* counts, const uint8_t* v, int nvals) {
    if (nvals > 256) return false;
    memcpy(vals, v, nvals);
    int code = 0, k = 0;
    memset(lookup_len, 0, sizeof(lookup_len));
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; i++) {
        if (l <= 9) {
          const int shift = 9 - l;
          for (int j = 0; j < (1 << shift); j++) {
            const int idx = (code << shift) | j;
            if (idx >= 512) return false;
            lookup_len[idx] = (uint8_t)l;
            lookup_val[idx] = vals[k];
          }
        }
        code++;
        k++;
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return false;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool hit_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!hit_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          const uint32_t b2 = p + 1 < end ? p[1] : 0xD9;
          if (b2 == 0x00) {
            p += 2;
          } else {
            hit_marker = true;  // feed zeros, as libjpeg does
            b = 0;
          }
        } else {
          p++;
        }
      }
      buf |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int n) {
    if (bits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  void reset() {
    buf = 0;
    bits = 0;
  }
};

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

bool huff_decode(BitReader& br, const Huffman& h, int* out) {
  const uint32_t look = br.peek(9);
  const int len = h.lookup_len[look];
  if (len) {
    br.skip(len);
    *out = h.lookup_val[look];
    return true;
  }
  const uint32_t code16 = br.peek(16);
  for (int l = 10; l <= 16; l++) {
    const int32_t code = (int32_t)(code16 >> (16 - l));
    if (code <= h.maxcode[l]) {
      br.skip(l);
      const int idx = h.valptr[l] + code - h.mincode[l];
      if (idx < 0 || idx > 255) return false;
      *out = h.vals[idx];
      return true;
    }
  }
  return false;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;      // coefficient blocks per row / column (padded)
  int dw = 0, dh = 0;      // downsampled width / height in samples
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int pred = 0;
};

// libjpeg's jpeg_idct_islow (jidctint.c), 8-bit samples
const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
}

inline uint8_t range_limit(int32_t v) {  // v is centred on 0
  v += 128;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      const int32_t dc = (int32_t)ip[0] * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int32_t)ip[16] * qp[16];
    int64_t z3 = (int32_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int32_t)ip[0] * qp[0];
    z3 = (int32_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)ip[56] * qp[56];
    tmp1 = (int32_t)ip[40] * qp[40];
    tmp2 = (int32_t)ip[24] * qp[24];
    tmp3 = (int32_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, n);
    wp[56] = descale(tmp10 - tmp3, n);
    wp[8] = descale(tmp11 + tmp2, n);
    wp[48] = descale(tmp11 - tmp2, n);
    wp[16] = descale(tmp12 + tmp1, n);
    wp[40] = descale(tmp12 - tmp1, n);
    wp[24] = descale(tmp13 + tmp0, n);
    wp[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + (int64_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t dc = range_limit(descale(wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = range_limit(descale(tmp10 + tmp3, n));
    op[7] = range_limit(descale(tmp10 - tmp3, n));
    op[1] = range_limit(descale(tmp11 + tmp2, n));
    op[6] = range_limit(descale(tmp11 - tmp2, n));
    op[2] = range_limit(descale(tmp12 + tmp1, n));
    op[5] = range_limit(descale(tmp12 - tmp1, n));
    op[3] = range_limit(descale(tmp13 + tmp0, n));
    op[4] = range_limit(descale(tmp13 - tmp0, n));
  }
}

struct Jpeg {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool have_frame = false;
  Component comp[3];
  uint16_t qt[4][64];  // natural order
  Huffman dc[4], ac[4];

  int u16(int64_t at) const { return (data[at] << 8) | data[at + 1]; }

  // parse up to and including the frame header; returns a status
  int parse_header() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return JPEG_NOT_JPEG;
    pos = 2;
    while (true) {
      int m;
      int st = next_marker(&m);
      if (st) return st;
      if (m == 0xD9) return JPEG_CORRUPT;  // EOI before the frame
      if (pos + 2 > n) return JPEG_CORRUPT;
      const int len = u16(pos);
      if (len < 2 || pos + len > n) return JPEG_CORRUPT;
      st = segment(m, pos + 2, len - 2);
      if (st) return st;
      pos += len;
      if (have_frame) return JPEG_OK;
    }
  }

  int next_marker(int* m) {
    while (true) {
      while (pos < n && data[pos] != 0xFF) pos++;  // garbage before marker
      while (pos < n && data[pos] == 0xFF) pos++;  // fill bytes
      if (pos >= n) return JPEG_CORRUPT;
      *m = data[pos++];
      if (*m != 0x00) return JPEG_OK;              // 0xFF00: stuffed data
    }
  }

  int segment(int m, int64_t at, int len) {
    if (m == 0xC0 || m == 0xC1) return frame(at, len);
    if ((m >= 0xC2 && m <= 0xC3) || (m >= 0xC5 && m <= 0xC7) ||
        (m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) || m == 0xCC)
      return JPEG_PROGRESSIVE;
    if (m == 0xC4) return dht(at, len);
    if (m == 0xDB) return dqt(at, len);
    if (m == 0xDD) {
      if (len < 2) return JPEG_CORRUPT;
      restart_interval = u16(at);
      return JPEG_OK;
    }
    if (m == 0xE0 && len >= 5 && !memcmp(data + at, "JFIF\0", 5))
      saw_jfif = true;
    if (m == 0xEE && len >= 12 && !memcmp(data + at, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = data[at + 11];
    }
    return JPEG_OK;  // APPn, COM and the rest: skipped
  }

  int frame(int64_t at, int len) {
    if (len < 6) return JPEG_CORRUPT;
    if (data[at] != 8) return JPEG_PRECISION;
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = data[at + 5];
    if (ncomp != 1 && ncomp != 3) return JPEG_COMPONENTS;
    if (width <= 0 || height <= 0 || len < 6 + 3 * ncomp) return JPEG_CORRUPT;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = data[at + 6 + 3 * i];
      c.h = data[at + 7 + 3 * i] >> 4;
      c.v = data[at + 7 + 3 * i] & 15;
      c.tq = data[at + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return JPEG_CORRUPT;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) return JPEG_SAMPLING;
      const int rh = hmax / c.h, rv = vmax / c.v;
      if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
            (rh == 2 && rv == 2)))
        return JPEG_SAMPLING;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
    }
    have_frame = true;
    return JPEG_OK;
  }

  int dht(int64_t at, int len) {
    int64_t p = at, end = at + len;
    while (p < end) {
      if (p + 17 > end) return JPEG_CORRUPT;
      const int tc = data[p] >> 4, th = data[p] & 15;
      if (tc > 1 || th > 3) return JPEG_CORRUPT;
      int total = 0;
      for (int i = 0; i < 16; i++) total += data[p + 1 + i];
      if (p + 17 + total > end) return JPEG_CORRUPT;
      Huffman& h = tc ? ac[th] : dc[th];
      if (!h.build(data + p + 1, data + p + 17, total)) return JPEG_CORRUPT;
      p += 17 + total;
    }
    return JPEG_OK;
  }

  int dqt(int64_t at, int len) {
    int64_t p = at, end = at + len;
    while (p < end) {
      const int pq = data[p] >> 4, tq = data[p] & 15;
      if (tq > 3 || pq > 1) return JPEG_CORRUPT;
      if (p + 1 + 64 * (pq + 1) > end) return JPEG_CORRUPT;
      for (int k = 0; k < 64; k++)
        qt[tq][kZigzag[k]] =
            pq ? (uint16_t)u16(p + 1 + 2 * k) : data[p + 1 + k];
      p += 1 + 64 * (pq + 1);
    }
    return JPEG_OK;
  }

  bool decode_block(BitReader& br, Component& c, int16_t* blk) {
    int t;
    if (!huff_decode(br, dc[c.td], &t) || t > 11) return false;
    const int diff = t ? extend((int)br.get(t), t) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64;) {
      int rs;
      if (!huff_decode(br, ac[c.ta], &rs)) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return false;
        blk[kZigzag[k]] = (int16_t)extend((int)br.get(s), s);
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    return true;
  }

  // restart: drop buffered bits, consume the RSTn marker, reset predictors
  void restart(BitReader& br, Component** sc, int ns) {
    br.reset();
    const uint8_t* p = br.p;
    while (p + 1 < br.end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
      p++;
    if (p + 1 < br.end) p += 2;
    br.p = p;
    br.hit_marker = false;
    for (int i = 0; i < ns; i++) sc[i]->pred = 0;
  }

  int scan(int64_t at, int len) {
    if (!have_frame || len < 1) return JPEG_CORRUPT;
    const int ns = data[at];
    if (ns < 1 || ns > ncomp || len < 4 + 2 * ns) return JPEG_CORRUPT;
    Component* sc[3];
    for (int i = 0; i < ns; i++) {
      const int cid = data[at + 1 + 2 * i];
      Component* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == cid) c = &comp[j];
      if (!c) return JPEG_CORRUPT;
      c->td = data[at + 2 + 2 * i] >> 4;
      c->ta = data[at + 2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        return JPEG_CORRUPT;
      c->pred = 0;
      sc[i] = c;
    }
    BitReader br;
    br.p = data + at + len;
    br.end = data + n;
    int todo = restart_interval;
    if (ns == 1) {  // non-interleaved: one block per MCU
      Component& c = *sc[0];
      const int bx = (c.dw + 7) / 8, by = (c.dh + 7) / 8;
      for (int y = 0; y < by; y++)
        for (int x = 0; x < bx; x++) {
          if (restart_interval && !todo) {
            restart(br, sc, ns);
            todo = restart_interval;
          }
          int16_t* blk = &c.coef[((int64_t)y * c.bw + x) * 64];
          if (!decode_block(br, c, blk)) return JPEG_CORRUPT;
          todo--;
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && !todo) {
            restart(br, sc, ns);
            todo = restart_interval;
          }
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) {
                const int64_t bx = (int64_t)mx * c.h + h;
                const int64_t by = (int64_t)my * c.v + v;
                int16_t* blk = &c.coef[(by * c.bw + bx) * 64];
                if (!decode_block(br, c, blk)) return JPEG_CORRUPT;
              }
          }
          todo--;
        }
    }
    pos = br.p - data;  // the next marker parse resynchronises from here
    return JPEG_OK;
  }

  int decode(uint8_t* out, int64_t out_len) {
    int st = parse_header();
    if (st) return st;
    const int oc = ncomp == 1 ? 1 : 3;
    if (out_len != (int64_t)width * height * oc) return JPEG_BUFFER;
    for (int i = 0; i < ncomp; i++)
      comp[i].coef.assign((int64_t)comp[i].bw * comp[i].bh * 64, 0);
    bool scanned = false;
    while (true) {
      int m;
      if (next_marker(&m)) {
        if (scanned) break;  // missing EOI after data: decode what we have
        return JPEG_CORRUPT;
      }
      if (m == 0xD9) break;
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
      if (pos + 2 > n) return JPEG_CORRUPT;
      const int len = u16(pos);
      if (len < 2 || pos + len > n) return JPEG_CORRUPT;
      if (m == 0xDA) {
        st = scan(pos + 2, len - 2);
        if (st) return st;
        scanned = true;
        continue;
      }
      st = segment(m, pos + 2, len - 2);
      if (st) return st;
      pos += len;
    }
    if (!scanned) return JPEG_CORRUPT;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      const int stride = c.bw * 8;
      c.plane.assign((int64_t)stride * c.bh * 8, 0);
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(&c.coef[((int64_t)by * c.bw + bx) * 64], q,
                     &c.plane[(int64_t)by * 8 * stride + bx * 8], stride);
      c.coef.clear();
      c.coef.shrink_to_fit();
    }
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < height; y++)
        memcpy(out + (int64_t)y * width, &c.plane[(int64_t)y * c.bw * 8],
               width);
      return JPEG_OK;
    }
    bool rgb = false;
    if (saw_jfif)
      rgb = false;
    else if (saw_adobe)
      rgb = adobe_transform == 0;
    else
      rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    color_convert(out, rgb);
    return JPEG_OK;
  }

  // one output row of component c at full size (jdsample.c)
  void upsample_row(const Component& c, int y, uint8_t* row) const {
    const int stride = c.bw * 8;
    const int rh = hmax / c.h, rv = vmax / c.v;
    if (rh == 1) {
      memcpy(row, &c.plane[(int64_t)y * stride], width);
      return;
    }
    const bool fancy = c.dw > 2;
    if (rv == 1) {  // h2v1
      const uint8_t* in = &c.plane[(int64_t)y * stride];
      std::vector<uint8_t> tmp(2 * (size_t)c.dw);
      uint8_t* o = tmp.data();
      if (!fancy) {
        for (int x = 0; x < c.dw; x++) o[2 * x] = o[2 * x + 1] = in[x];
      } else {
        int inv = in[0];
        *o++ = (uint8_t)inv;
        *o++ = (uint8_t)((inv * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          inv = in[x] * 3;
          *o++ = (uint8_t)((inv + in[x - 1] + 1) >> 2);
          *o++ = (uint8_t)((inv + in[x + 1] + 2) >> 2);
        }
        inv = in[c.dw - 1];
        *o++ = (uint8_t)((inv * 3 + in[c.dw - 2] + 1) >> 2);
        *o++ = (uint8_t)inv;
      }
      memcpy(row, tmp.data(), width);
      return;
    }
    // h2v2
    const int inrow = y >> 1;
    const uint8_t* in0 = &c.plane[(int64_t)inrow * stride];
    std::vector<uint8_t> tmp(2 * (size_t)c.dw);
    uint8_t* o = tmp.data();
    if (!fancy) {
      for (int x = 0; x < c.dw; x++) o[2 * x] = o[2 * x + 1] = in0[x];
      memcpy(row, tmp.data(), width);
      return;
    }
    int nb = (y & 1) ? inrow + 1 : inrow - 1;  // next-nearest input row
    nb = std::min(std::max(nb, 0), c.dh - 1);
    const uint8_t* in1 = &c.plane[(int64_t)nb * stride];
    int thiscol = in0[0] * 3 + in1[0];
    int nextcol = in0[1] * 3 + in1[1];
    *o++ = (uint8_t)((thiscol * 4 + 8) >> 4);
    *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 2; x < c.dw; x++) {
      nextcol = in0[x] * 3 + in1[x];
      *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
    *o++ = (uint8_t)((thiscol * 4 + 7) >> 4);
    memcpy(row, tmp.data(), width);
  }

  void color_convert(uint8_t* out, bool rgb) const {
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    const int32_t ONE_HALF = 1 << 15;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      const int32_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    std::vector<uint8_t> r0(width), r1(width), r2(width);
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < height; y++) {
      upsample_row(comp[0], y, r0.data());
      upsample_row(comp[1], y, r1.data());
      upsample_row(comp[2], y, r2.data());
      uint8_t* o = out + (int64_t)y * width * 3;
      if (rgb) {
        for (int x = 0; x < width; x++) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; x++) {
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};


// ------------------------------------------------------------- OpenEXR ----
//
// One single-part scanline OpenEXR image whose header and offset table
// image_io.py has parsed and whose ZIP / ZIPS chunks it has inflated. The
// input is a descriptor of little-endian int64 values, then the payloads:
//   w, h, nc, out_c, lines_per_block, n_chunks,
//   type[nc]  (0 UINT, 1 HALF, 2 FLOAT; the file's channel order),
//   dst[nc]   (output channel of each, -1 to skip it),
//   n_chunks x (first row, codec, payload offset, payload length),
// codec 0: raw pixel data; 1: RLE; 2: inflated ZIP data, still predicted
// and interleaved; 3: PIZ (piz_decode). A chunk's rows hold each channel's w values in turn
// (OpenEXR file layout, section "Scan Line Data"). RLE and ZIP data are
// split into even and odd bytes and delta-coded (OpenEXR's
// ImfRleCompressor.cpp and ImfZip.cpp); this undoes both.

enum {
  EXR_OK = 0,
  EXR_CORRUPT = 10,     // a chunk's data does not fill its rows exactly
  EXR_DESCRIPTOR = 11,  // inconsistent descriptor or output size
  EXR_PIZ = 12,         // a PIZ chunk that does not decode
};

float half_to_float(uint16_t v) {
  const uint32_t s = (uint32_t)(v >> 15) << 31, e = (v >> 10) & 0x1f,
                 m = v & 0x3ff;
  uint32_t bits;
  if (e == 0) {
    const float x = std::ldexp((float)m, -24);   // zero and subnormals
    return s ? -x : x;
  }
  if (e == 31)
    bits = s | 0x7f800000u | (m << 13);           // inf and NaN
  else
    bits = s | ((e + 112) << 23) | (m << 13);
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

// OpenEXR's rleUncompress: a negative count byte -n copies n literal
// bytes, a count n >= 0 repeats the next byte n + 1 times. Returns the
// bytes written, or -1 if the stream overruns `cap` or the input.
int64_t rle_uncompress(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t cap) {
  int64_t o = 0, i = 0;
  while (i < n) {
    const int count = (int8_t)in[i++];
    if (count < 0) {
      if (i - count > n || o - count > cap) return -1;
      memcpy(out + o, in + i, -count);
      i -= count;
      o -= count;
    } else {
      if (i >= n || o + count + 1 > cap) return -1;
      memset(out + o, in[i++], count + 1);
      o += count + 1;
    }
  }
  return o;
}

// Undo the delta predictor, then the split into even and odd bytes.
void exr_unpredict(uint8_t* tmp, int64_t n, uint8_t* out) {
  for (int64_t i = 1; i < n; i++)
    tmp[i] = (uint8_t)(tmp[i - 1] + tmp[i] - 128);
  const uint8_t* t1 = tmp;
  const uint8_t* t2 = tmp + (n + 1) / 2;
  for (int64_t i = 0; i < n; i++) out[i] = (i & 1) ? *t2++ : *t1++;
}

// ---------------------------------------------------------------- PIZ ----
//
// OpenEXR's PIZ codec (the file format's description of ImfPizCompressor,
// ImfHuf and ImfWav). A chunk of up to 32 scanlines holds:
//   minNonZero, maxNonZero (u16 each) and the bitmap bytes between them:
//     the set of 16-bit words the chunk uses (word 0 always counts);
//   a length (i32) and that many bytes of Huffman-coded words.
// The decoded words are channel-major: each channel's rows in turn, a
// HALF value one word, a FLOAT or UINT value two (its little-endian low
// word first). Every word position of a channel's values is its own
// 2D wavelet plane; after the wavelet the words are indices into the
// bitmap's sorted list of words. The scanline layout is then each row's
// channels in turn, as the uncompressed chunk holds them.

constexpr int HUF_ENCSIZE = (1 << 16) + 1;
constexpr int HUF_FASTBITS = 14;

// MSB-first reader over a bit stream of n_bits bits.
struct HufBits {
  const uint8_t* p;
  int64_t n_bits;
  int64_t pos = 0;
  // The next k <= 58 bits (zeros past the end), not consumed.
  uint64_t peek(int k) const {
    unsigned __int128 v = 0;     // up to 7 + 58 bits
    const int64_t byte = pos >> 3;
    const int skip = (int)(pos & 7);
    const int64_t n_bytes = (n_bits + 7) >> 3;
    const int need = (skip + k + 7) >> 3;
    for (int i = 0; i < need; i++)
      v = (v << 8) | (byte + i < n_bytes ? p[byte + i] : 0);
    return (uint64_t)(v >> (need * 8 - skip - k)) & ((1ull << k) - 1);
  }
};

// hufUncompress: `in` of n bytes -> exactly n_raw words. Returns false on
// any inconsistency.
bool huf_decode(const uint8_t* in, int64_t n, uint16_t* out, int64_t n_raw) {
  if (n == 0) return n_raw == 0;
  if (n < 20) return false;
  auto u32 = [&](int i) {
    return (uint32_t)in[i] | ((uint32_t)in[i + 1] << 8) |
           ((uint32_t)in[i + 2] << 16) | ((uint32_t)in[i + 3] << 24);
  };
  const uint32_t im = u32(0), iM = u32(4), n_bits = u32(12);
  if (im >= (uint32_t)HUF_ENCSIZE || iM >= (uint32_t)HUF_ENCSIZE || im > iM)
    return false;
  // The code lengths of symbols im..iM, 6 bits each, with zero runs:
  // 59..62 stand for 2..5 zeros, 63 then 8 bits for 6..261 zeros.
  std::vector<uint8_t> len(HUF_ENCSIZE, 0);
  HufBits table{in + 20, 8 * (n - 20)};
  for (uint32_t s = im; s <= iM; s++) {
    if (table.pos + 6 > table.n_bits) return false;
    const int l = (int)table.peek(6);
    table.pos += 6;
    if (l < 59) {
      len[s] = (uint8_t)l;
      continue;
    }
    int64_t run = l - 59 + 2;
    if (l == 63) {
      if (table.pos + 8 > table.n_bits) return false;
      run = (int64_t)table.peek(8) + 6;
      table.pos += 8;
    }
    if (s + run > iM + 1) return false;
    s += (uint32_t)run - 1;     // the lengths are already zero
  }
  const int64_t data_off = 20 + ((table.pos + 7) >> 3);
  if (data_off + ((int64_t)n_bits + 7) / 8 > n) return false;
  // Canonical codes, assigned from the longest length down: the codes of
  // length l are first[l], first[l] + 1, ... in increasing symbol order.
  int64_t count[59] = {0}, first[59] = {0};
  for (int s = 0; s < HUF_ENCSIZE; s++) count[len[s]]++;
  int64_t c = 0;
  for (int l = 58; l > 0; l--) {
    first[l] = c;
    c = (c + count[l]) >> 1;
  }
  std::vector<std::vector<uint32_t>> by_len(59);
  for (int s = 0; s < HUF_ENCSIZE; s++)
    if (len[s]) by_len[len[s]].push_back((uint32_t)s);
  // Codes of up to HUF_FASTBITS bits from one table lookup, the longer
  // ones (up to 58 bits) by their lengths' ranges.
  std::vector<uint32_t> fast(1 << HUF_FASTBITS, 0);   // sym << 6 | len
  for (int l = 1; l <= HUF_FASTBITS; l++)
    for (size_t r = 0; r < by_len[l].size(); r++) {
      const uint64_t code = (uint64_t)first[l] + r;
      if (code >> l) return false;               // over-full code
      const uint64_t lo = code << (HUF_FASTBITS - l);
      const uint64_t hi = (code + 1) << (HUF_FASTBITS - l);
      for (uint64_t i = lo; i < hi; i++) fast[i] = (by_len[l][r] << 6) | l;
    }
  HufBits bits{in + data_off, (int64_t)n_bits};
  int64_t o = 0;
  while (bits.pos < bits.n_bits) {
    const uint32_t e = fast[bits.peek(HUF_FASTBITS)];
    int l = (int)(e & 63);
    uint32_t sym = e >> 6;
    if (!l) {
      for (l = HUF_FASTBITS + 1; l <= 58; l++) {
        const uint64_t code = bits.peek(l);
        if (code >= (uint64_t)first[l] &&
            code - first[l] < by_len[l].size()) {
          sym = by_len[l][code - first[l]];
          break;
        }
      }
      if (l > 58) return false;
    }
    if (bits.pos + l > bits.n_bits) return false;
    bits.pos += l;
    if (sym == iM) {           // run: 8 more bits repeat the last word
      if (bits.pos + 8 > bits.n_bits || o == 0) return false;
      const int64_t run = (int64_t)bits.peek(8);
      bits.pos += 8;
      if (o + run > n_raw) return false;
      for (int64_t i = 0; i < run; i++, o++) out[o] = out[o - 1];
    } else {
      if (o >= n_raw) return false;
      out[o++] = (uint16_t)sym;
    }
  }
  return o == n_raw;
}

inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  const int16_t ls = (int16_t)l, hs = (int16_t)h;
  const int hi = hs;
  const int ai = ls + (hi & 1) + (hi >> 1);
  a = (uint16_t)(int16_t)ai;
  b = (uint16_t)(int16_t)(ai - hi);
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  const int m = l, d = h;
  const int bb = (m - (d >> 1)) & 0xffff;
  const int aa = (d + bb - 0x8000) & 0xffff;
  b = (uint16_t)bb;
  a = (uint16_t)aa;
}

// wav2Decode: undo the 2D Haar-like wavelet of an nx x ny plane whose
// elements sit ox words apart in x and oy words apart in y; the 14-bit
// lifting when every word is below 2^14 (mx), else the 16-bit modular one.
void wav2_decode(uint16_t* in, int64_t nx, int64_t ox, int64_t ny, int64_t oy,
                 uint16_t mx) {
  const bool w14 = mx < (1 << 14);
  auto dec = [w14](uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
    if (w14)
      wdec14(l, h, a, b);
    else
      wdec16(l, h, a, b);
  };
  const int64_t n = std::min(nx, ny);
  int64_t p = 1;
  while (p <= n) p <<= 1;
  p >>= 1;
  int64_t p2 = p;
  p >>= 1;
  while (p >= 1) {
    const int64_t oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    const int64_t ey = oy * (ny - p2);
    int64_t py = 0;
    uint16_t i00, i01, i10, i11;
    for (; py <= ey; py += oy2) {
      int64_t px = py;
      const int64_t ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* a = in + px;
        uint16_t* b = in + px + ox1;
        uint16_t* c = in + px + oy1;
        uint16_t* d = in + px + oy1 + ox1;
        dec(*a, *c, i00, i10);
        dec(*b, *d, i01, i11);
        dec(i00, i01, *a, *b);
        dec(i10, i11, *c, *d);
      }
      if (nx & p) {            // the odd column
        uint16_t* c = in + px + oy1;
        dec(in[px], *c, i00, *c);
        in[px] = i00;
      }
    }
    if (ny & p) {              // the odd row
      int64_t px = py;
      const int64_t ex = py + ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* b = in + px + ox1;
        dec(in[px], *b, i00, *b);
        in[px] = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// One PIZ chunk of `rows` scanlines of w pixels -> its uncompressed
// scanline bytes (`out`, rows * row_bytes). words[c]: 1 for HALF, 2 for
// FLOAT and UINT.
bool piz_decode(const uint8_t* in, int64_t n, const int64_t* types,
                int64_t nc, int64_t w, int64_t rows, uint8_t* out) {
  int64_t total = 0;
  for (int64_t c = 0; c < nc; c++) total += w * rows * (types[c] == 1 ? 1 : 2);
  if (n < 4) return false;
  const int min_nz = in[0] | (in[1] << 8), max_nz = in[2] | (in[3] << 8);
  if (max_nz >= 8192) return false;
  uint8_t bitmap[8192] = {0};
  int64_t pos = 4;
  if (min_nz <= max_nz) {
    if (pos + max_nz - min_nz + 1 > n) return false;
    memcpy(bitmap + min_nz, in + pos, max_nz - min_nz + 1);
    pos += max_nz - min_nz + 1;
  }
  // The reverse LUT: 0, then every word whose bit is set, in order.
  std::vector<uint16_t> lut(1 << 16, 0);
  int k = 0;
  for (int i = 0; i < (1 << 16); i++)
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) lut[k++] = (uint16_t)i;
  const uint16_t max_value = (uint16_t)(k - 1);
  if (pos + 4 > n) return false;
  int32_t length;
  memcpy(&length, in + pos, 4);
  pos += 4;
  if (length < 0 || pos + length > n) return false;
  std::vector<uint16_t> buf(total);
  if (!huf_decode(in + pos, length, buf.data(), total)) return false;
  int64_t start = 0;
  std::vector<int64_t> starts(nc);
  for (int64_t c = 0; c < nc; c++) {
    const int64_t size = types[c] == 1 ? 1 : 2;
    starts[c] = start;
    for (int64_t j = 0; j < size; j++)
      wav2_decode(buf.data() + start + j, w, size, rows, w * size, max_value);
    start += w * rows * size;
  }
  for (auto& v : buf) v = lut[v];
  uint8_t* o = out;
  for (int64_t r = 0; r < rows; r++)
    for (int64_t c = 0; c < nc; c++) {
      const int64_t words = w * (types[c] == 1 ? 1 : 2);
      const uint16_t* src = buf.data() + starts[c] + r * words;
      for (int64_t i = 0; i < words; i++) {
        *o++ = (uint8_t)(src[i] & 0xff);
        *o++ = (uint8_t)(src[i] >> 8);
      }
    }
  return true;
}

int exr_decode(const uint8_t* data, int64_t n, float* out, int64_t out_len) {
  const int64_t* d = (const int64_t*)data;
  if (n < 6 * 8) return EXR_DESCRIPTOR;
  const int64_t w = d[0], h = d[1], nc = d[2], out_c = d[3], lpb = d[4],
                n_chunks = d[5];
  if (w <= 0 || h <= 0 || nc <= 0 || nc > 1024 || lpb <= 0 ||
      n_chunks < 0 || n < (6 + 2 * nc + 4 * n_chunks) * 8 ||
      out_len != w * h * out_c * 4)
    return EXR_DESCRIPTOR;
  const int64_t* types = d + 6;
  const int64_t* dst = types + nc;
  const int64_t* chunks = dst + nc;
  int64_t row_bytes = 0;
  for (int64_t c = 0; c < nc; c++) {
    if (types[c] < 0 || types[c] > 2 || dst[c] >= out_c) return EXR_DESCRIPTOR;
    row_bytes += w * (types[c] == 1 ? 2 : 4);
  }
  std::vector<uint8_t> tmp, raw;
  for (int64_t k = 0; k < n_chunks; k++) {
    const int64_t row0 = chunks[4 * k], codec = chunks[4 * k + 1],
                  off = chunks[4 * k + 2], len = chunks[4 * k + 3];
    if (row0 < 0 || row0 >= h || off < 0 || len < 0 || off + len > n)
      return EXR_DESCRIPTOR;
    const int64_t rows = std::min(lpb, h - row0);
    const int64_t size = rows * row_bytes;
    const uint8_t* src = data + off;
    if (codec == 0 || codec == 2) {
      if (len != size) return EXR_CORRUPT;
    } else if (codec != 1 && codec != 3) {
      return EXR_DESCRIPTOR;
    }
    if (codec == 3) {
      raw.resize(size);
      if (!piz_decode(src, len, types, nc, w, rows, raw.data()))
        return EXR_PIZ;
      src = raw.data();
    } else if (codec != 0) {
      tmp.resize(size);
      raw.resize(size);
      if (codec == 1) {
        if (rle_uncompress(src, len, tmp.data(), size) != size)
          return EXR_CORRUPT;
      } else {
        memcpy(tmp.data(), src, size);
      }
      exr_unpredict(tmp.data(), size, raw.data());
      src = raw.data();
    }
    for (int64_t r = 0; r < rows; r++) {
      float* o = out + (row0 + r) * w * out_c;
      for (int64_t c = 0; c < nc; c++) {
        const int64_t sz = types[c] == 1 ? 2 : 4;
        if (dst[c] >= 0) {
          for (int64_t x = 0; x < w; x++) {
            float v;
            if (sz == 2) {
              uint16_t hv;
              memcpy(&hv, src + 2 * x, 2);
              v = half_to_float(hv);
            } else {
              memcpy(&v, src + 4 * x, 4);
            }
            o[x * out_c + dst[c]] = v;
          }
        }
        src += w * sz;
      }
    }
  }
  return EXR_OK;
}

}  // namespace

extern "C" {

// Unfilter an inflated PNG stream of h rows of (1 + rowbytes) bytes;
// bpp is the filter's byte distance (bytes per complete pixel, at least 1).
// 0 on success, 1 short input, 2 unknown filter type.
int dataio_png_unfilter(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int h, int64_t rowbytes, int bpp) {
  return png_unfilter(in, in_len, out, h, rowbytes, bpp);
}

// Frame header of a JPEG stream: width, height and component count.
int dataio_jpeg_header(const uint8_t* data, int64_t n, int* w, int* h,
                       int* comps) {
  Jpeg j;
  j.data = data;
  j.n = n;
  const int st = j.parse_header();
  if (st) return st;
  *w = j.width;
  *h = j.height;
  *comps = j.ncomp;
  return 0;
}

// Decode a JPEG stream into out: (h, w) gray or (h, w, 3) RGB uint8.
int dataio_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
                       int64_t out_len) {
  Jpeg j;
  j.data = data;
  j.n = n;
  return j.decode(out, out_len);
}

// Decode n items on n_threads threads (0: the hardware's count). kinds[i]:
// 0 = PNG unfilter (params[3i..3i+2] = h, rowbytes, bpp), 1 = JPEG, 2 =
// OpenEXR (exr_decode's input; out_lens[i] in bytes). The
// status of each item goes to status[i]; returns the number that failed.
int dataio_decode_batch(int n, const int* kinds, const uint8_t* const* ins,
                        const int64_t* in_lens, uint8_t* const* outs,
                        const int64_t* out_lens, const int64_t* params,
                        int* status, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next(0), failed(0);
  auto work = [&]() {
    for (int i = next++; i < n; i = next++) {
      int st;
      if (kinds[i] == 0)
        st = png_unfilter(ins[i], in_lens[i], outs[i], (int)params[3 * i],
                          params[3 * i + 1], (int)params[3 * i + 2]);
      else if (kinds[i] == 1)
        st = dataio_jpeg_decode(ins[i], in_lens[i], outs[i], out_lens[i]);
      else
        st = exr_decode(ins[i], in_lens[i], (float*)outs[i], out_lens[i]);
      status[i] = st;
      if (st) failed++;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; t++) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return failed.load();
}

}  // extern "C"
