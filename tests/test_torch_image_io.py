"""The port's image readers (arnerf_tpu_torch/image_io.py, native decoder
csrc/dataio.cpp built at first use) against imageio, which is what the JAX
package's loaders read with.

PNGs: every colour type and depth the readers take must give exactly
`imageio.v2.imread`'s array (dtype, shape and values). Files that imageio
can write (8-bit gray, RGB, RGBA, gray+alpha, 16-bit gray) are written by
it, palettes at 1-8 bits by PIL; the rest (1/2/4-bit gray, 16-bit RGB, RGBA
and gray+alpha, tRNS chunks) by a raw numpy writer here, since imageio
cannot write them. The port's own writer covers filter types 0-4.

JPEGs: PIL's baseline files at 4:4:4, 4:2:2, 4:2:0 and gray, quality 75
and 95, with and without restart markers, must agree with imageio within
1/255 (one uint8 step). Measured: 0, bit-exact against the libjpeg-turbo
that PIL links (islow IDCT, fancy upsampling, libjpeg's colour tables).
"""

import struct
import zlib

import numpy as np
import pytest
import imageio.v2 as imageio
from PIL import Image

from arnerf_tpu_torch import build, image_io
from arnerf_tpu_torch.datasets.color_utils import resize_linear


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data \
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def raw_png(path, samples, ctype, depth, plte=None, trns=None, interlace=0):
    """A PNG of (H, W, C) integer samples (palette indices for colour type
    3) at `depth` bits, filter type 0, written without an image library."""
    h, w, c = samples.shape
    if depth < 8:
        per = 8 // depth
        pad = np.zeros((h, (-w) % per), np.uint8)
        v = np.concatenate([samples[..., 0].astype(np.uint8), pad], 1)
        v = v.reshape(h, -1, per)
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        raw = np.bitwise_or.reduce(v << shifts, axis=2).astype(np.uint8)
    elif depth == 8:
        raw = samples.astype(np.uint8).reshape(h, w * c)
    else:
        raw = samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    body = b"".join(b"\0" + raw[y].tobytes() for y in range(h))
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


def _same(path):
    ref = imageio.imread(path)
    got = image_io.read_png(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape, \
        (got.dtype, got.shape, ref.dtype, ref.shape)
    np.testing.assert_array_equal(got, ref)


H, W = 13, 21    # odd sizes: partial bytes at low depths, ragged rows


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "rgba8", "la8",
                                  "gray16"])
def test_png_written_by_imageio(tmp_path, kind):
    rng = np.random.default_rng(0)
    shape = {"gray8": (H, W), "rgb8": (H, W, 3), "rgba8": (H, W, 4),
             "la8": (H, W, 2), "gray16": (H, W)}[kind]
    top = 65536 if kind == "gray16" else 256
    img = rng.integers(0, top, shape).astype(
        np.uint16 if kind == "gray16" else np.uint8)
    path = str(tmp_path / f"{kind}.png")
    imageio.imsave(path, img)
    _same(path)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_png_written_by_pil(tmp_path, bits):
    rng = np.random.default_rng(bits)
    n = min(2 ** bits, 16)
    im = Image.fromarray(rng.integers(0, n, (H, W)).astype(np.uint8), "P")
    im.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tolist())
    path = str(tmp_path / f"p{bits}.png")
    im.save(path, bits=bits)
    _same(path)


@pytest.mark.parametrize("ctype,depth,trns", [
    (0, 1, None), (0, 2, None), (0, 4, None), (0, 2, b"\0\1"),
    (0, 8, b"\0\7"), (0, 16, b"\1\2"),
    (2, 16, None), (2, 8, b"\0\1\0\2\0\3"),
    (6, 16, None), (4, 16, None),
    (3, 1, b"\0\x80"), (3, 2, None), (3, 4, b"\xff\0\x10"),
    (3, 8, b"\x40")],
    ids=lambda v: v.hex() if isinstance(v, bytes) else str(v))
def test_png_every_type_and_depth(tmp_path, ctype, depth, trns):
    rng = np.random.default_rng(ctype * 100 + depth)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = min(2 ** depth, 16) if ctype == 3 else 2 ** depth
    samples = rng.integers(0, top, (H, W, c))
    plte = rng.integers(0, 256, (16, 3)) if ctype == 3 else None
    path = str(tmp_path / f"t{ctype}_{depth}.png")
    raw_png(path, samples, ctype, depth, plte, trns)
    _same(path)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_filter_types(tmp_path, channels):
    """The port's writer, each filter type alone and all five in rotation;
    smooth and noisy rows, so Sub/Up/Average/Paeth see real predictions."""
    rng = np.random.default_rng(channels)
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[10:25] = (np.arange(53) * 4 % 256).astype(np.uint8)[:, None] \
        if channels > 1 else (np.arange(53) * 4 % 256).astype(np.uint8)
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)):
        path = str(tmp_path / f"f{len(filters)}{filters[0]}.png")
        image_io.write_png(path, img, filter_types=filters)
        with open(path, "rb") as f:
            stream = zlib.decompress(f.read()[41:-16])   # the IDAT
        row = 53 * channels + 1
        used = {stream[y * row] for y in range(37)}
        assert used == set(filters)
        np.testing.assert_array_equal(imageio.imread(path), img)
        _same(path)


def _jpeg(path, mode, q, sub=None, h=61, w=83, seed=0, **kw):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, w)[None, :, None] \
        * np.linspace(0, 1, h)[:, None, None]
    img = (rng.random((h, w, 3)) * 60 + 190 * ramp).astype(np.uint8)
    if sub is not None:
        kw["subsampling"] = sub
    Image.fromarray(img).convert(mode).save(path, quality=q, **kw)


@pytest.mark.parametrize("mode,sub", [("RGB", 0), ("RGB", 1), ("RGB", 2),
                                      ("L", None)],
                         ids=["444", "422", "420", "gray"])
@pytest.mark.parametrize("q", [75, 95])
def test_baseline_jpeg_matches_imageio(tmp_path, mode, sub, q):
    worst = 0
    for h, w in ((61, 83), (8, 8), (17, 3), (3, 2), (240, 320)):
        path = str(tmp_path / f"{h}x{w}.jpg")
        _jpeg(path, mode, q, sub, h, w)
        ref, got = imageio.imread(path), image_io.read_jpeg(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        worst = max(worst, int(np.abs(got.astype(int) - ref).max()))
    assert worst <= 1, worst


def test_jpeg_restart_markers(tmp_path):
    for kw in (dict(restart_marker_blocks=3), dict(restart_marker_rows=1)):
        path = str(tmp_path / "rst.jpg")
        _jpeg(path, "RGB", 90, 2, 123, 77, **kw)
        with open(path, "rb") as f:
            data = f.read()
        assert any(bytes([0xFF, 0xD0 + i]) in data for i in range(8))
        ref, got = imageio.imread(path), image_io.read_jpeg(path)
        assert int(np.abs(got.astype(int) - ref).max()) <= 1


def test_unsupported_files_raise_naming_the_file(tmp_path):
    rng = np.random.default_rng(0)
    png = str(tmp_path / "adam7.png")
    raw_png(png, rng.integers(0, 256, (8, 8, 3)), 2, 8, interlace=1)
    with pytest.raises(ValueError, match="adam7.png.*interlaced"):
        image_io.read_png(png)
    prog = str(tmp_path / "prog.jpg")
    _jpeg(prog, "RGB", 90, progressive=True)
    with pytest.raises(ValueError, match="prog.jpg.*progressive"):
        image_io.read_jpeg(prog)
    cmyk = str(tmp_path / "cmyk.jpg")
    _jpeg(cmyk, "CMYK", 90)
    with pytest.raises(ValueError, match="cmyk.jpg.*CMYK"):
        image_io.read_jpeg(cmyk)
    arith = str(tmp_path / "arith.jpg")   # SOF9: arithmetic-coded frame
    with open(arith, "wb") as f:
        f.write(b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x08\x00\x08\x01\x01\x11"
                b"\x00\xff\xd9")
    with pytest.raises(ValueError, match="arith.jpg.*arithmetic"):
        image_io.read_jpeg(arith)
    other = str(tmp_path / "x.bmp")
    with open(other, "wb") as f:
        f.write(b"BM" + bytes(64))
    with pytest.raises(ValueError, match="x.bmp.*neither"):
        image_io.imread(other)


def test_image_size_from_the_header(tmp_path):
    paths = []
    for i, (h, w) in enumerate(((13, 21), (40, 7))):
        p = str(tmp_path / f"s{i}.png")
        image_io.write_png(p, np.zeros((h, w, 3), np.uint8))
        paths.append(p)
        p = str(tmp_path / f"s{i}.jpg")
        _jpeg(p, "RGB", 80, 2, h, w)
        paths.append(p)
    for p in paths:
        assert image_io.image_size(p) == Image.open(p).size


def test_imread_many_matches_one_by_one(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(9):
        p = str(tmp_path / f"m{i}.{'jpg' if i % 3 == 0 else 'png'}")
        if i % 3 == 0:
            _jpeg(p, "RGB", 85, 2, seed=i)
        else:
            image_io.write_png(p, rng.integers(0, 256, (19, 23, 4)),
                               filter_types=(i % 5,))
        paths.append(p)
    many = image_io.imread_many(paths)
    for p, got in zip(paths, many):
        np.testing.assert_array_equal(got, imageio.imread(p))


def test_resize_is_opencvs_linear_algorithm():
    """resize_linear computes OpenCV's INTER_LINEAR (resize.cpp: half-pixel
    centres, clamped edges, float32 weights, horizontal then vertical pass).
    With cv2's optimisations off it agrees to float rounding everywhere.
    With them on, an IPP build of cv2 takes Intel IPP's resize at factors
    that are not powers of two, which departs from OpenCV's own algorithm
    by up to 6e-5 at 800x800; at powers of two the two agree to rounding."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    was = cv2.useOptimized()
    try:
        cv2.setUseOptimized(False)
        for h, w in ((800, 800), (37, 53), (5, 3)):
            img = rng.random((h, w, 3)).astype(np.float32)
            for wh in ((310, 206), (w // 2, h // 2), (2 * w + 1, 3 * h),
                       (7, 5), (w, h), (1, 1)):
                np.testing.assert_allclose(resize_linear(img, wh),
                                           cv2.resize(img, wh), atol=1e-6,
                                           rtol=0)
        cv2.setUseOptimized(True)
        img = rng.random((800, 800, 3)).astype(np.float32)
        for wh in ((400, 400), (200, 200), (1600, 1600)):
            np.testing.assert_allclose(resize_linear(img, wh),
                                       cv2.resize(img, wh), atol=1e-6,
                                       rtol=0)
    finally:
        cv2.setUseOptimized(was)


def test_decoder_builds_from_source_with_the_host_compiler(tmp_path,
                                                          monkeypatch):
    """The decoder is the repo's own C++ (csrc/dataio.cpp), compiled at
    first use into a digest-named library; with no compiler it raises."""
    path = build.library_path("dataio")
    assert path.name.startswith("libdataio-") and path.parent == \
        build.BUILD_DIR
    image_io.write_png(str(tmp_path / "a.png"), np.zeros((2, 2), np.uint8))
    image_io.read_png(str(tmp_path / "a.png"))
    assert path.exists()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        build.build(["dataio"])
