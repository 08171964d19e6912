"""The port's OpenEXR reader and writer (arnerf_tpu_torch/image_io.py, the
chunk decoding in csrc/dataio.cpp) against the OpenEXR library.

The fixtures under tests/data/exr/ were written by the OpenEXR library
(scripts/make_exr_fixtures.cpp), with the values they hold in
expected.npy, or, for three PIZ files, in a .npy of their own name. The library's own decode comes from the JAX package's
native loader (`arnerf_tpu.native.load_images_batch`, OpenEXR's RGBA
interface), which links libOpenEXR; the tests that need it skip when it
cannot be loaded. That interface reads every channel as HALF and returns
rgb * a; at the file's own size its resize is the identity. So a HALF
fixture must decode to the library's values exactly, and a FLOAT one to
the library's values after rounding the port's decode to HALF (and to the
generator's FLOAT values exactly). Every comparison is exact.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from arnerf_tpu_torch import image_io
from arnerf_tpu_torch.datasets import color_utils as t_color

DATA = Path(__file__).resolve().parent / "data" / "exr"
EXPECTED = np.load(DATA / "expected.npy")        # (2, H, W, RGBA)
EXPECTED_PIZ = np.load(DATA / "expected_piz.npy")   # the piz_* files
SUPPORTED = sorted(p.name for p in DATA.glob("*.exr")
                   if not p.name.startswith("unsupported_"))
UNSUPPORTED = {
    "unsupported_pxr24.exr": "PXR24 compression",
    "unsupported_b44.exr": "B44 compression",
    "unsupported_b44a.exr": "B44A compression",
    "unsupported_dwaa.exr": "DWAA compression",
    "unsupported_dwab.exr": "DWAB compression",
    "unsupported_tiled.exr": "tiled",
    "unsupported_multipart.exr": "multi-part",
    "unsupported_deep.exr": "deep",
    "unsupported_luminance.exr": r"\['Y'\] lack R, G or B",
    "unsupported_uint.exr": "type UINT",
}


def _openexr():
    """The OpenEXR library's batch loader, or skip."""
    from arnerf_tpu import native
    if native._get_lib() is None:
        pytest.skip("arnerf_tpu/native/libdataio.so (libOpenEXR) cannot be "
                    "built or loaded here")
    return native


def expected_values(name):
    """The channel values a supported fixture holds, (H, W, 3|4) float32:
    the generator's FLOAT values, rounded to HALF for HALF channels."""
    own = DATA / name.replace(".exr", ".npy")
    if own.exists():
        return np.load(own)
    codec, kind, chans = name[:-4].split("_")[:3]
    values = EXPECTED_PIZ if codec == "piz" else EXPECTED
    if kind == "mixed":                  # R, G HALF; B, A FLOAT
        want = np.concatenate([values[1][..., :2], values[0][..., 2:]], -1)
    else:
        want = values[0] if kind == "float" else values[1]
    return want if "rgba" in chans else want[..., :3]


def test_fixtures_cover_every_codec_and_layout():
    names = set(SUPPORTED)
    for codec in ("none", "rle", "zips", "zip", "piz"):
        for kind in ("half", "float"):
            for chans in ("rgb", "rgba"):
                assert f"{codec}_{kind}_{chans}.exr" in names
    assert {"zip_half_rgba_window.exr", "zips_half_rgba_decreasing.exr",
            "zip_mixed_rgbaz.exr", "piz_mixed_rgb.exr", "piz_mixed_rgba.exr",
            "piz_half_rgba_window.exr", "piz_half_rgb_raw.exr",
            "piz_float_rgb_wav16.exr"} <= names
    assert set(UNSUPPORTED) == {p.name for p in DATA.glob("unsupported_*")}
    # values 1e-4 .. 6e4 with zeros; alpha 0 .. 1
    rgb = EXPECTED[0][..., :3]
    assert rgb.min() == 0 and 1e-4 <= rgb[rgb > 0].min() < 2e-4
    assert 5e4 < rgb.max() < 65504
    assert EXPECTED[0][..., 3].min() == 0 and EXPECTED[0][..., 3].max() == 1
    # the PIZ ramps: [0.5, 1.25] with zeros, and FLOAT detail below HALF's
    # precision, so the FLOAT and HALF fixtures hold different values
    rgb = EXPECTED_PIZ[0][..., :3]
    assert rgb.min() == 0 and 0.5 <= rgb[rgb > 0].min() and rgb.max() < 1.26
    assert (EXPECTED_PIZ[0] != EXPECTED_PIZ[1]).any()


@pytest.mark.parametrize("name", SUPPORTED)
def test_reader_gives_the_values_written(name):
    img = image_io.read_exr(str(DATA / name))
    want = expected_values(name)
    assert img.dtype == np.float32 and img.shape == want.shape
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("name", SUPPORTED)
def test_reader_matches_openexr(name):
    native = _openexr()
    path = str(DATA / name)
    img = image_io.read_exr(path)
    h, w = img.shape[:2]
    lib = native.load_images_batch([path], (w, h), blend_a=False)
    assert lib is not None, f"OpenEXR could not read {name}"
    half = img.astype(np.float16).astype(np.float32)
    if img.shape[2] == 4:
        half = half[..., :3] * half[..., 3:]
    np.testing.assert_array_equal(lib[0].reshape(h, w, 3), half)
    if "float" not in name and "mixed" not in name:
        # HALF files: read_image's premultiply is the library's, exactly
        np.testing.assert_array_equal(
            t_color.read_image(path, (w, h), exr_file=True),
            lib[0].reshape(-1, 3))


def test_compressed_fixtures_hold_compressed_chunks():
    """OpenEXR stores a chunk raw when compressing does not shrink it; each
    compressed fixture must still exercise its codec in some chunk."""
    for name in SUPPORTED:
        if name.startswith("none"):
            continue
        buf = (DATA / name).read_bytes()
        info = image_io._parse_exr(name, buf)
        lines = image_io._EXR_LINES[info["comp"]]
        row_bytes = sum(info["w"] * (2 if t == 1 else 4)
                        for _, t in info["channels"])
        packed = 0
        for off in info["offsets"]:
            y, size = struct.unpack_from("<ii", buf, int(off))
            rows = min(lines, info["h"] - (y - info["ymin"]))
            packed += size < rows * row_bytes
        assert packed > 0, name


def _chunks(name):
    """(first row, rows, stored size, raw size, data) of every chunk."""
    buf = (DATA / name).read_bytes()
    info = image_io._parse_exr(name, buf)
    lines = image_io._EXR_LINES[info["comp"]]
    row_bytes = sum(info["w"] * (2 if t == 1 else 4)
                    for _, t in info["channels"])
    out = []
    for off in info["offsets"]:
        y, size = struct.unpack_from("<ii", buf, int(off))
        rows = min(lines, info["h"] - (y - info["ymin"]))
        out.append((y - info["ymin"], rows, size, rows * row_bytes,
                    buf[int(off) + 8:int(off) + 8 + size]))
    return info, out


def test_piz_fixtures_cover_short_blocks_raw_blocks_and_both_wavelets():
    """The three PIZ layouts a decoder most often gets wrong are in the
    fixtures: a short last block in an offset data window, a block that
    OpenEXR stored raw beside a compressed one, and a block with 2^14 or
    more distinct words (the 16-bit wavelet) beside ones with fewer."""
    info, chunks = _chunks("piz_half_rgba_window.exr")
    assert (info["ymin"], info["h"]) == (-7, 45)
    assert [c[1] for c in chunks] == [32, 13]
    assert all(c[2] < c[3] for c in chunks)
    _, chunks = _chunks("piz_half_rgb_raw.exr")
    assert [c[2] == c[3] for c in chunks] == [True, False]

    def distinct_words(data):       # bitmap bits, plus word 0
        lo, hi = struct.unpack_from("<HH", data)
        bitmap = np.frombuffer(data, np.uint8, hi - lo + 1, 4)
        return int(np.unpackbits(bitmap).sum()) + 1

    _, chunks = _chunks("piz_float_rgb_wav16.exr")
    assert len(chunks) == 1 and chunks[0][2] < chunks[0][3]
    assert distinct_words(chunks[0][4]) >= 1 << 14
    _, chunks = _chunks("piz_float_rgb.exr")
    assert max(distinct_words(c[4]) for c in chunks if c[2] < c[3]) \
        < 1 << 14


def test_corrupt_piz_chunk_raises_naming_the_file(tmp_path):
    """A PIZ chunk whose Huffman stream ends early raises; nothing falls
    back to another decoder."""
    name = "piz_half_rgb.exr"
    buf = bytearray((DATA / name).read_bytes())
    info = image_io._parse_exr(name, bytes(buf))
    off = int(info["offsets"][0]) + 8
    lo, hi = struct.unpack_from("<HH", buf, off)
    huf = off + 4 + (hi - lo + 1) + 4        # the Huffman header
    n_bits = struct.unpack_from("<I", buf, huf + 12)[0]
    struct.pack_into("<I", buf, huf + 12, n_bits // 2)
    bad = tmp_path / "bad.exr"
    bad.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="PIZ chunk") as e:
        image_io.read_exr(str(bad))
    assert "bad.exr" in str(e.value)


def test_read_exr_many_matches_one_by_one():
    paths = [str(DATA / n) for n in SUPPORTED]
    for img, p in zip(image_io.read_exr_many(paths), paths):
        np.testing.assert_array_equal(img, image_io.read_exr(p))


@pytest.mark.parametrize("name,found", sorted(UNSUPPORTED.items()))
def test_unsupported_files_raise_naming_what_they_found(name, found):
    path = str(DATA / name)
    with pytest.raises(ValueError, match=found) as e:
        image_io.read_exr(path)
    assert name in str(e.value)
    with pytest.raises(ValueError, match=found):
        t_color.read_images([path], (8, 8), exr_file=True)


def test_non_exr_and_truncated_files_raise(tmp_path):
    png = tmp_path / "a.png"
    image_io.write_png(str(png), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="not an OpenEXR file"):
        image_io.read_exr(str(png))
    buf = (DATA / "zip_half_rgb.exr").read_bytes()
    cut = tmp_path / "cut.exr"
    cut.write_bytes(buf[:len(buf) - 100])
    with pytest.raises(ValueError, match="cut.exr"):
        image_io.read_exr(str(cut))


@pytest.mark.parametrize("shape", [(37, 29), (1, 1), (16, 5), (48, 64)])
def test_write_exr_is_half_zip_and_round_trips(tmp_path, shape):
    """The port's writer (HALF B, G, R; ZIP) through the port's reader and
    through OpenEXR: the values rounded to HALF, exactly; beyond HALF's
    range an infinity, as OpenEXR's own conversion gives."""
    rng = np.random.default_rng(3)
    img = (rng.random(shape + (3,)) * 20).astype(np.float32)
    img[0, 0] = (0.0, 6e4, 1e-4)
    path = str(tmp_path / "a.exr")
    image_io.write_exr(path, img)
    info = image_io._parse_exr(path, Path(path).read_bytes())
    assert image_io.EXR_CODECS[info["comp"]] == "ZIP"
    assert info["channels"] == [("B", 1), ("G", 1), ("R", 1)]
    half = img.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(image_io.read_exr(path), half)
    native = _openexr()
    lib = native.load_images_batch([path], shape[::-1])
    np.testing.assert_array_equal(lib[0].reshape(half.shape), half)
    big = np.full((2, 2, 3), 1e6, np.float32)
    image_io.write_exr(path, big)
    assert np.isinf(image_io.read_exr(path)).all()


def test_jax_writer_files_through_the_port(tmp_path):
    """The JAX package's native write_exr (OpenEXR's RgbaOutputFile with its
    default compression) writes PIZ: the port reads its files as OpenEXR
    reads them. The same image written by the port's writer (HALF ZIP)
    reads back as OpenEXR reads the JAX file."""
    native = _openexr()
    rng = np.random.default_rng(4)
    img = (rng.random((21, 17, 3)) * 8).astype(np.float32)
    j_path, t_path = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    assert native.write_exr(j_path, img)
    image_io.write_exr(t_path, img)
    info = image_io._parse_exr(j_path, open(j_path, "rb").read())
    assert image_io.EXR_CODECS[info["comp"]] == "PIZ"
    lib = native.load_images_batch([j_path], (17, 21))
    np.testing.assert_array_equal(image_io.read_exr(j_path),
                                  lib[0].reshape(21, 17, 3))
    np.testing.assert_array_equal(image_io.read_exr(t_path),
                                  lib[0].reshape(21, 17, 3))

