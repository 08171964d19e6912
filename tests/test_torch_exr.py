"""The port's OpenEXR reader and writer (arnerf_tpu_torch/image_io.py, the
chunk decoding in csrc/dataio.cpp) against the OpenEXR library.

The fixtures under tests/data/exr/ were written by the OpenEXR library
(scripts/make_exr_fixtures.cpp), with the values they hold in
expected.npy. The library's own decode comes from the JAX package's
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
SUPPORTED = sorted(p.name for p in DATA.glob("*.exr")
                   if not p.name.startswith("unsupported_"))
UNSUPPORTED = {
    "unsupported_piz.exr": "PIZ compression",
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
    codec, kind, chans = name[:-4].split("_")[:3]
    if kind == "mixed":                  # R, G HALF; B, A FLOAT
        want = np.concatenate([EXPECTED[1][..., :2], EXPECTED[0][..., 2:]],
                              -1)
    else:
        want = EXPECTED[0] if kind == "float" else EXPECTED[1]
    return want if "rgba" in chans else want[..., :3]


def test_fixtures_cover_every_codec_and_layout():
    names = set(SUPPORTED)
    for codec in ("none", "rle", "zips", "zip"):
        for kind in ("half", "float"):
            for chans in ("rgb", "rgba"):
                assert f"{codec}_{kind}_{chans}.exr" in names
    assert {"zip_half_rgba_window.exr", "zips_half_rgba_decreasing.exr",
            "zip_mixed_rgbaz.exr"} <= names
    assert set(UNSUPPORTED) == {p.name for p in DATA.glob("unsupported_*")}
    # values 1e-4 .. 6e4 with zeros; alpha 0 .. 1
    rgb = EXPECTED[0][..., :3]
    assert rgb.min() == 0 and 1e-4 <= rgb[rgb > 0].min() < 2e-4
    assert 5e4 < rgb.max() < 65504
    assert EXPECTED[0][..., 3].min() == 0 and EXPECTED[0][..., 3].max() == 1


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
    default compression) writes PIZ, the codec the port does not read yet
    (ROADMAP): its files raise, naming PIZ. The same image written by the
    port's writer reads back as OpenEXR reads the JAX file."""
    native = _openexr()
    rng = np.random.default_rng(4)
    img = (rng.random((21, 17, 3)) * 8).astype(np.float32)
    j_path, t_path = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
    assert native.write_exr(j_path, img)
    image_io.write_exr(t_path, img)
    with pytest.raises(ValueError, match="PIZ compression"):
        image_io.read_exr(j_path)
    lib = native.load_images_batch([j_path], (17, 21))
    np.testing.assert_array_equal(image_io.read_exr(t_path),
                                  lib[0].reshape(21, 17, 3))

