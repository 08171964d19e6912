"""The port's OpenEXR loaders (colmap_exr, colmap_real_exr, myblender)
against the JAX package's on captures written by datasets/captures.py:
rays, poses, K, directions, blender_trans/scale and the split sizes, to
1e-6 of the values' scale.

The JAX read_image decodes EXR files with `cv2.imread`, and this test
environment's OpenCV is built without OpenEXR. So the `jax_cv2_openexr`
fixture replaces `cv2.imread`, and only that, on the cv2 module the JAX
color_utils imports: the shim returns OpenEXR's decode of the file
(`arnerf_tpu.native.load_images_batch`, which links libOpenEXR) in the
layout cv2.imread gives for an RGB OpenEXR file, BGR float32. The JAX
code around it runs unchanged: its premultiply (the captures have no
alpha), the BGR-to-RGB swap and cv2.resize. Resizes are by 2 only: an IPP
build of OpenCV resizes by other factors with Intel's algorithm, not the
INTER_LINEAR the port computes (ROADMAP section 3).
"""

import os
import shutil
import struct

import cv2
import numpy as np
import pytest

from arnerf_tpu.datasets import color_utils as j_color
from arnerf_tpu.datasets.colmap_exr import ColmapEXRDataset as JColmapEXR
from arnerf_tpu.datasets.colmap_real_exr import \
    ColmapRealEXRDataset as JColmapRealEXR
from arnerf_tpu.datasets.myblender import MyBlenderDataset as JMyBlender

from arnerf_tpu_torch import datasets as t_datasets
from arnerf_tpu_torch.datasets import captures
from arnerf_tpu_torch.datasets import color_utils as t_color

TOL = 1e-6
WH = (48, 36)


def _data_window(path):
    """(width, height) from an OpenEXR header's dataWindow attribute."""
    with open(path, "rb") as f:
        buf = f.read(4096)
    i = buf.index(b"dataWindow\0box2i\0") + len(b"dataWindow\0box2i\0") + 4
    x0, y0, x1, y1 = struct.unpack_from("<iiii", buf, i)
    return x1 - x0 + 1, y1 - y0 + 1


@pytest.fixture
def jax_cv2_openexr(monkeypatch):
    from arnerf_tpu import native
    if native._get_lib() is None:
        pytest.skip("arnerf_tpu/native/libdataio.so (libOpenEXR) cannot be "
                    "built or loaded here")
    imread = cv2.imread

    def openexr_imread(path, flags=cv2.IMREAD_COLOR):
        if not str(path).endswith(".exr"):
            return imread(path, flags)
        w, h = _data_window(path)
        rgb = native.load_images_batch([str(path)], (w, h), blend_a=False)
        assert rgb is not None, path
        return np.ascontiguousarray(rgb[0].reshape(h, w, 3)[..., ::-1])

    monkeypatch.setattr(cv2, "imread", openexr_imread)


@pytest.fixture(scope="module")
def captures_root(tmp_path_factory):
    """A colmap_exr capture (10 views), the same frames in the
    colmap_real_exr layout, and a myblender capture (10 views)."""
    base = tmp_path_factory.mktemp("exr")
    cexr = str(base / "colmap_exr")
    captures.write_colmap_exr_capture(cexr, n_views=10, wh=WH, focal=42.0,
                                      n_points=256, n_samples=64)
    # colmap_real_exr: IMG.jpg in images.bin -> exr/IMG.exr
    real = str(base / "colmap_real_exr")
    shutil.copytree(os.path.join(cexr, "sparse"), os.path.join(real,
                                                               "sparse"))
    os.makedirs(os.path.join(real, "exr"))
    names = [f"IMG_{i:04d}" for i in range(10)]
    with open(os.path.join(real, "sparse", "0", "images.bin"), "r+b") as f:
        data = f.read()
        for i, n in enumerate(names):
            old = f"train_r_{i}_0.png".encode()
            data = data.replace(old + b"\0", f"{n}.jpg".encode() + b"\0")
        f.seek(0)
        f.write(data)
        f.truncate()
    for i, n in enumerate(names):
        shutil.copy(os.path.join(cexr, "train_hdr", f"hdr_{i:03d}.exr"),
                    os.path.join(real, "exr", f"{n}.exr"))
    myb = str(base / "myblender")
    captures.write_myblender_capture(myb, n_views=10, wh=WH, focal=42.0,
                                     n_samples=64)
    return {"colmap_exr": cexr, "colmap_real_exr": real, "myblender": myb}


def same(jds, tds):
    assert tds.img_wh == jds.img_wh
    np.testing.assert_allclose(tds.K, jds.K, atol=TOL, rtol=0)
    np.testing.assert_allclose(tds.directions, jds.directions, atol=TOL,
                               rtol=0)
    assert tds.poses.shape == jds.poses.shape
    np.testing.assert_allclose(tds.poses, jds.poses, atol=TOL, rtol=0)
    assert tds.rays.dtype == np.float32
    assert tds.rays.shape == np.asarray(jds.rays).shape
    scale = max(1.0, float(np.abs(jds.rays).max(initial=0.0)))
    np.testing.assert_allclose(tds.rays, jds.rays, atol=TOL * scale, rtol=0)
    for k in ("blender_trans", "blender_scale", "pts3d"):
        assert hasattr(tds, k) == hasattr(jds, k), k
        if hasattr(jds, k):
            np.testing.assert_allclose(getattr(tds, k), getattr(jds, k),
                                       atol=TOL, rtol=0)
    assert len(tds) == len(jds)


LOADERS = {"colmap_exr": JColmapEXR, "colmap_real_exr": JColmapRealEXR,
           "myblender": JMyBlender}
SPLIT_SIZES = {"train": 8, "test": 2, "trainval": 10, "test_traj": 120}


# myblender takes its size from int.txt: --downsample does not apply
@pytest.mark.parametrize("name,downsample", [
    ("colmap_exr", 1.0), ("colmap_exr", 0.5), ("colmap_real_exr", 1.0),
    ("colmap_real_exr", 0.5), ("myblender", 1.0)])
def test_exr_loader_matches_jax(jax_cv2_openexr, captures_root, name,
                                downsample):
    root = captures_root[name]
    sizes = {}
    for split in SPLIT_SIZES:
        kw = dict(split=split, downsample=downsample)
        jds = LOADERS[name](root, use_EXR=True, **kw)
        tds = t_datasets.dataset_dict[name](root, use_EXR=True,
                                            device="cpu", **kw)
        same(jds, tds)
        sizes[split] = len(tds.poses)
        if split in ("train", "test"):
            assert tds.rays.shape[-1] == 3
            # HDR: radiance above 1, nothing clipped
            assert float(tds.rays.max()) > 1.0
    assert sizes == SPLIT_SIZES


def test_exr_loaders_without_meta_match_jax(jax_cv2_openexr, captures_root):
    """read_meta=False (the insertor's path): intrinsics only."""
    for name, jcls in LOADERS.items():
        jds = jcls(captures_root[name], read_meta=False)
        tds = t_datasets.dataset_dict[name](captures_root[name],
                                            read_meta=False)
        assert tds.img_wh == jds.img_wh and len(tds.rays) == 0
        np.testing.assert_allclose(tds.directions, jds.directions, atol=TOL)


@pytest.mark.parametrize("wh", [WH, (WH[0] // 2, WH[1] // 2)])
def test_read_image_exr_matches_jax(jax_cv2_openexr, captures_root, wh):
    """read_image / read_images(exr_file=True) on the capture's frames, at
    their size and resized by 2."""
    paths = sorted(os.path.join(captures_root["myblender"], "img", f)
                   for f in os.listdir(os.path.join(
                       captures_root["myblender"], "img")))[:3]
    for p in paths:
        np.testing.assert_allclose(
            t_color.read_image(p, wh, blend_a=False, exr_file=True),
            j_color.read_image(p, wh, blend_a=False, exr_file=True),
            atol=TOL * 4, rtol=0)
    want = np.stack([j_color.read_image(p, wh, exr_file=True)
                     for p in paths])
    np.testing.assert_allclose(t_color.read_images(paths, wh, exr_file=True),
                               want, atol=TOL * 4, rtol=0)


def test_captures_hold_the_radiance_written(captures_root):
    """What write_*_capture returns is what the loaders decode, after HALF
    rounding."""
    imgs = captures.write_myblender_capture(
        os.path.join(captures_root["myblender"], "again"), n_views=2,
        wh=(16, 12), focal=14.0, n_samples=32)
    ds = t_datasets.MyBlenderDataset(
        os.path.join(captures_root["myblender"], "again"), split="trainval")
    half = np.stack(imgs).astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(ds.rays, half.reshape(2, -1, 3))
    assert float(half.max()) > 1.0


def test_registry_holds_the_exr_loaders_and_refuses_rtmv(tmp_path):
    """rtmv is an LDR loader of the PNGs prepare_rtmv makes from a scene's
    OpenEXR frames (as the JAX rtmv.py:49 reads images/*): a scene with
    only its EXR frames is refused, naming the prep."""
    for name in ("colmap_exr", "colmap_real_exr", "myblender"):
        assert t_datasets.unported_reason(name) is None
    assert "rtmv" not in t_datasets.EXR_DATASETS
    root = str(tmp_path / "rtmv")
    captures.write_rtmv_capture(root, n_frames=2, wh=(8, 8))
    with pytest.raises(FileNotFoundError, match="prepare_rtmv"):
        t_datasets.dataset_dict["rtmv"](root, split="train")
