"""The port's RTMV path against the JAX package: the loader
(arnerf_tpu_torch/datasets/rtmv.py) on the PNGs the port's prep writes
from datasets/captures.py's RTMV scene, and the prep
(arnerf_tpu_torch/prepare_rtmv.py) against misc/prepare_rtmv.py on the
tests/data/exr/ fixtures; then the train entry point on a prepared scene.

The JAX loader is held to its `read_image` path (imageio), as in
test_torch_datasets.py; the frames are 8x8, so no resize runs. K,
directions, poses and rays must agree to 1e-6.

The JAX script reads frames with `cv2.imread(IMREAD_UNCHANGED)`, and this
test environment's OpenCV has no OpenEXR. So its `cv2.imread` is replaced,
as in test_torch_datasets_exr.py, by what OpenCV returns for these files:
float32 B, G, R(, A) of the values the file holds. For the HALF RGB
fixtures those are OpenEXR's own decode (`arnerf_tpu.native`), which
equals them; for FLOAT or RGBA fixtures OpenEXR's RGBA interface rounds to
HALF or premultiplies, so the shim returns the values the fixtures were
written with (`expected.npy`, to which test_torch_exr.py holds the
library). The JAX script writes its PNGs with imageio (PIL's encoder) and
the port with its own, so the files' bytes differ by encoder: the test
holds their names and decoded pixels equal, exactly.
"""

import importlib.util
import os
import shutil
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

import arnerf_tpu.native as j_native
from arnerf_tpu.datasets.rtmv import RTMVDataset as JRTMV

from arnerf_tpu_torch import datasets as t_datasets
from arnerf_tpu_torch import prepare_rtmv
from arnerf_tpu_torch.datasets import captures

REPO = Path(__file__).resolve().parent.parent
EXR = REPO / "tests" / "data" / "exr"
EXPECTED = np.load(EXR / "expected.npy")        # (2, H, W, RGBA)
FIXTURES = sorted(p.name for p in EXR.glob("*.exr")
                  if not p.name.startswith("unsupported_"))
TOL = 1e-6
SMALL_FLAGS = ["--grid_size", "32", "--n_levels", "4",
               "--log2_hashmap_size", "12"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two prepared RTMV scenes (110 frames at 8x8), one under a path
    holding 'bricks' and one not."""
    base = tmp_path_factory.mktemp("rtmv")
    out = {}
    for name in ("bricks_scene", "plain_scene"):
        root = str(base / name)
        captures.write_rtmv_capture(root)
        prepare_rtmv.main(root)
        out[name] = root
    return out


@pytest.mark.parametrize("split", ["train", "trainval", "test",
                                   "trainvaltest"])
@pytest.mark.parametrize("name", ["bricks_scene", "plain_scene"])
def test_loader_matches_jax(roots, name, split, monkeypatch):
    monkeypatch.setattr(j_native, "_get_lib", lambda: None)
    root = roots[name]
    j = JRTMV(root, split=split)
    t = t_datasets.dataset_dict["rtmv"](root, split=split)
    n = {"train": 100, "trainval": 105, "test": 5}.get(split, 110)
    assert t.poses.shape == (n, 3, 4) and t.rays.shape == (n, 64, 3)
    assert t.img_wh == j.img_wh == (8, 8)
    for attr in ("K", "directions", "poses", "rays", "shift", "scale"):
        np.testing.assert_allclose(np.asarray(getattr(t, attr)),
                                   np.asarray(getattr(j, attr)),
                                   atol=TOL, rtol=0, err_msg=attr)
    assert t.rays.std() > 0.05          # the scene, not a blank frame


def test_bricks_poses_are_the_cameras_rendered(roots):
    """Under 'bricks' the loader re-centres and rescales by the scene box,
    and the capture wrote its translations for that: both roots give the
    cameras rendered, with the scene inside [-0.5, 0.5]."""
    a = t_datasets.RTMVDataset(roots["bricks_scene"], split="trainvaltest")
    b = t_datasets.RTMVDataset(roots["plain_scene"], split="trainvaltest")
    np.testing.assert_allclose(a.poses, b.poses, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(a.poses[:, [0, 2], 3], axis=1),
                               1.2, atol=1e-5)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_rtmv", REPO / "misc" / "prepare_rtmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _file_values(name):
    """The values a fixture holds, (H, W, 3|4) float32 (test_torch_exr's
    expected_values)."""
    kind, chans = name[:-4].split("_")[1:3]
    if kind == "mixed":                  # R, G HALF; B, A FLOAT
        want = np.concatenate([EXPECTED[1][..., :2], EXPECTED[0][..., 2:]],
                              -1)
    else:
        want = EXPECTED[0] if kind == "float" else EXPECTED[1]
    return want if "rgba" in chans else want[..., :3]


@pytest.fixture
def jax_cv2_unchanged(monkeypatch):
    imread = cv2.imread

    def unchanged(path, flags=cv2.IMREAD_COLOR):
        name = os.path.basename(str(path))
        if not name.endswith(".exr"):
            return imread(path, flags)
        assert flags == cv2.IMREAD_UNCHANGED
        img = _file_values(name)
        if name.endswith("half_rgb.exr") and j_native._get_lib() is not None:
            h, w = img.shape[:2]
            lib = j_native.load_images_batch([str(path)], (w, h),
                                             blend_a=False)
            np.testing.assert_array_equal(lib[0].reshape(h, w, 3), img)
        bgr = img[..., [2, 1, 0] + ([3] if img.shape[2] == 4 else [])]
        return np.ascontiguousarray(bgr, np.float32)

    monkeypatch.setattr(cv2, "imread", unchanged)


def test_prepare_matches_the_jax_script(tmp_path, jax_cv2_unchanged,
                                        capsys):
    roots = {}
    for side in ("jax", "port"):
        roots[side] = tmp_path / side
        roots[side].mkdir()
        for name in FIXTURES:
            shutil.copy(EXR / name, roots[side] / name)
    _jax_script().main(str(roots["jax"]))
    prepare_rtmv.main(str(roots["port"]))
    printed = capsys.readouterr().out.split()
    names = [n[:-4] + ".png" for n in FIXTURES]
    assert printed == names + names
    for name in names:
        want = imageio.imread(roots["jax"] / "images" / name)
        got = imageio.imread(roots["port"] / "images" / name)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.shape[2] == 3
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the fixtures span 0 .. 6e4: black, the sRGB curve and the clamp
    got = imageio.imread(roots["port"] / "images" / "zip_float_rgb.png")
    assert got.min() == 0 and got.max() == 255 and len(np.unique(got)) > 30


def test_prepare_names_what_the_reader_refuses(tmp_path):
    shutil.copy(EXR / "unsupported_piz.exr", tmp_path / "00000.exr")
    with pytest.raises(ValueError, match="PIZ"):
        prepare_rtmv.main(str(tmp_path))


def test_loader_asks_for_the_prep(tmp_path):
    root = str(tmp_path / "raw")
    captures.write_rtmv_capture(root, n_frames=2)
    with pytest.raises(FileNotFoundError, match="prepare_rtmv"):
        t_datasets.RTMVDataset(root)


def test_train_entry_point_trains_on_a_prepared_scene(tmp_path,
                                                      monkeypatch):
    from arnerf_tpu_torch import train as t_train
    root = str(tmp_path / "bricks")
    captures.write_rtmv_capture(root, wh=(16, 16), focal=20.0)
    prepare_rtmv.main(root)
    monkeypatch.chdir(tmp_path)
    res = t_train.main(["--device", "cpu", "--dataset_name", "rtmv",
                        "--root_dir", root, "--exp_name", "r",
                        "--num_epochs", "1", "--steps_per_epoch", "32",
                        "--batch_size", "256", "--no_save_test",
                        *SMALL_FLAGS])
    assert len(res["psnr"]) == 5 and np.isfinite(res["psnr"]).all()
    assert (tmp_path / "ckpts" / "rtmv" / "r" / "epoch=0.npz").exists()
