"""The port's dataset loaders against the JAX package's on the same seeded
on-disk fixtures (nerf, nsvf, nerfpp, colmap; built as tests/test_datasets.py
and the fixture e2e tests build them, with imageio).

The JAX package is held to its `read_image` path (imageio + OpenCV): its
native libpng/libjpeg batch decoder is switched off by patching
`arnerf_tpu.native._get_lib` in the test only, since its own test accepts up
to 2e-2 between the two paths (tests/test_native_dataio.py). Rays, poses,
K, directions, blender_trans and blender_scale must agree to 1e-6, at
downsample 1.0 and at 0.5, which resizes. 0.5 is a power-of-two factor:
there an IPP build of OpenCV and OpenCV's own INTER_LINEAR algorithm
(which the port computes) agree to rounding; at other factors such a build
takes Intel IPP's resize (tests/test_torch_image_io.py).
"""

import json
import os
import struct

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import arnerf_tpu.native as j_native
from arnerf_tpu.datasets import color_utils as j_color
from arnerf_tpu.datasets import colmap_utils as j_colmap_utils
from arnerf_tpu.datasets import depth_utils as j_depth
from arnerf_tpu.datasets import ray_utils as j_rays
from arnerf_tpu.datasets.colmap import ColmapDataset as JColmap
from arnerf_tpu.datasets.nerf import NeRFDataset as JNeRF
from arnerf_tpu.datasets.nerfpp import NeRFPPDataset as JNeRFPP
from arnerf_tpu.datasets.nsvf import NSVFDataset as JNSVF

from arnerf_tpu_torch import datasets as t_datasets
from arnerf_tpu_torch.datasets import color_utils as t_color
from arnerf_tpu_torch.datasets import colmap_utils as t_colmap_utils
from arnerf_tpu_torch.datasets import depth_utils as t_depth
from arnerf_tpu_torch.datasets import ray_utils as t_rays

TOL = 1e-6


@pytest.fixture(autouse=True)
def jax_read_image_path(monkeypatch):
    monkeypatch.setattr(j_native, "_get_lib", lambda: None)


def _img(rng, h, w, c):
    img = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    if c == 4:      # a real alpha: transparent, opaque and partial
        img[: h // 3, :, 3] = 0
        img[h // 3: h // 2, :, 3] = 255
    return img


def _c2w_on_sphere(rng, radius):
    th, phi = rng.uniform(0, 2 * np.pi), rng.uniform(-0.5, 0.3)
    eye = radius * np.array([np.cos(th) * np.cos(phi), np.sin(phi),
                             np.sin(th) * np.cos(phi)])
    return t_rays.look_at_pose(eye).astype(np.float64)


def write_blender(root, wh=800, n=(2, 1, 1)):
    """transforms_{train,val,test}.json + RGBA PNGs, cameras at radii
    3.5-4.5 (the loader rescales each frame to 1.5)."""
    rng = np.random.default_rng(0)
    for split, k in zip(("train", "val", "test"), n):
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(k):
            c2w = _c2w_on_sphere(rng, 3.5 + rng.random())
            c2w[:, 1:3] *= -1
            mat = np.eye(4)
            mat[:3] = c2w
            imageio.imsave(os.path.join(root, split, f"r_{i}.png"),
                           _img(rng, wh, wh, 4))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": mat.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)


def write_nsvf(root, synthetic=True):
    rng = np.random.default_rng(1)
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "pose"), exist_ok=True)
    np.savetxt(os.path.join(root, "bbox.txt"),
               np.array([-0.7, -0.6, -0.5, 0.5, 0.8, 0.6, 0.05]))
    if synthetic:
        w, h = 800, 800
        with open(os.path.join(root, "intrinsics.txt"), "w") as f:
            f.write("1111.1 0 400 0\n0 1111.1 400 0\n0 0 1 0\n0 0 0 1\n")
    else:       # BlendedMVS: a full K, 768x576
        w, h = 768, 576
        np.savetxt(os.path.join(root, "intrinsics.txt"),
                   np.array([[600.0, 0, 380, 0], [0, 610, 290, 0],
                             [0, 0, 1, 0], [0, 0, 0, 1]]))
    for prefix, k in (("0_", 2), ("1_", 1), ("2_", 1)):
        for i in range(k):
            img = _img(rng, h, w, 3)
            img[:40] = 5            # dark rows: the Jade/Fountain rewrite
            imageio.imsave(os.path.join(root, "rgb", f"{prefix}{i:04d}.png"),
                           img)
            mat = np.eye(4)
            mat[:3] = _c2w_on_sphere(rng, 2.0 + 0.1 * i)
            np.savetxt(os.path.join(root, "pose", f"{prefix}{i:04d}.txt"),
                       mat)
    np.savetxt(os.path.join(root, "test_traj.txt"),
               np.stack([np.eye(4)] * 3).reshape(-1, 4))


def write_nerfpp(root, w=48, h=40):
    rng = np.random.default_rng(2)
    for split, k in (("train", 3), ("val", 1), ("test", 2)):
        for sub in ("rgb", "pose", "intrinsics"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(k):
            imageio.imsave(os.path.join(root, split, "rgb", f"{i:03d}.png"),
                           _img(rng, h, w, 3))
            mat = np.eye(4)
            mat[:3] = _c2w_on_sphere(rng, 3.0)
            np.savetxt(os.path.join(root, split, "pose", f"{i:03d}.txt"),
                       mat.reshape(1, 16))
            K = np.eye(4)
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 50.0, 51.0, w / 2, h / 2
            np.savetxt(os.path.join(root, split, "intrinsics",
                                    f"{i:03d}.txt"), K.reshape(1, 16))
    os.makedirs(os.path.join(root, "camera_path", "pose"), exist_ok=True)
    for i in range(2):
        np.savetxt(os.path.join(root, "camera_path", "pose", f"{i}.txt"),
                   np.eye(4).reshape(1, 16))


def write_colmap_model(sparse, n, w, h, model=1, names=None):
    """cameras.bin (PINHOLE = 1 or SIMPLE_RADIAL = 2), images.bin with
    cameras on a ring looking inwards, points3D.bin of 50 points."""
    os.makedirs(sparse, exist_ok=True)
    rng = np.random.default_rng(3)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, model, w, h))
        params = (0.9 * w, 0.9 * w, w / 2, h / 2) if model == 1 else \
            (0.9 * w, w / 2, h / 2, 0.01)
        f.write(struct.pack("<dddd", *params))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3] = _c2w_on_sphere(rng, 4.0 + 0.2 * rng.random())
            c2w[:3, 3] += [0.3, -0.2, 0.1]
            w2c = np.linalg.inv(c2w)
            q = j_colmap_utils.rotmat2qvec(w2c[:3, :3])
            f.write(struct.pack("<idddddddi", i + 1, *q, *w2c[:3, 3], 1))
            name = names[i] if names else f"img_{i:03d}.png"
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 2))
            f.write(struct.pack("<ddqddq", 1.0, 2.0, 1, 3.0, 4.0, -1))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 50))
        for i in range(50):
            f.write(struct.pack("<QdddBBBd", i + 1, *rng.normal(size=3),
                                10, 20, 30, 0.5))
            f.write(struct.pack("<Q", 2) + struct.pack("<iiii", 1, 0, 2, 1))


def write_colmap(root, folder="images", n=10, w=32, h=24, model=1):
    write_colmap_model(os.path.join(root, "sparse", "0"), n, w, h, model)
    os.makedirs(os.path.join(root, folder), exist_ok=True)
    rng = np.random.default_rng(4)
    for i in range(n):
        imageio.imsave(os.path.join(root, folder, f"img_{i:03d}.png"),
                       _img(rng, h, w, 4))


def write_hdr_nerf(root, n=4, w=40, h=32):
    """HDR-NeRF's real-capture layout: 5 exposures of n views as JPEGs."""
    names = [f"img_{i:03d}.jpg" for i in range(n)]
    write_colmap_model(os.path.join(root, "sparse", "0"), n, w, h,
                       names=names)
    os.makedirs(os.path.join(root, "input_images"), exist_ok=True)
    rng = np.random.default_rng(5)
    for i in range(n):
        for e in range(5):
            Image.fromarray(_img(rng, h, w, 3)).save(
                os.path.join(root, "input_images", f"{i:03d}_{e}.jpg"),
                quality=90)


def same(jds, tds):
    assert tds.img_wh == jds.img_wh
    np.testing.assert_allclose(tds.K, jds.K, atol=TOL, rtol=0)
    np.testing.assert_allclose(tds.directions, jds.directions, atol=TOL,
                               rtol=0)
    assert tds.poses.shape == jds.poses.shape
    np.testing.assert_allclose(tds.poses, jds.poses, atol=TOL, rtol=0)
    assert tds.rays.dtype == np.float32
    assert tds.rays.shape == np.asarray(jds.rays).shape
    np.testing.assert_allclose(tds.rays, jds.rays, atol=TOL, rtol=0)
    for k in ("blender_trans", "blender_scale", "unit_exposure_rgb"):
        assert hasattr(tds, k) == hasattr(jds, k), k
        if hasattr(jds, k):
            np.testing.assert_allclose(getattr(tds, k), getattr(jds, k),
                                       atol=TOL, rtol=0)
    assert len(tds) == len(jds)


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nerf") / "lego")
    write_blender(root)
    return root


@pytest.mark.parametrize("split", ["train", "test", "trainval"])
@pytest.mark.parametrize("downsample", [1.0, 0.5])
def test_nerf_loader_matches_jax(blender_root, split, downsample):
    kw = dict(split=split, downsample=downsample)
    same(JNeRF(blender_root, **kw), t_datasets.NeRFDataset(
        blender_root, device="cpu", **kw))


@pytest.mark.parametrize("scene", ["Coffee", "Car", "Scar"])
def test_nerf_jrender_branches_match_jax(tmp_path, scene):
    root = str(tmp_path / "Jrender_Dataset" / scene)
    write_blender(root, wh=64, n=(2, 0, 1))
    for split in ("train", "test"):
        kw = dict(split=split, downsample=64 / 800)
        same(JNeRF(root, **kw), t_datasets.NeRFDataset(root, **kw))


@pytest.mark.parametrize("scene", ["Synthetic_NSVF/Lego", "Synthetic_NSVF/Mic",
                                   "BlendedMVS/Jade"])
@pytest.mark.parametrize("downsample", [1.0, 0.5])
def test_nsvf_loader_matches_jax(tmp_path, scene, downsample):
    root = str(tmp_path / scene)
    write_nsvf(root, synthetic="Synthetic" in scene)
    splits = ["train", "val", "trainval", "trainvaltest", "test"]
    if "Synthetic" not in scene:
        splits.append("test_traj")
    for split in splits:
        kw = dict(split=split, downsample=downsample)
        same(JNSVF(root, **kw), t_datasets.NSVFDataset(root, **kw))


@pytest.mark.parametrize("downsample", [1.0, 0.5])
def test_nerfpp_loader_matches_jax(tmp_path, downsample):
    root = str(tmp_path / "tat_scene")
    write_nerfpp(root)
    for split in ("train", "trainval", "test", "test_traj"):
        kw = dict(split=split, downsample=downsample)
        same(JNeRFPP(root, **kw), t_datasets.NeRFPPDataset(root, **kw))


@pytest.mark.parametrize("layout,downsample,model", [
    ("llff", 1.0, 1), ("llff", 0.5, 2), ("360_v2", 0.5, 1)])
def test_colmap_loader_matches_jax(tmp_path, layout, downsample, model):
    root = str(tmp_path / layout / "garden")
    folder = "images_2" if layout == "360_v2" else "images"
    write_colmap(root, folder, model=model,
                 w=16 if layout == "360_v2" else 32,
                 h=12 if layout == "360_v2" else 24)
    sizes = {}
    for split in ("train", "test", "trainval", "test_traj"):
        kw = dict(split=split, downsample=downsample)
        jds = JColmap(root, **kw)
        tds = t_datasets.ColmapDataset(root, device="cpu", **kw)
        same(jds, tds)
        np.testing.assert_allclose(tds.pts3d, jds.pts3d, atol=TOL, rtol=0)
        sizes[split] = len(tds.poses)
    # every 8th image is the test split; test_traj is the spheric path
    assert sizes == {"train": 8, "test": 2, "trainval": 10, "test_traj": 120}


@pytest.mark.parametrize("split", ["train", "test"])
def test_colmap_hdr_nerf_split_matches_jax(tmp_path, split):
    """HDR-NeRF's real-capture split with its exposure column, decoded
    from baseline JPEGs by both packages."""
    root = str(tmp_path / "HDR-NeRF" / "box")
    write_hdr_nerf(root)
    jds = JColmap(root, split=split)
    tds = t_datasets.ColmapDataset(root, split=split)
    same(jds, tds)
    assert tds.rays.shape[-1] == 4 and tds.unit_exposure_rgb == 0.5
    assert len(tds.poses) == (6 if split == "train" else 4)


def test_loaders_without_meta_match_jax(blender_root, tmp_path):
    """read_meta=False (the insertor's path): intrinsics only."""
    root = str(tmp_path / "scene")
    write_colmap(root)
    for jcls, tcls, r in ((JNeRF, t_datasets.NeRFDataset, blender_root),
                          (JColmap, t_datasets.ColmapDataset, root)):
        jds = jcls(r, read_meta=False, downsample=0.5)
        tds = tcls(r, read_meta=False, downsample=0.5, device="cpu")
        same(jds, tds)
        assert len(tds.rays) == 0


@pytest.mark.parametrize("blend_a", [True, False])
def test_read_image_matches_jax(tmp_path, monkeypatch, blend_a):
    """read_image / read_images on every kind of file the loaders meet:
    RGBA, RGB, gray, 16-bit gray (values up to 257), 1-bit gray, palette,
    and a baseline JPEG, at the file's size and resized by 2."""
    rng = np.random.default_rng(7)
    paths = []
    for name, img in (("rgba", _img(rng, 24, 32, 4)),
                      ("rgb", _img(rng, 24, 32, 3)),
                      ("gray", _img(rng, 24, 32, 1)[..., 0]),
                      ("gray16", rng.integers(0, 65536, (24, 32))
                       .astype(np.uint16))):
        paths.append(str(tmp_path / f"{name}.png"))
        imageio.imsave(paths[-1], img)
    paths.append(str(tmp_path / "bits.png"))
    Image.fromarray(rng.random((24, 32)) > 0.5).save(paths[-1])
    paths.append(str(tmp_path / "pal.png"))
    pal = Image.fromarray(rng.integers(0, 4, (24, 32)).astype(np.uint8), "P")
    pal.putpalette([10, 20, 30, 200, 100, 0, 0, 0, 255, 90, 90, 90])
    pal.save(paths[-1])
    paths.append(str(tmp_path / "photo.jpg"))
    Image.fromarray(_img(rng, 24, 32, 3)).save(paths[-1], quality=90)
    for wh in ((32, 24), (16, 12)):
        for p in paths:
            want = j_color.read_image(p, wh, blend_a)
            # 1e-6 of the values' scale: 16-bit files reach 257
            np.testing.assert_allclose(
                t_color.read_image(p, wh, blend_a), want,
                atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)
        want = j_color.read_images(paths, wh, blend_a)
        monkeypatch.setattr(t_color, "READ_CHUNK", 3)     # several chunks
        np.testing.assert_allclose(
            t_color.read_images(paths, wh, blend_a), want,
            atol=TOL * float(np.abs(want).max()), rtol=0)
    # exr_file=True takes the OpenEXR reader, which names what it found
    with pytest.raises(ValueError, match="not an OpenEXR file"):
        t_color.read_image(paths[0], (32, 24), exr_file=True)


def test_colour_space_helpers_match_jax():
    x = np.random.default_rng(8).random((50, 3)).astype(np.float32) * 1.2
    np.testing.assert_allclose(t_color.srgb_to_linear(x),
                               j_color.srgb_to_linear(x), atol=TOL)
    np.testing.assert_allclose(t_color.linear_to_srgb(x.copy()),
                               j_color.linear_to_srgb(x.copy()), atol=TOL)


def test_pose_utils_match_jax():
    rng = np.random.default_rng(9)
    poses = np.stack([_c2w_on_sphere(rng, 3 + rng.random())
                      for _ in range(7)])
    pts = rng.normal(size=(40, 3))
    for args in ((poses,), (poses, pts)):
        for a, b in zip(t_rays.center_poses(*args),
                        j_rays.center_poses(*args)):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    np.testing.assert_allclose(t_rays.average_poses(poses, pts),
                               j_rays.average_poses(poses, pts), atol=TOL)
    np.testing.assert_allclose(t_rays.create_spheric_poses(1.2, 0.3, 30),
                               j_rays.create_spheric_poses(1.2, 0.3, 30),
                               atol=TOL, rtol=0)
    v = np.concatenate([rng.normal(size=(6, 3)), np.zeros((1, 3))]) \
        .astype(np.float32)
    np.testing.assert_allclose(
        t_rays.axisangle_to_R(torch.from_numpy(v)).numpy(),
        np.asarray(j_rays.axisangle_to_R(jnp.asarray(v))), atol=1e-6, rtol=0)
    # the gradient at zero rotation stays finite (--optimize_ext's start)
    z = torch.zeros((1, 3), requires_grad=True)
    t_rays.axisangle_to_R(z).sum().backward()
    assert torch.isfinite(z.grad).all()


def _write_colmap_text(sparse):
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# camera list\n1 PINHOLE 32 24 28.8 28.8 16 12\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# images\n1 1 0 0 0 0.1 0.2 3 1 a.png\n1 2 5 3 4 -1\n"
                "2 0.7071 0.7071 0 0 0 0 2 1 b.png\n\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        f.write("# points\n5 0.1 0.2 0.3 10 20 30 0.5 1 0 2 1\n"
                "6 -1 2 -3 1 2 3 0.25 2 4\n")


def test_colmap_readers_match_jax(tmp_path):
    sparse = str(tmp_path / "sparse")
    write_colmap_model(sparse, 5, 32, 24)
    _write_colmap_text(sparse)
    for ext in (".bin", ".txt"):
        got = t_colmap_utils.read_model(sparse, ext)
        want = j_colmap_utils.read_model(sparse, ext)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                for a, b in zip(g[k], w[k]):
                    if isinstance(b, np.ndarray):
                        np.testing.assert_array_equal(a, b)
                    else:
                        assert a == b
    ims = t_colmap_utils.read_images_binary(os.path.join(sparse,
                                                         "images.bin"))
    for im in ims.values():
        R = im.qvec2rotmat()
        np.testing.assert_allclose(R, j_colmap_utils.qvec2rotmat(im.qvec))
        np.testing.assert_allclose(t_colmap_utils.rotmat2qvec(R),
                                   j_colmap_utils.rotmat2qvec(R), atol=1e-12)


def test_pfm_roundtrip_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    for shape in ((5, 7), (5, 7, 3)):
        img = rng.random(shape).astype(np.float32)
        t_depth.write_pfm(str(tmp_path / "a.pfm"), img, scale=2)
        j_depth.write_pfm(str(tmp_path / "b.pfm"), img, scale=2)
        with open(tmp_path / "a.pfm", "rb") as a, \
                open(tmp_path / "b.pfm", "rb") as b:
            assert a.read() == b.read()
        got, s = t_depth.read_pfm(str(tmp_path / "b.pfm"))
        want, s_j = j_depth.read_pfm(str(tmp_path / "b.pfm"))
        np.testing.assert_array_equal(got, want)
        assert s == s_j == 2


def test_registry_and_unported_datasets():
    """Every dataset of the CLI's choices is ported (rtmv since it reads
    prepare_rtmv's PNGs); an unknown name is refused."""
    from arnerf_tpu_torch.opt import get_opts
    names = ("synthetic", "nerf", "nsvf", "colmap", "nerfpp", "rtmv",
             "colmap_exr", "colmap_real_exr", "myblender")
    for name in names:
        assert t_datasets.unported_reason(name) is None
        assert get_opts(["--dataset_name", name]).dataset_name == name
    assert set(t_datasets.dataset_dict) == set(names)
    reason = t_datasets.unported_reason("bogus")
    assert "'bogus'" in reason and "no such dataset" in reason
