"""Captures of the procedural scene written to disk in the reference's file
formats, for runs of the file loaders without a downloaded dataset.

* `write_blender_capture`: a Blender-format (`nerf`) scene, as the NeRF
  synthetic scenes ship: `transforms_{train,test}.json` and RGBA PNGs whose
  alpha is the rendered opacity, cameras on a sphere of radius 1.5 looking
  at the origin (tests/test_blender_fixture_e2e.py's layout).
* `write_colmap_capture`: a COLMAP-format (`colmap`) scene, as mip-NeRF 360
  ships: `sparse/0/{cameras,images,points3D}.bin` (one PINHOLE camera, the
  views' world-to-camera poses, points sampled on the analytic surface) and
  3-channel PNGs of the scene on black, the unbounded convention.
* `write_colmap_exr_capture`: the same cameras as a `colmap_exr` scene: the
  reference's `train_r_<i>_<k>.png` names in images.bin and the frames as
  `train_hdr/hdr_<i>.exr`: HDR radiance, the scene's times HDR_GAIN (so
  that a share of the pixels exceeds 1) in front of a background of
  radiance 1, which the bounded defaults (--scale 0.5) train against.
* `write_myblender_capture`: a `myblender` scene: `int.txt`, `exts.npy`
  (world-to-camera) and `img/*.exr` of the same HDR radiance.
* `write_hdr_nerf_capture`: HDR-NeRF's synthetic layout for `colmap` with
  exposures (`HDR-NeRF/syndata/<scene>/`): 35 views, LDR PNGs of that HDR
  radiance at the scene's five exposures through a gamma camera curve.
* `write_rtmv_capture`: an RTMV scene as it ships, before
  `python -m arnerf_tpu_torch.prepare_rtmv`: `NNNNN.json` (`camera_data`)
  and `NNNNN.exr` frames of linear radiance over a background of 1.

The scene (`synthetic.py`'s at scale 0.5) is rendered by
`render_analytic` on `device`; PNG rows are filtered with types 0-4 in
rotation, so a reader meets every filter; OpenEXR files are written with
image_io.write_exr (HALF, ZIP). Each returns the images written (uint8
PNG pixels, or the float32 radiance before HALF rounding), in file order,
so a caller can check what a loader decodes.
"""

import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..image_io import write_exr, write_png
from .colmap import _EXPOSURES
from .colmap_utils import rotmat2qvec
from .ray_utils import get_ray_directions, get_rays, look_at_pose
from .synthetic import analytic_rgb, analytic_sigma, render_analytic

SCALE = 0.5                     # the analytic scene's half-size
FILTERS = (0, 1, 2, 3, 4)       # PNG filter types, row by row in rotation
HDR_GAIN = 4.0                  # radiance scale of the HDR captures
HDR_NERF_SCENE = "bathroom"     # exposures 1/8 * 4^k (datasets/colmap.py)


def _render(pose, dirs, n_samples, chunk=1 << 16):
    """(H*W, 3) premultiplied rgb on black and (H*W,) opacity, float64."""
    ro, rd = get_rays(dirs, torch.as_tensor(pose, device=dirs.device))
    rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rgb, opa = [], []
    for i in range(0, len(dirs), chunk):
        c, o, _ = render_analytic(ro[i:i + chunk], rd[i:i + chunk], SCALE,
                                  n_samples=n_samples, white_bg=False)
        rgb.append(c.double().cpu())
        opa.append(o.double().cpu())
    return torch.cat(rgb).numpy(), torch.cat(opa).numpy()


def _to_uint8(x):
    return np.round(np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def _write_all(jobs, exr=False):
    """Write (path, image) pairs in parallel (zlib and numpy release the
    GIL): PNGs, or OpenEXR files if `exr`."""
    def one(job):
        if exr:
            write_exr(*job)
        else:
            write_png(job[0], job[1], FILTERS)

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(one, jobs))


def write_blender_capture(root, n_train=100, n_test=8, wh=800,
                          n_samples=512, device="cpu"):
    """Blender-format capture of the analytic scene (see the module's
    docstring): a 45-degree field of view, cameras at radius 1.5. Returns
    {split: [uint8 (wh, wh, 4) images]}."""
    cax = float(np.deg2rad(45.0))
    f = 0.5 * wh / np.tan(0.5 * cax)
    K = np.array([[f, 0, wh / 2], [0, f, wh / 2], [0, 0, 1]], np.float32)
    dirs = torch.as_tensor(get_ray_directions(wh, wh, K), device=device)
    rng = np.random.default_rng(3)
    written = {}
    for split, n, phase in (("train", n_train, 0.0), ("test", n_test, 0.5)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames, jobs = [], []
        for i in range(n):
            th = 2 * np.pi * (i + phase) / n
            phi = rng.uniform(-0.35, 0.08)             # elevation
            # every camera at the same radius: the loader rescales each pose
            # by its own norm / 1.5 (datasets/nerf.py)
            eye = 1.5 * np.array([np.cos(th) * np.cos(phi), np.sin(phi),
                                  np.sin(th) * np.cos(phi)])
            c2w = look_at_pose(eye)                    # [right down front]
            rgb, opa = _render(c2w, dirs, n_samples)
            color = rgb / np.maximum(opa, 1e-12)[:, None]
            img = np.concatenate([_to_uint8(color), _to_uint8(opa)[:, None]],
                                 1).reshape(wh, wh, 4)
            jobs.append((os.path.join(root, split, f"r_{i}.png"), img))
            blender = np.asarray(c2w, np.float64).copy()
            blender[:, 1:3] *= -1                      # [right up back]
            mat = np.eye(4)
            mat[:3] = blender
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": mat.tolist()})
        _write_all(jobs)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fj:
            json.dump({"camera_angle_x": cax, "frames": frames}, fj)
        written[split] = [img for _, img in jobs]
    return written


def surface_points(n, device="cpu"):
    """Up to n points near the analytic surface (density between 20 % and
    80 % of its peak) with their albedo, as COLMAP's sparse points stand in
    for the scene's surfaces."""
    g = torch.Generator(device=device).manual_seed(5)
    peak = 90.0 / SCALE
    pts, cols = [], []
    for _ in range(64):
        x = (torch.rand((1 << 18, 3), generator=g, device=device) * 2 - 1) \
            * SCALE
        s = analytic_sigma(x, SCALE) / peak
        keep = (s > 0.2) & (s < 0.8)
        pts.append(x[keep])
        cols.append(analytic_rgb(x[keep], SCALE))
        if sum(len(p) for p in pts) >= n:
            break
    return (torch.cat(pts)[:n].double().cpu().numpy(),
            torch.cat(cols)[:n].cpu().numpy())


def _ring_views(n_views, wh, focal, n_samples, device, seed=5):
    """Cameras on a ring of radius 1.2 at varying heights looking at the
    origin, and their renders: (K, [c2w], [(h, w, 3) float64 radiance on
    black], [(h, w, 1) opacity])."""
    w, h = wh
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    dirs = torch.as_tensor(get_ray_directions(h, w, K), device=device)
    rng = np.random.default_rng(seed)
    poses, images, opacity = [], [], []
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = np.array([1.2 * np.cos(th), rng.uniform(-0.72, 0.12),
                        1.2 * np.sin(th)])
        c2w = look_at_pose(eye)
        rgb, opa = _render(c2w, dirs, n_samples)
        poses.append(c2w)
        images.append(rgb.reshape(h, w, 3))
        opacity.append(opa.reshape(h, w, 1))
    return K, poses, images, opacity


def _hdr(images, opacity):
    """HDR radiance: the scene's times HDR_GAIN over a background of
    radiance 1, float32."""
    return [(rgb * HDR_GAIN + (1 - opa)).astype(np.float32)
            for rgb, opa in zip(images, opacity)]


def _write_sparse(root, names, poses, wh, focal, n_points, device):
    """sparse/0/{cameras,images,points3D}.bin: one PINHOLE camera, the
    views' world-to-camera poses under `names`, points on the surface."""
    w, h = wh
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, w, h)
                + struct.pack("<dddd", focal, focal, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (name, c2w) in enumerate(zip(names, poses)):
            bottom = np.array([[0, 0, 0, 1.0]])
            w2c = np.linalg.inv(np.concatenate(
                [np.asarray(c2w, np.float64), bottom]))
            f.write(struct.pack("<idddddddi", i + 1,
                                *rotmat2qvec(w2c[:3, :3]), *w2c[:3, 3], 1))
            f.write(name.encode() + b"\0" + struct.pack("<Q", 0))
    pts, cols = surface_points(n_points, device)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, (p, c) in enumerate(zip(pts, _to_uint8(cols))):
            f.write(struct.pack("<QdddBBBdQ", i + 1, *p, *c, 0.5, 0))


def write_colmap_capture(root, n_views=64, wh=(1240, 824), focal=1100.0,
                         n_points=4096, n_samples=512, device="cpu"):
    """COLMAP-format capture of the analytic scene on black (see the
    module's docstring): cameras on a ring of radius 1.2 at varying
    heights, looking at the origin. Returns [uint8 (h, w, 3) images] in
    name order."""
    _, poses, images, _ = _ring_views(n_views, wh, focal, n_samples, device)
    names = [f"img_{i:03d}.png" for i in range(n_views)]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    jobs = [(os.path.join(root, "images", n), _to_uint8(img))
            for n, img in zip(names, images)]
    _write_all(jobs)
    _write_sparse(root, names, poses, wh, focal, n_points, device)
    return [img for _, img in jobs]


def write_colmap_exr_capture(root, n_views=64, wh=(800, 600), focal=700.0,
                             n_points=4096, n_samples=512, device="cpu"):
    """`colmap_exr` capture: write_colmap_capture's cameras with the
    reference's names (train_r_<i>_0.png in images.bin, the frames as
    train_hdr/hdr_<i>.exr) and HDR radiance (`_hdr`). Returns [float32
    (h, w, 3) radiance] in name order."""
    _, poses, images, opacity = _ring_views(n_views, wh, focal, n_samples,
                                            device)
    os.makedirs(os.path.join(root, "train_hdr"), exist_ok=True)
    jobs = [(os.path.join(root, "train_hdr", f"hdr_{i:03d}.exr"), img)
            for i, img in enumerate(_hdr(images, opacity))]
    _write_all(jobs, exr=True)
    _write_sparse(root, [f"train_r_{i}_0.png" for i in range(n_views)],
                  poses, wh, focal, n_points, device)
    return [img for _, img in jobs]


def write_myblender_capture(root, n_views=32, wh=(400, 300), focal=350.0,
                            n_samples=512, device="cpu"):
    """`myblender` capture: int.txt (K; the loader takes the image size as
    twice the principal point), exts.npy ((n, 3, 4) world-to-camera) and
    img/<i>.exr of HDR radiance (`_hdr`). Returns [float32 (h, w, 3)
    radiance] in file order."""
    K, poses, images, opacity = _ring_views(n_views, wh, focal, n_samples,
                                            device, seed=6)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    np.savetxt(os.path.join(root, "int.txt"), K)
    np.save(os.path.join(root, "exts.npy"), np.stack(
        [np.linalg.inv(np.concatenate([c2w, [[0, 0, 0, 1.0]]]))[:3]
         for c2w in poses]))
    jobs = [(os.path.join(root, "img", f"{i:03d}.exr"), img)
            for i, img in enumerate(_hdr(images, opacity))]
    _write_all(jobs, exr=True)
    return [img for _, img in jobs]


def write_hdr_nerf_capture(parent, wh=(400, 400), focal=350.0,
                           n_points=4096, n_samples=512, device="cpu"):
    """HDR-NeRF's synthetic layout under parent/HDR-NeRF/syndata/<scene>
    (the colmap loader's `_hdr_nerf_split`): 35 views, the first 17 the
    test views (exposures 1 and 3), the last 18 the training views
    (exposures 0, 2 and 4), as `<view>_<k>.png`: HDR radiance (`_hdr`)
    times the scene's k-th exposure through a gamma-2.2 camera curve,
    clipped. Returns
    the root, as an absolute path, and {split: [uint8 images]} in file
    order. The loader reads a file's exposure index as the last character
    before the path's first '.', so the path must hold no other '.'."""
    root = os.path.join(os.path.abspath(parent), "HDR-NeRF", "syndata",
                        HDR_NERF_SCENE)
    _, poses, images, opacity = _ring_views(35, wh, focal, n_samples,
                                            device, seed=7)
    exposures = _EXPOSURES[HDR_NERF_SCENE]
    jobs = {"test": [], "train": []}
    for i, img in enumerate(_hdr(images, opacity)):
        split, ks = ("test", (1, 3)) if i < 17 else ("train", (0, 2, 4))
        for k in ks:
            jobs[split].append((
                os.path.join(root, split, f"{i:03d}_{k}.png"),
                _to_uint8((img * exposures[k]) ** (1 / 2.2))))
    for split in jobs:
        os.makedirs(os.path.join(root, split), exist_ok=True)
        _write_all(jobs[split])
    _write_sparse(root, [f"{i:03d}.png" for i in range(35)], poses, wh,
                  focal, n_points, device)
    return root, {k: [img for _, img in v] for k, v in jobs.items()}


RTMV_BOX_CENTER = (0.1, -0.2, 0.3)     # scene_center_3d_box of the capture


def write_rtmv_capture(root, n_frames=110, wh=(8, 8), focal=10.0,
                       n_samples=64, device="cpu"):
    """An RTMV scene of the analytic scene: frame i is `{i:05d}.json`
    (`camera_data`: `cam2world` as RTMV stores it, transposed, in OpenGL
    axes; `intrinsics`, `width`, `height` and the scene box, a unit cube
    centred at RTMV_BOX_CENTER) and `{i:05d}.exr` (HALF, ZIP), write_colmap
    capture's ring cameras. In a root whose path holds 'bricks' the loader
    re-centres and rescales the poses by the box, so the file's
    translations are scaled the other way: the loader gives back the
    cameras rendered either way. The default 110 frames leave 5 in the
    test split (105-150). Returns [float32 (h, w, 3) radiance]."""
    w, h = wh
    K, poses, images, opacity = _ring_views(n_frames, wh, focal, n_samples,
                                            device, seed=8)
    center = np.array(RTMV_BOX_CENTER)
    scale = 0.5 * 1.05                   # the loader's box half-size x 1.05
    os.makedirs(root, exist_ok=True)
    jobs = []
    for i, (c2w, rgb, opa) in enumerate(zip(poses, images, opacity)):
        c2w = np.array(c2w, np.float64)
        if "bricks" in root:
            c2w[:, 3] = c2w[:, 3] * 2 * scale + center
        c2w[:, 1:3] *= -1                # -> OpenGL axes
        cam2world = np.concatenate([c2w, [[0, 0, 0, 1.0]]]).T
        meta = {"camera_data": {
            "cam2world": cam2world.tolist(),
            "intrinsics": {"fx": float(K[0, 0]), "fy": float(K[1, 1]),
                           "cx": float(K[0, 2]), "cy": float(K[1, 2])},
            "width": w, "height": h,
            "scene_center_3d_box": center.tolist(),
            "scene_min_3d_box": (center - 0.5).tolist(),
            "scene_max_3d_box": (center + 0.5).tolist()}}
        with open(os.path.join(root, f"{i:05d}.json"), "w") as f:
            json.dump(meta, f)
        jobs.append((os.path.join(root, f"{i:05d}.exr"),
                     (rgb + (1 - opa)).astype(np.float32)))
    _write_all(jobs, exr=True)
    return [img for _, img in jobs]
