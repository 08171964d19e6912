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

The scene (`synthetic.py`'s at scale 0.5) is rendered by
`render_analytic` on `device`; PNG rows are filtered with types 0-4 in
rotation, so a reader meets every filter. Both return the uint8 images
written, in file order, so a caller can check what a loader decodes.
"""

import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..image_io import write_png
from .colmap_utils import rotmat2qvec
from .ray_utils import get_ray_directions, get_rays, look_at_pose
from .synthetic import analytic_rgb, analytic_sigma, render_analytic

SCALE = 0.5                     # the analytic scene's half-size
FILTERS = (0, 1, 2, 3, 4)       # PNG filter types, row by row in rotation


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


def _write_all(jobs):
    """Write (path, image) pairs in parallel (zlib and numpy release the
    GIL)."""
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(lambda j: write_png(j[0], j[1], FILTERS), jobs))


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


def write_colmap_capture(root, n_views=64, wh=(1240, 824), focal=1100.0,
                         n_points=4096, n_samples=512, device="cpu"):
    """COLMAP-format capture of the analytic scene on black (see the
    module's docstring): cameras on a ring of radius 1.2 at varying
    heights, looking at the origin. Returns [uint8 (h, w, 3) images] in
    name order."""
    w, h = wh
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    dirs = torch.as_tensor(get_ray_directions(h, w, K), device=device)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(5)
    jobs, poses = [], []
    for i in range(n_views):
        th = 2 * np.pi * i / n_views
        eye = np.array([1.2 * np.cos(th), rng.uniform(-0.72, 0.12),
                        1.2 * np.sin(th)])
        c2w = look_at_pose(eye)
        rgb, _ = _render(c2w, dirs, n_samples)
        jobs.append((os.path.join(root, "images", f"img_{i:03d}.png"),
                     _to_uint8(rgb).reshape(h, w, 3)))
        poses.append(c2w)
    _write_all(jobs)

    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, 1, w, h)
                + struct.pack("<dddd", focal, focal, w / 2, h / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i, c2w in enumerate(poses):
            bottom = np.array([[0, 0, 0, 1.0]])
            w2c = np.linalg.inv(np.concatenate(
                [np.asarray(c2w, np.float64), bottom]))
            f.write(struct.pack("<idddddddi", i + 1,
                                *rotmat2qvec(w2c[:3, :3]), *w2c[:3, 3], 1))
            f.write(f"img_{i:03d}.png".encode() + b"\0"
                    + struct.pack("<Q", 0))
    pts, cols = surface_points(n_points, device)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, (p, c) in enumerate(zip(pts, _to_uint8(cols))):
            f.write(struct.pack("<QdddBBBdQ", i + 1, *p, *c, 0.5, 0))
    return [img for _, img in jobs]
