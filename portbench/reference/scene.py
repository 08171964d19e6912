"""The benchmark's inputs: the procedural analytic scene, its cameras and its
ground-truth images, in plain PyTorch.

The scene is a frozen copy of the port's procedural scene (a sphere, a box
and a thin ground slab with a smooth albedo), so the images a cell trains
on and the occupancy mask a view marches through never change with the
program. Nothing here draws from the seed: every seed sees the same scene,
cameras and sizes.
"""

import math

import numpy as np
import torch

# the trainer's occupancy threshold, 0.01 * MAX_SAMPLES / sqrt(3)
DENSITY_THRESHOLD = 0.01 * 1024 / math.sqrt(3.0)


def analytic_sigma(x, scale: float, object_only: bool = False):
    """Density at world points x (..., 3): a solid sphere, a box and (unless
    object_only) a ground slab y in [0.55s, 0.62s], each a sigmoid of its
    signed distance, up to 90 / scale."""
    s = scale
    c_sph = torch.tensor([0.0, 0.1 * s, 0.0], dtype=x.dtype, device=x.device)
    d_sph = torch.linalg.norm(x - c_sph, dim=-1) - 0.36 * s
    c_box = torch.tensor([-0.45 * s, -0.3 * s, 0.3 * s], dtype=x.dtype,
                         device=x.device)
    q = torch.abs(x - c_box) - 0.18 * s
    d_box = torch.linalg.norm(torch.clamp(q, min=0), dim=-1) + \
        torch.clamp(torch.amax(q, dim=-1), max=0.0)
    d = torch.minimum(d_sph, d_box)
    if not object_only:
        d = torch.minimum(d, torch.abs(x[..., 1] - 0.585 * s) - 0.035 * s)
    return 90.0 / scale * torch.sigmoid(-d / (0.01 * s))


def analytic_rgb(x, scale: float):
    """Albedo in [0.05, 0.95] at world points x (..., 3)."""
    p = x / scale
    r = 0.5 + 0.45 * torch.sin(6.0 * p[..., 0] + 2.0 * p[..., 2])
    g = 0.5 + 0.45 * torch.cos(5.0 * p[..., 1] - 1.0)
    b = 0.5 + 0.45 * torch.sin(4.0 * (p[..., 0] + p[..., 1] + p[..., 2]))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.05, 0.95)


def aabb_hits(rays_o, rays_d, scale: float):
    """Slab test against [-scale, scale]^3: (t1, t2), both -1 on a miss and
    t1 clamped to >= 0."""
    inv = 1.0 / rays_d
    lo = (-scale - rays_o) * inv
    hi = (scale - rays_o) * inv
    t1 = torch.amax(torch.minimum(lo, hi), dim=-1)
    t2 = torch.amin(torch.maximum(lo, hi), dim=-1)
    hit = (t1 <= t2) & (t2 > 0)
    return (torch.where(hit, torch.clamp(t1, min=0.0), -1.0),
            torch.where(hit, t2, -1.0))


@torch.no_grad()
def render_gt(rays_o, rays_d, scale: float, n_samples: int = 512,
              chunk: int = 1 << 16):
    """The analytic field rendered by dense uniform sampling (an oracle that
    shares nothing with the marcher): (N, 3) colours, blended on white for
    bounded scenes (scale <= 0.5) and on black otherwise."""
    out = []
    k = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device)
    for i in range(0, rays_o.shape[0], chunk):
        o = rays_o[i:i + chunk]
        d = rays_d[i:i + chunk]
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        t1, t2 = aabb_hits(o, d, scale)
        t1 = torch.clamp(t1, min=0.0)
        ok = t2 > 0
        dt = (t2 - t1) / n_samples
        ts = t1[:, None] + (k[None, :] + 0.5) * dt[:, None]
        pos = o[:, None, :] + ts[..., None] * d[:, None, :]
        sd = analytic_sigma(pos, scale) * ok[:, None] * dt[:, None]
        w = torch.exp(-(torch.cumsum(sd, dim=1) - sd)) * (1 - torch.exp(-sd))
        rgb = torch.sum(w[..., None] * analytic_rgb(pos, scale), dim=1)
        if scale <= 0.5:
            rgb = rgb + (1.0 - torch.sum(w, dim=1))[:, None]
        out.append(rgb)
    return torch.cat(out)


@torch.no_grad()
def analytic_occupancy(scale: float, grid_size: int, cascades: int,
                       object_only: bool = False, device="cpu"):
    """uint8 (cascades * G^3,) occupancy laid out [c, x, y, z]: 1 where the
    analytic density at the cell centre exceeds DENSITY_THRESHOLD."""
    G = grid_size
    occ = []
    for c in range(cascades):
        bound = min(2.0 ** (c - 1), scale)
        ax = ((torch.arange(G, dtype=torch.float32, device=device) + 0.5)
              / G * 2.0 - 1.0) * bound
        gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
        centres = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
        occ.append(analytic_sigma(centres, scale, object_only)
                   > DENSITY_THRESHOLD)
    return torch.cat(occ).to(torch.uint8)


def intrinsics(w: int, h: int, fov_deg: float):
    """Pinhole K (3, 3) of a w x h image with horizontal field of view."""
    f = 0.5 * w / math.tan(0.5 * math.radians(fov_deg))
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)


def directions(w: int, h: int, K, device):
    """Camera-space [right down front] directions of every pixel centre,
    (h * w, 3), row-major."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    d = torch.stack([(u - float(K[0, 2]) + 0.5) / float(K[0, 0]),
                     (v - float(K[1, 2]) + 0.5) / float(K[1, 1]),
                     torch.ones_like(u)], dim=-1)
    return d.reshape(-1, 3)


def look_at(eye):
    """c2w (3, 4) of a [right down front] camera at `eye` looking at the
    origin, world up +y."""
    eye = np.asarray(eye, np.float64)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def ring_poses(scale: float, n: int, radius_factor: float, phase: float,
               height_seed: int):
    """n cameras on a ring of radius radius_factor * scale around the scene,
    at heights drawn once from the fixed `height_seed` in [-0.9, 0.2] *
    scale: (n, 3, 4)."""
    rng = np.random.default_rng(height_seed)
    rad = radius_factor * scale
    poses = []
    for i in range(n):
        th = 2 * np.pi * (i + phase) / n
        height = rng.uniform(-0.9, 0.2) * scale
        poses.append(look_at([rad * np.cos(th), height, rad * np.sin(th)]))
    return np.stack(poses)


def rays(dirs, pose):
    """World rays (origins, unnormalised directions) of one c2w pose."""
    pose = torch.as_tensor(pose, device=dirs.device)
    d = dirs @ pose[:, :3].T
    return pose[:, 3].expand(d.shape), d
