"""Procedural analytic scene + renderer: dataset-free ground truth (port of
arnerf_tpu/datasets/synthetic.py).

The analytic density / albedo field is rendered with dense uniform sampling
(no occupancy grid), an oracle independent of the marching/compositing
path. `analytic_occupancy` thresholds the same density at the occupancy
grid's cell centres, which gives a render a carved grid without training;
`bake_analytic_field` bakes the field into a BakedField the same way.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .base import BaseDataset
from .ray_utils import get_ray_directions, get_rays, look_at_pose

# the trainer's occupancy threshold: 0.01 * MAX_SAMPLES / sqrt(3)
DENSITY_THRESHOLD = 0.01 * 1024 / (3 ** 0.5)


def analytic_sigma(x, scale: float, object_only: bool = False):
    """Density: a solid sphere, a box, and a thin slab — sharp but smooth.
    x: (..., 3) world coords. Returns (...,). object_only drops the ground
    slab, leaving just the sphere + box (~3% of the cube volume)."""
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
        # ground slab y in [0.55s, 0.62s]
        d_slab = torch.abs(x[..., 1] - 0.585 * s) - 0.035 * s
        d = torch.minimum(d, d_slab)
    return 90.0 / scale * torch.sigmoid(-d / (0.01 * s))


def analytic_rgb(x, scale: float):
    """Smooth position-dependent albedo in [0.05, 0.95]."""
    p = x / scale
    r = 0.5 + 0.45 * torch.sin(6.0 * p[..., 0] + 2.0 * p[..., 2])
    g = 0.5 + 0.45 * torch.cos(5.0 * p[..., 1] - 1.0)
    b = 0.5 + 0.45 * torch.sin(4.0 * (p[..., 0] + p[..., 1] + p[..., 2]))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.05, 0.95)


@torch.no_grad()
def render_analytic(rays_o, rays_d, scale: float, n_samples: int = 512,
                    white_bg: bool = True, object_only: bool = False):
    """Dense uniform-sampling oracle renderer of the analytic field."""
    from ..ops.intersection import ray_aabb_intersect_single
    hits = ray_aabb_intersect_single(rays_o, rays_d, torch.zeros(3),
                                     torch.full((3,), scale))
    t1 = torch.clamp(hits[:, 0], min=0.0)
    t2 = hits[:, 1]
    ok = t2 > 0
    dt = (t2 - t1) / n_samples
    k = torch.arange(n_samples, dtype=torch.float32,
                     device=rays_o.device)[None, :]
    ts = t1[:, None] + (k + 0.5) * dt[:, None]
    pos = rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]
    sig = analytic_sigma(pos, scale, object_only) * ok[:, None]
    col = analytic_rgb(pos, scale)
    sd = sig * dt[:, None]
    T = torch.exp(-(torch.cumsum(sd, dim=1) - sd))
    w = T * (1 - torch.exp(-sd))
    rgb = torch.sum(w[..., None] * col, dim=1)
    opa = torch.sum(w, dim=1)
    depth = torch.sum(w * ts, dim=1)
    if white_bg:
        rgb = rgb + (1.0 - opa[:, None])
    return rgb, opa, depth


@torch.no_grad()
def analytic_occupancy(scale: float, grid_size: int, cascades: int,
                       threshold: float = DENSITY_THRESHOLD,
                       object_only: bool = False, device="cpu"):
    """uint8 (cascades*G^3,) occupancy, laid out [c, x, y, z]: 1 where the
    analytic density at the cell centre exceeds `threshold`."""
    G = grid_size
    occ = []
    for c in range(cascades):
        bound = min(2.0 ** (c - 1), scale)
        ax = ((torch.arange(G, dtype=torch.float32, device=device) + 0.5)
              / G * 2.0 - 1.0) * bound
        gx, gy, gz = torch.meshgrid(ax, ax, ax, indexing="ij")
        centres = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
        occ.append(analytic_sigma(centres, scale, object_only) > threshold)
    return torch.cat(occ).to(torch.uint8)


@torch.no_grad()
def bake_analytic_field(scale: float = 0.5, resolution: int = 256,
                        object_only: bool = True, n_dirs: int = 16,
                        sigma_thresh: float = 1e-2, device="cuda", **bake_kw):
    """Bake the analytic field into a BakedField directly (no training) on
    `device`, through the production bake (rendering_baked.bake_field).

    The renderer's speed under Lego-like ray statistics (the object-only
    scene fills ~3% of the cube; most rays die at the tight AABB or in the
    mip prelude), decoupled from a training run: the JAX bench's baked
    object frame. The occupancy mask keeps every voxel whose analytic
    sigma at its centre clears `sigma_thresh` (the sigmoid edge is
    ~0.01*scale wide, so the threshold reaches ~9 edge-widths out at
    sigma_max=180); the centres are evaluated on the device in chunks of
    2^20. The analytic field stands in for the network, so no fused head
    runs: its launch counter does not move. bake_kw takes bake_field's
    keywords (chunk, stoch, quantize_colors). With no GPU and no
    device="cpu" it raises, as the entry points do."""
    from ..device import resolve_device
    from ..rendering_baked import bake_field
    dev = resolve_device(str(device))
    B = resolution
    ax = (torch.arange(B, dtype=torch.float32, device=dev) + 0.5) / B \
        * 2 * scale - scale
    occ = []
    chunk = 1 << 20
    for i in range(0, B ** 3, chunk):
        # z-fastest layout to match bake_field's row indexing
        v = torch.arange(i, min(i + chunk, B ** 3), device=dev)
        centres = torch.stack([ax[v // (B * B)], ax[v // B % B], ax[v % B]],
                              dim=-1)
        occ.append(analytic_sigma(centres, scale, object_only)
                   > sigma_thresh)
    occ_mask = torch.cat(occ).cpu().numpy()

    def field_fn(xyz, dirs, *seed):
        return (analytic_sigma(xyz, scale, object_only),
                analytic_rgb(xyz, scale))

    return bake_field(field_fn, scale, resolution=B, occ_mask=occ_mask,
                      n_dirs=n_dirs, device=dev, **bake_kw)


@dataclass
class SyntheticConfig:
    scale: float = 0.5
    img_wh: tuple = (128, 128)
    n_train: int = 24
    n_test: int = 4
    cam_radius_factor: float = 2.4   # camera ring radius = factor * scale
    fov_deg: float = 45.0
    gt_samples: int = 512


class SyntheticDataset(BaseDataset):
    """Procedural dataset, API-compatible with the file-based loaders.
    Poses and directions match the JAX package's for the same config; the
    ground truth is rendered on `device`."""

    def __init__(self, root_dir="", split="train", downsample=1.0,
                 config: SyntheticConfig = None, device="cpu", **kwargs):
        super().__init__(root_dir, split, downsample)
        self.config = cfg = config or SyntheticConfig()
        w, h = cfg.img_wh
        w = int(w * downsample)
        h = int(h * downsample)
        self.img_wh = (w, h)
        f = 0.5 * w / np.tan(0.5 * np.deg2rad(cfg.fov_deg))
        self.K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                          np.float32)
        self.directions = get_ray_directions(h, w, self.K)
        self.scale = cfg.scale

        n = cfg.n_train if split.startswith("train") else cfg.n_test
        phase = 0.0 if split.startswith("train") else 0.5
        rad = cfg.cam_radius_factor * cfg.scale
        poses = []
        rng = np.random.default_rng(7 if split.startswith("train") else 11)
        for i in range(n):
            th = 2 * np.pi * (i + phase) / n
            height = rng.uniform(-0.9, 0.2) * cfg.scale
            eye = np.array([rad * np.cos(th), height, rad * np.sin(th)])
            poses.append(look_at_pose(eye))
        self.poses = np.stack(poses).astype(np.float32)

        if kwargs.get("read_meta", True):
            self.rays = self._render_gt(torch.device(device))

    def _render_gt(self, device, chunk=1 << 16):
        cfg = self.config
        imgs = []
        dirs = torch.as_tensor(self.directions, device=device)
        n = dirs.shape[0]
        for pose in self.poses:
            ro, rd = get_rays(dirs, torch.as_tensor(pose, device=device))
            rd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            parts = []
            for i in range(0, n, chunk):
                # bounded scenes (scale <= 0.5) blend WHITE like the blender
                # datasets; unbounded scenes blend BLACK (see the JAX loader)
                rgb, _, _ = render_analytic(ro[i:i + chunk], rd[i:i + chunk],
                                            cfg.scale,
                                            n_samples=cfg.gt_samples,
                                            white_bg=cfg.scale <= 0.5)
                parts.append(rgb.cpu().numpy().astype(np.float32))
            imgs.append(np.concatenate(parts))
        return np.stack(imgs)  # (N, H*W, 3)
