"""Shadow fields: SH-visibility volumes around an occluder, fetched at
receiver points to darken the scene (port of
arnerf_tpu/insert/shadow_fields.py; reference insert/shadow_fields.py).

The sphere-occluder "simplify" field is analytic (closed-form zonal
harmonics of a spherical cap rotated toward the occluder), as in the JAX
package. `grid_sample_3d` / `grid_sample_2d` are explicit gathers with the
JAX package's border clamp and corner conventions.
"""

import math

import numpy as np
import torch

from .sh_math import sh9_basis, sh_product0


def _to_pix(x, size, align_corners):
    if align_corners:
        return (x + 1.0) / 2.0 * (size - 1)
    return ((x + 1.0) * size - 1.0) / 2.0


def grid_sample_3d(vol, pts, align_corners=True):
    """Trilinear volume fetch with border clamp: vol (C, D, H, W); pts
    (n, 3) in [-1, 1] ordered (x->W, y->H, z->D). Returns (n, C)."""
    C, D, H, W = vol.shape
    gx = _to_pix(pts[:, 0], W, align_corners)
    gy = _to_pix(pts[:, 1], H, align_corners)
    gz = _to_pix(pts[:, 2], D, align_corners)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    z0 = torch.floor(gz).to(torch.int64)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    fz = (gz - z0)[:, None]

    def fetch(iz, iy, ix):
        return vol[:, torch.clamp(iz, 0, D - 1), torch.clamp(iy, 0, H - 1),
                   torch.clamp(ix, 0, W - 1)].T                 # (n, C)

    out = 0.0
    for dz in (0, 1):
        wz = fz if dz else 1 - fz
        for dy in (0, 1):
            wy = fy if dy else 1 - fy
            for dx in (0, 1):
                wx = fx if dx else 1 - fx
                out = out + wz * wy * wx * fetch(z0 + dz, y0 + dy, x0 + dx)
    return out


def grid_sample_2d(img, pts, align_corners=False):
    """Bilinear fetch, border clamp. img (C, H, W); pts (n, 2) as (x, y).
    Returns (n, C)."""
    C, H, W = img.shape
    gx = _to_pix(pts[:, 0], W, align_corners)
    gy = _to_pix(pts[:, 1], H, align_corners)
    x0 = torch.floor(gx).to(torch.int64)
    y0 = torch.floor(gy).to(torch.int64)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]

    def fetch(iy, ix):
        return img[:, torch.clamp(iy, 0, H - 1), torch.clamp(ix, 0, W - 1)].T

    return ((1 - fx) * (1 - fy) * fetch(y0, x0)
            + fx * (1 - fy) * fetch(y0, x0 + 1)
            + (1 - fx) * fy * fetch(y0 + 1, x0)
            + fx * fy * fetch(y0 + 1, x0 + 1))


def sphere_occlusion_sh9(pts):
    """SH9 of the visibility of a unit sphere at the origin seen from
    `pts` (n, 3), numpy: 0 inside the occlusion cone toward -p of
    half-angle asin(1/|p|), else 1."""
    pts = np.asarray(pts, np.float64)
    d = np.linalg.norm(pts, axis=-1)
    inside = d <= 1.0
    sin_a = 1.0 / np.maximum(d, 1.0 + 1e-9)
    t = np.sqrt(1.0 - sin_a ** 2)               # cos of the cap half-angle
    # zonal SH of a polar cap: c_l = 2 pi N_l int_t^1 P_l(x) dx
    caps = (2 * math.pi * math.sqrt(1 / (4 * math.pi)) * (1.0 - t),
            2 * math.pi * math.sqrt(3 / (4 * math.pi)) * 0.5 * (1.0 - t ** 2),
            2 * math.pi * math.sqrt(5 / (4 * math.pi)) * 0.5 * (t - t ** 3))
    axis = -pts / np.maximum(d, 1e-12)[:, None]
    Y = sh9_basis(torch.as_tensor(axis, dtype=torch.float32)).numpy()
    band = (0, 1, 1, 1, 2, 2, 2, 2, 2)
    sh = np.zeros((len(pts), 9))
    for col, l in enumerate(band):
        # visibility = 1 - cap(axis); rotated band-l coefficient
        # c_l * sqrt(4 pi / (2l + 1)) * Y_lm(axis); 1 is sqrt(4 pi) in DC
        sh[:, col] = -caps[l] * math.sqrt(4 * math.pi / (2 * l + 1)) \
            * Y[:, col]
    sh[:, 0] += math.sqrt(4 * math.pi)
    sh[inside] = 0.0  # inside the occluder: fully shadowed
    return sh.astype(np.float32)


class SimplifySF:
    """Analytic sphere-occluder shadow field on a procedural grid
    (replaces the reference's shipped sf.tar; shadow_fields.py:86-106)."""

    def __init__(self, sh_coeff_num=9, grid=48, device="cpu"):
        self.vol_range = 6
        self.sh_coeff_num = sh_coeff_num
        xs = np.linspace(-self.vol_range, self.vol_range, grid)
        X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
        pts = np.stack([X, Y, Z], -1).reshape(-1, 3)
        sh = sphere_occlusion_sh9(pts).reshape(grid, grid, grid, 9)
        # (C, D, H, W) with xyz -> WHD, the reference's permute(3, 2, 1, 0)
        self.sf_vol = torch.as_tensor(np.transpose(sh, (3, 2, 1, 0)).copy(),
                                      device=device)

    def fetch_sh(self, scale, pts):
        return grid_sample_3d(self.sf_vol, pts / scale / self.vol_range,
                              align_corners=True)


class ComplexSF(SimplifySF):
    """Mesh-specific shadow-field volume from the viewer's export (reference
    shadow_fields.py:108-127; .txt, .npz or the torch .tar)."""

    def __init__(self, sh_path, sh_coeff_num=9, device="cpu"):
        self.vol_range = 4
        self.sh_coeff_num = sh_coeff_num
        self.sf_vol = torch.as_tensor(load_sf_volume(sh_path, sh_coeff_num),
                                      device=device)


def load_sf_volume(path, sh_coeff_num=9):
    """A (C, D, H, W) SF volume from .txt / .npz / torch .tar (reference
    transform_sf_txt_to_torch, shadow_fields.py:44-47)."""
    if path.endswith(".txt"):
        arr = np.loadtxt(path).reshape(30, 30, 30, -1)
        return np.transpose(arr, (3, 2, 1, 0)).astype(np.float32)
    if path.endswith(".npz"):
        return np.load(path)["sf"].astype(np.float32)
    t = torch.load(path, map_location="cpu")
    arr = np.asarray(t.numpy() if torch.is_tensor(t) else t, np.float32)
    return arr[0] if arr.ndim == 5 else arr    # leading batch dim


def transform_sf_txt(path_sh, save_path):
    """Convert the viewer's .txt SF export to .npz."""
    arr = np.loadtxt(path_sh).reshape(30, 30, 30, -1)
    np.savez(save_path, sf=np.transpose(arr, (3, 2, 1, 0)).astype(np.float32))


def soft_shadow_map(sfer, model_pos, model_r, model_sh9, pts, rot_inv=None):
    """Shadow factor at receiver points: the occluder's visibility SH at
    each point, SH-multiplied with the light SH, DC irradiance against the
    unoccluded one (reference shadow_fields.py:56-83). Returns (x,) in
    [0, 1]."""
    m2pts = pts - model_pos[None, :]
    if rot_inv is not None:
        m2pts = (rot_inv @ m2pts.T).T
    pts_sh9 = sfer.fetch_sh(model_r, m2pts)                     # (x, 9)
    psh = sh_product0(
        pts_sh9[:, None, :].expand(pts.shape[0], 3, sfer.sh_coeff_num),
        model_sh9.permute(0, 2, 1))                             # (x, 3, 1)
    old_ir = model_sh9[:, 0, :]                                 # (1, 3)
    res = torch.mean(torch.clamp(psh[..., 0] / old_ir, 0.0, 1.0), dim=-1)
    return torch.pow(res, 10)  # shadow-contrast boost (reference :81)
