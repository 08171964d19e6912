"""Real spherical-harmonics (band 0..2, "SH9") math for AR insertion (port
of arnerf_tpu/insert/sh_math.py; reference insert/insert_utils.py).

The basis is the insertion subsystem's own (positive-sign real SH, order
[1, y, z, x, xy, yz, 3z^2-1, xz, x^2-y^2]); it differs from the field's
direction encoding (ops/sh.py), which carries the Condon-Shortley phase.
The SH9 triple-product tensor C_ijk = int Y_i Y_j Y_k dOmega is computed
by Gauss-Legendre x uniform-phi quadrature (exact at this degree).

`get_sphere_rays` draws from a torch.Generator where the JAX package takes
a key; the two give different directions for the same seed.
"""

import numpy as np
import torch


def normalize(v, eps=0.0):
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + eps)


def normalize_eps(v, eps=1e-6):
    return normalize(v, eps)


def sh9_basis(d):
    """d: (..., 3) unit dirs -> (..., 9) basis values
    (reference insert_utils.py:102-127)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        0.2820947918 * torch.ones_like(x),
        0.4886025119 * y,
        0.4886025119 * z,
        0.4886025119 * x,
        1.0925484306 * x * y,
        1.0925484306 * y * z,
        0.3153915653 * (3.0 * z * z - 1.0),
        1.0925484306 * x * z,
        0.5462742153 * (x * x - y * y),
    ], dim=-1)


def sphere_dirs(cos_t, u_phi):
    """Directions from cos(theta) in [-1, 1] and u_phi in [0, 1)."""
    phi = 2.0 * np.pi * u_phi
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], -1)


def get_sphere_rays(generator, probe_num, ray_num, device="cpu"):
    """Uniform sphere directions (probe_num, ray_num, 3), drawn from
    `generator` (on `device`) (reference insert_utils.py:61-70)."""
    u = torch.rand((2, probe_num, ray_num), generator=generator,
                   device=device)
    return sphere_dirs(1.0 - 2.0 * u[0], u[1])


def get_cubemap_rays(probe_num, resolution, keep_raw_dim=False,
                     device="cpu"):
    """Normalized cubemap directions, face order [+z, -z, +x, -x, +y, -y]
    (reference insert_utils.py:83-100). Returns (6, r, r, 3) if
    keep_raw_dim else (probe_num, 6*r*r, 3)."""
    x = np.linspace(0, 1, resolution) * 2 - 1
    X, Y = np.meshgrid(x, x, indexing="ij")
    X, Y = X[..., None], Y[..., None]
    ones = np.ones_like(X)
    faces = np.stack([
        np.concatenate([X, Y, ones], -1),    # +z (front)
        np.concatenate([X, Y, -ones], -1),   # -z (back)
        np.concatenate([ones, X, Y], -1),    # +x
        np.concatenate([-ones, X, Y], -1),   # -x
        np.concatenate([X, ones, Y], -1),    # +y
        np.concatenate([X, -ones, Y], -1),   # -y
    ], axis=0)
    faces = faces / np.linalg.norm(faces, axis=-1, keepdims=True)
    dirs = torch.as_tensor(faces, dtype=torch.float32, device=device)
    if keep_raw_dim:
        return dirs
    flat = dirs.reshape(1, -1, 3)
    return flat.expand(probe_num, flat.shape[1], 3)


def get_sh_coeff(rays_d, rays_rgb):
    """Monte-Carlo SH projection (reference insert_utils.py:132-136).
    rays_d, rays_rgb: (probe, n, 3) -> (probe, 9, 3)."""
    Y = sh9_basis(rays_d)                                  # (p, n, 9)
    coeff = torch.einsum("pnc,pnd->pcd", Y, rays_rgb)      # (p, 9, 3)
    return coeff * (4.0 * np.pi / rays_d.shape[1])


def get_sh_val(shec, dirs, clamp_positive=False):
    """Evaluate SH (9, 3) [or per-ray (n, 9, 3)] at dirs (n, 3) -> (n, 3)
    (reference insert_utils.py:142-147)."""
    Y = sh9_basis(dirs)                                    # (n, 9)
    if shec.ndim == 2:
        vals = Y @ shec
    else:
        vals = torch.einsum("nc,ncd->nd", Y, shec)
    return torch.relu(vals) if clamp_positive else vals


def sh_product0(shec1, shec2):
    """DC term of the SH triple product (reference insert_utils.py:153-154)."""
    return 0.2821 * torch.sum(shec1 * shec2, dim=-1, keepdim=True)


def get_sh_main_direction(shec):
    """Dominant light direction from the linear band, luminance-weighted
    (reference insert_utils.py:157-162). shec: (x, 9, 3) -> (x, 3)."""
    dirc = torch.stack([shec[:, 3], shec[:, 1], shec[:, 2]], dim=-2)
    lum = torch.tensor([0.3, 0.59, 0.11], device=shec.device)
    return normalize(dirc @ lum)


def rotate_sh_by_recalc(ray_dir, ray_rgb, rot_mat):
    """Rotate an SH light by re-projecting rotated sample rays
    (reference insert_utils.py:171-173)."""
    rd = (rot_mat @ ray_dir.T).T
    return get_sh_coeff(rd[None], ray_rgb[None])


def latlong_dirs(H, W, upper_hemi=False, device="cpu"):
    """(H, W, 3) directions of a lat-long map (reference envfit.py:30-56)."""
    phi_max = np.pi / 2 if upper_hemi else np.pi
    phi, theta = torch.meshgrid(
        torch.linspace(0.0, phi_max, H, device=device),
        torch.linspace(-0.5 * np.pi, 1.5 * np.pi, W, device=device),
        indexing="ij")
    return torch.stack([torch.cos(theta) * torch.sin(phi), torch.cos(phi),
                        torch.sin(theta) * torch.sin(phi)], -1)


def sh2envmap(sh_coeff, H, W, upper_hemi=False):
    """Lat-long environment map from SH (reference insert_utils.py:201-214)."""
    dirs = latlong_dirs(H, W, upper_hemi, sh_coeff.device).reshape(-1, 3)
    return get_sh_val(sh_coeff, dirs).reshape(H, W, 3)


# ---------------------------------------------------------------------------
# SH9 triple product
# ---------------------------------------------------------------------------

def _compute_triple_product_table():
    """C_ijk = int Y_i Y_j Y_k dOmega by quadrature (exact: integrand band
    <= 6); replaces the reference's shipped clebsch_3.tar
    (insert_utils.py:296-310)."""
    n_t, n_p = 32, 64
    nodes, weights = np.polynomial.legendre.leggauss(n_t)
    phi = (np.arange(n_p) + 0.5) / n_p * 2 * np.pi
    ct, ph = np.meshgrid(nodes, phi, indexing="ij")
    w = np.broadcast_to(weights[:, None], ct.shape) * (2 * np.pi / n_p)
    st = np.sqrt(1 - ct ** 2)
    dirs = np.stack([st * np.cos(ph), st * np.sin(ph), ct], -1).reshape(-1, 3)
    Y = sh9_basis(torch.as_tensor(dirs, dtype=torch.float32)).numpy()
    C = np.einsum("qi,qj,qk,q->ijk", Y, Y, Y, w.reshape(-1))
    C[np.abs(C) < 1e-8] = 0.0
    return C


_TRIPLE_C = None


def _triple_table(device):
    global _TRIPLE_C
    if _TRIPLE_C is None:
        _TRIPLE_C = torch.as_tensor(_compute_triple_product_table(),
                                    dtype=torch.float32)
    return _TRIPLE_C.to(device)


def sh9_product(shec1, shec2):
    """Projected product of two SH9 functions: res_k = C_ijk a_i b_j
    (reference insert_utils.py:305-310). (..., 9), (..., 9) -> (..., 9)."""
    C = _triple_table(shec1.device)
    return torch.einsum("...i,...j,ijk->...k", shec1, shec2, C)


def sh9_product_93(shec1, shec2):
    """(..., 9, 3) variant, per channel (reference insert_utils.py:315-317)."""
    return sh9_product(shec1.transpose(-2, -1),
                       shec2.transpose(-2, -1)).transpose(-2, -1)


def write2ply(rgbs, pts, save_path):
    """ASCII PLY point-cloud writer (replaces the reference's open3d,
    insert_utils.py:40-46). rgbs, pts: (n, 3) arrays."""
    rgbs = np.clip(np.asarray(rgbs), 0, 1)
    pts = np.asarray(pts)
    cols = (rgbs * 255).astype(np.uint8)
    with open(save_path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        for ax in "xyz":
            f.write(f"property float {ax}\n")
        for c in ("red", "green", "blue"):
            f.write(f"property uchar {c}\n")
        f.write("end_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")


def read_ply(path):
    """Minimal ASCII PLY reader (points + colors)."""
    with open(path) as f:
        n = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        data = np.loadtxt(f, max_rows=n, ndmin=2)
    pts = data[:, :3]
    rgbs = data[:, 3:6] / 255.0 if data.shape[1] >= 6 else None
    return pts, rgbs


def pts2normal(pts):
    """Screen-space normals from a point map (b, h, w, 3)
    (reference insert_utils.py:51-59)."""
    dy = pts[:, :-1] - pts[:, 1:]
    dy = torch.cat([dy[:, :1], dy], 1)
    dx = pts[:, :, :-1] - pts[:, :, 1:]
    dx = torch.cat([dx[:, :, :1], dx], 2)
    return normalize(torch.linalg.cross(dy, dx, dim=-1))
