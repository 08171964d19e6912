"""SG-SSDF shadows: a PCA-compressed spherical-SDF volume around the
inserted mesh plus a pretabulated SG hemisphere integral F(lambda, theta_d)
(port of arnerf_tpu/insert/sg_shadow.py; reference insert/sg_shadow.py).

The F table is computed by quadrature in numpy (seconds) and cached under
build/arnerf_tpu_torch/ at the root of the checkout, never in the package.
"""

import os

import numpy as np
import torch

from ..build import BUILD_DIR
from .shadow_fields import grid_sample_2d, grid_sample_3d


def compute_fh_table(theta_num=1024, lbd_num=2048, zeta_num=256):
    """F(lambda, theta_d) =
       int_{delta=pi/2-theta_d}^{pi} int_{zeta=0}^{pi}
           exp(lambda (sin zeta sin delta - 1)) sin zeta  dzeta ddelta,
    lambda on a log10 grid [-1, 4] (lbd_num), theta_d linear [-pi/2, pi/2]
    (theta_num): midpoint quadrature over zeta, suffix sums over a uniform
    delta grid (reference sg_shadow.py:275-309)."""
    lbds = 10 ** np.linspace(-1, 4, lbd_num)
    deltas = (np.arange(theta_num) + 0.5) / theta_num * np.pi
    d_delta = np.pi / theta_num
    zetas = (np.arange(zeta_num) + 0.5) / zeta_num * np.pi
    d_zeta = np.pi / zeta_num
    sin_z = np.sin(zetas)
    sin_d = np.sin(deltas)
    inner = np.empty((lbd_num, theta_num), np.float32)
    for i0 in range(0, lbd_num, 128):
        lb = lbds[i0:i0 + 128][:, None, None]
        ex = np.exp(lb * (sin_z[None, None, :] * sin_d[None, :, None] - 1.0))
        inner[i0:i0 + 128] = np.sum(ex * sin_z[None, None, :],
                                    axis=-1) * d_zeta
    suffix = np.cumsum(inner[:, ::-1], axis=1)[:, ::-1] * d_delta
    # column j: lower limit pi/2 - theta_d_j, mapped to its suffix cell
    theta_ds = np.linspace(-np.pi / 2, np.pi / 2, theta_num)
    lower = np.pi / 2 - theta_ds
    idx = np.clip(((lower / np.pi) * theta_num - 0.5).round().astype(int),
                  0, theta_num - 1)
    return suffix[:, idx].astype(np.float32)                   # (L, T)


FH_CACHE = BUILD_DIR / "fh_pretab.npy"


def get_fh_table():
    """The full-size F table, computed once and cached (atomic write)."""
    if FH_CACHE.exists():
        return np.load(FH_CACHE)
    tab = compute_fh_table()
    FH_CACHE.parent.mkdir(parents=True, exist_ok=True)
    tmp = FH_CACHE.with_suffix(f".tmp{os.getpid()}.npy")
    np.save(tmp, tab)
    os.replace(tmp, FH_CACHE)
    return tab


def load_pca_volume(path):
    """The viewer's PCA SSDF export {coeff, component, mean} from a torch
    .tar or an .npz, as numpy arrays."""
    if path.endswith(".npz"):
        d = np.load(path)
        return d["coeff"], d["component"], d["mean"]
    d = torch.load(path, map_location="cpu")
    return tuple(np.asarray(d[k].numpy() if torch.is_tensor(d[k]) else d[k],
                            np.float32)
                 for k in ("coeff", "component", "mean"))


class SGShadow:
    """reference insert/sg_shadow.py:10-153."""

    def __init__(self, pca_path, grid_size=20, ncomponents=32, vol_range=4,
                 envH=128, envW=128, angle_decay_fac=0.4, shadow_pow_fac=2,
                 self_shadow_pow_fac=0.1, device="cpu"):
        self.delta_angle_decay_fac = angle_decay_fac
        self.delta_shadow_fac = shadow_pow_fac
        self.delta_self_shadow_fac = self_shadow_pow_fac
        self.vol_range = vol_range
        self.raw_h_angle = float(np.arcsin(1.0 / vol_range))
        self.ncomponents = ncomponents
        self.envH, self.envW = envH, envW
        self.fh_tab = torch.as_tensor(get_fh_table(),
                                      device=device)[None]       # (1, L, T)
        coeff, comp, mean = load_pca_volume(pca_path)
        self.coeff_volume = torch.as_tensor(np.ascontiguousarray(
            np.transpose(coeff.reshape(grid_size, grid_size, grid_size,
                                       ncomponents), (3, 2, 1, 0))),
            device=device)                                       # (C,D,H,W)
        self.components = torch.as_tensor(comp, device=device)   # (32, H, W)
        self.mean = torch.as_tensor(mean, device=device)         # (1, H, W)

    def light_axis_to_coord(self, l_sgs):
        """PCA components and mean at each light axis' lat-long position
        (reference :34-53)."""
        phi = torch.arccos(l_sgs[:, 1])
        theta = torch.atan2(l_sgs[:, 2], l_sgs[:, 0])
        pos2d = torch.stack([theta / np.pi, phi / np.pi * 2 - 1], -1)
        self.components_s = grid_sample_2d(self.components, pos2d)
        self.mean_s = grid_sample_2d(self.mean, pos2d)[:, 0][None]

    def _fh_lookup(self, ssdf, l_sgs):
        """F(lambda_l, ssdf_pl) -> (px, lx)."""
        s = ssdf / (np.pi / 2)
        lam = (torch.log10(torch.abs(l_sgs[:, 3] + 1e-6)) - 1.5) / 2.5
        lam = lam[None, :].expand(s.shape)
        pts = torch.stack([s.reshape(-1), lam.reshape(-1)], -1)
        return grid_sample_2d(self.fh_tab, pts)[:, 0].reshape(s.shape)

    def calc_inte_L_V(self, ssdf, l_sgs):
        return self._fh_lookup(ssdf, l_sgs) @ l_sgs[:, -3:]     # (px, 3)

    def calc_inte_L(self, l_sgs):
        """Unoccluded hemisphere integral (reference :69-73)."""
        exp_term = 1.0 - torch.exp(-l_sgs[:, 3:4])
        cols = 2 * np.pi * (l_sgs[:, -3:] / l_sgs[:, 3:4]) * exp_term
        return torch.sum(cols, 0, keepdim=True)

    def fetch_ssdf(self, scale, pts):
        """Spherical-SDF values toward each light at receiver points
        (reference :79-101)."""
        p = pts / scale / self.vol_range
        dis = torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1.0)
        p = p / dis
        cur_h_angle = torch.arcsin(1.0 / (dis * self.vol_range))
        delta_h = (self.raw_h_angle - cur_h_angle) * self.delta_angle_decay_fac
        pca = grid_sample_3d(self.coeff_volume, p, align_corners=True)
        return pca @ self.components_s.T + self.mean_s + delta_h

    def _ssdf(self, scale, pts, model_pos, l_sgs, rot_inv):
        m2pts = pts - model_pos[None, :]
        if rot_inv is not None:
            m2pts = (rot_inv @ m2pts.T).T
        self.light_axis_to_coord(l_sgs)
        return torch.clamp(self.fetch_ssdf(scale, m2pts), -np.pi / 2,
                           np.pi / 2)

    def calc_shadow_factor(self, scale, pts, model_pos, l_sgs, rot_inv=None):
        """Scene-shadow factor (px,) in [0, 1] (reference :103-115)."""
        ssdf = self._ssdf(scale, pts, model_pos, l_sgs, rot_inv)
        factor = torch.clamp(torch.abs(self.calc_inte_L_V(ssdf, l_sgs)
                                       / self.calc_inte_L(l_sgs)), 0, 1)
        factor = (0.2989 * factor[:, 0] + 0.5870 * factor[:, 1]
                  + 0.1140 * factor[:, 2])
        return torch.pow(factor, self.delta_shadow_fac)

    def calc_self_shadow_light_decay(self, scale, pts, model_pos, l_sgs,
                                     rot_inv=None):
        """Per-point decayed light SGs for the object's self-shadowing
        (reference :118-153). Returns (px, lx, 7)."""
        l_axis = l_sgs
        if rot_inv is not None:
            l_axis = torch.cat([(rot_inv @ l_sgs[:, :3].T).T, l_sgs[:, 3:]],
                               -1)
        ssdf = self._ssdf(scale, pts, model_pos, l_axis, rot_inv)
        fhs = self._fh_lookup(ssdf, l_sgs)                       # (px, lx)
        exp_term = 1.0 - torch.exp(-l_sgs[:, 3:4])
        fh_n = 2 * np.pi / l_sgs[:, 3:4] * exp_term              # (lx, 1)
        decay = torch.clamp(torch.abs(fhs / fh_n.T), 0, 1)[..., None]
        decay = torch.pow(decay, self.delta_self_shadow_fac)
        mu = l_sgs[None, :, -3:] * decay                         # (px, lx, 3)
        head = l_sgs[None, :, :4].expand(decay.shape[0], l_sgs.shape[0], 4)
        return torch.cat([head, mu], -1)
