"""Occupancy-grid-guided ray marching for the test-time renderer (port of
arnerf_tpu/ops/marching.py: occupancy_lookup, coarse_dilation_radius,
build_coarse_occupancy, march_rays_test).

The reference's serial per-ray DDA (raymarching_test_kernel,
models/csrc/raymarching.cu:335-454) becomes the closed-form step lattice
(ops/stepping.py) evaluated for all candidates at once, one vectorized
occupancy test, and a row-local sort that packs each ray's occupied
candidates to the front in order. The occupancy grid is a flat uint8 0/1
array (cascades*G^3,) laid out [mip, x, y, z] row-major.

The training marchers come with the training path.
"""

import math

import torch
import torch.nn.functional as F

from .stepping import SQRT3, calc_dt, fma, lattice_t, mip_from_pos, \
    mip_from_dt

COARSE_FACTOR = 8   # coarse supercell = 8^3 fine occupancy cells


def pl_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _points(rays_o, rays_d, t):
    """o + t*d per candidate: rays (N, 3), t (N, K) -> (N, K, 3), rounded
    as one fused multiply-add like the JAX reference."""
    return fma(t[..., None], rays_d[:, None, :], rays_o[:, None, :])


def occupancy_lookup(occ_flat, pos, dt, *, scale: float, cascades: int,
                     grid_size: int):
    """Vectorized occupancy test: positions (..., 3), dt (...,) -> bool (...,).

    Mirrors the per-step lookup of the reference marcher
    (raymarching.cu:205-220) with a row-major [mip, x, y, z] uint8 grid.
    """
    G = grid_size
    mip = torch.maximum(mip_from_pos(pos, cascades),
                        mip_from_dt(dt, G, cascades))
    mip_bound = torch.clamp(torch.exp2(mip.to(torch.float32) - 1.0),
                            max=scale)
    n = torch.clamp(0.5 * (pos / mip_bound[..., None] + 1.0) * G, 0.0, G - 1.0)
    n = n.to(torch.int64)
    flat = ((mip * G + n[..., 0]) * G + n[..., 1]) * G + n[..., 2]
    return occ_flat[flat] > 0


def coarse_dilation_radius(*, scale: float, exp_step_factor: float,
                           grid_size: int, max_samples: int,
                           dt_scale: float = None) -> int:
    """Exact dilation radius (in supercells) so that a lattice segment
    classified by its START position can never miss occupancy its F-1
    forward fine steps would hit (see the JAX counterpart)."""
    step_scale = scale if dt_scale is None else dt_scale
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2 * step_scale / grid_size
    worst = dt_max if exp_step_factor > 0 else min(dt_min, dt_max)
    d = (COARSE_FACTOR - 1) * worst
    s = 2.0 * min(0.5, scale) / (grid_size // COARSE_FACTOR)
    return int(math.floor(d / s)) + 1


def build_coarse_occupancy(occ_flat, cascades: int, grid_size: int,
                           dilate: int = 2):
    """Dilated max-pool of the occupancy grid: (C*G^3,) -> (C*(G/8)^3,).

    Supercell j is 1 iff ANY fine cell within `dilate` supercells of j is
    occupied ((2*dilate+1)^3 max filter after pooling). The JAX
    reduce_window(max, SAME) is max_pool3d with padding `dilate`."""
    G = grid_size
    CG = G // COARSE_FACTOR
    w = 2 * dilate + 1
    occ = occ_flat.reshape(cascades, CG, COARSE_FACTOR, CG, COARSE_FACTOR,
                           CG, COARSE_FACTOR)
    coarse = torch.amax(occ, dim=(2, 4, 6)).to(torch.float32)   # (C, CG^3)
    coarse = F.max_pool3d(coarse[:, None], kernel_size=w, stride=1,
                          padding=dilate)[:, 0]
    return (coarse > 0).to(torch.uint8).reshape(-1)


def march_rays_test(rays_o, rays_d, t_cur, t2, occ_flat, *,
                    scale: float, cascades: int, exp_step_factor: float,
                    grid_size: int, max_samples: int, n_candidates: int,
                    n_samples: int, occ_coarse=None, seg_cap: int = 32,
                    dt_scale: float = None):
    """One incremental marching round for the test-time renderer.

    From each ray's current position t_cur, find its next `n_samples`
    occupied lattice points within the next `n_candidates` steps (padded
    per-ray layout). With `occ_coarse` (single-cascade scenes) a
    dilated-supercell pre-pass prunes fine candidates to occupied 8-step
    segments; if a ray's occupied segments exceed seg_cap the cursor only
    advances to the end of the last selected segment.

    Returns (xyzs (N,S,3), deltas (N,S), ts (N,S), n_eff (N,), t_next (N,)),
    as the JAX counterpart (its docstring has the full contract).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    K, S = n_candidates, n_samples
    step_scale = scale if dt_scale is None else dt_scale

    def cd(t):
        return calc_dt(t, exp_step_factor, max_samples, grid_size, step_scale)

    def lt(t1, k):
        return lattice_t(t1, k, exp_step_factor, max_samples, grid_size,
                         step_scale)

    two_level = occ_coarse is not None and cascades == 1

    if two_level:
        Fc = COARSE_FACTOR
        CG = grid_size // Fc
        K1 = pl_cdiv(K, Fc)
        cols1 = torch.arange(K1, dtype=torch.int64, device=dev)
        t_seg = lt(t_cur[:, None], (cols1 * Fc)[None, :])
        pos_s = _points(rays_o, rays_d, t_seg)
        mb = min(0.5, scale)
        nc = torch.clamp(0.5 * (pos_s / mb + 1.0) * CG, 0.0, CG - 1.0)
        nc = nc.to(torch.int64)
        cflat = (nc[..., 0] * CG + nc[..., 1]) * CG + nc[..., 2]
        seg_elig = (occ_coarse[cflat] > 0) & (t_seg < t2[:, None])
        nseg_raw = seg_elig.sum(dim=1)
        nseg = torch.clamp(nseg_raw, max=seg_cap)
        truncated = nseg_raw > seg_cap
        # row-local sort selection: sorting the per-row key
        # (elig ? col : K1 + col) packs the eligible columns to the front
        # in order (keys are unique per row)
        keyS = torch.where(seg_elig, cols1[None, :], K1 + cols1[None, :])
        skeyS = torch.sort(keyS, dim=1).values
        if seg_cap <= K1:
            sel_pad = skeyS[:, :seg_cap]
        else:
            sel_pad = torch.cat([skeyS, torch.full(
                (N, seg_cap - K1), 2 * K1, dtype=torch.int64, device=dev)], 1)
        sel_j = torch.where(sel_pad < K1, sel_pad, K1 - 1)
        slot_ok = torch.arange(seg_cap, device=dev)[None, :] < nseg[:, None]
        ks = (sel_j * Fc)[:, :, None] \
            + torch.arange(Fc, dtype=torch.int64, device=dev)[None, None, :]
        ks = ks.reshape(N, seg_cap * Fc)
        slot_mask = torch.repeat_interleave(slot_ok, Fc, dim=1)
        Kf = seg_cap * Fc
        # when truncated, everything before the (seg_cap+1)-th occupied
        # segment has been covered, so the cursor may skip past it
        if seg_cap < K1:
            over = torch.where(skeyS[:, seg_cap] < K1, skeyS[:, seg_cap],
                               K1 - 1)
        else:
            over = torch.full((N,), K1 - 1, dtype=torch.int64, device=dev)
        scan_end_k = torch.where(truncated, over * Fc - 1, K - 1)
    else:
        ks = torch.arange(K, dtype=torch.int64, device=dev)[None, :] \
            .expand(N, K)
        slot_mask = None
        Kf = K
        scan_end_k = torch.full((N,), K - 1, dtype=torch.int64, device=dev)

    t_cand = lt(t_cur[:, None], ks)                            # (N, Kf)
    dt_cand = cd(t_cand)
    pos = _points(rays_o, rays_d, t_cand)
    occ = occupancy_lookup(occ_flat, pos, dt_cand, scale=scale,
                           cascades=cascades, grid_size=grid_size)
    elig = occ & (t_cand < t2[:, None])
    if slot_mask is not None:
        elig = elig & slot_mask

    n_eff = torch.clamp(elig.sum(dim=1), max=S)

    # row-local sort selection: the first S sorted keys are the first S
    # eligible columns, in order
    colsF = torch.arange(Kf, dtype=torch.int64, device=dev)[None, :]
    keyF = torch.where(elig, colsF, Kf + colsF)
    skeyF = torch.sort(keyF, dim=1).values
    if S <= Kf:
        q_pad = skeyF[:, :S]
    else:
        q_pad = torch.cat([skeyF, torch.full(
            (N, S - Kf), 2 * Kf, dtype=torch.int64, device=dev)], 1)
    q_sel = torch.where(q_pad < Kf, q_pad, Kf - 1)
    k_sel = torch.gather(ks, 1, q_sel)                         # global steps
    vmask = torch.arange(S, device=dev)[None, :] < n_eff[:, None]

    ts = lt(t_cur[:, None], k_sel)
    deltas = cd(ts)
    xyzs = _points(rays_o, rays_d, ts)
    f = vmask.to(ts.dtype)
    ts = ts * f
    deltas = deltas * f
    xyzs = xyzs * f[..., None]

    # cursor for the next round: one lattice step past the last consumed k
    last_k = torch.where(
        n_eff >= S,
        torch.gather(k_sel, 1, torch.clamp(n_eff[:, None] - 1, min=0))[:, 0],
        scan_end_k)
    t_last = lt(t_cur, last_k)
    t_next = t_last + cd(t_last)
    # rays that scanned to/past t2 are finished; park the cursor beyond t2
    t_scan_end = lt(t_cur, scan_end_k)
    t_next = torch.where((n_eff < S) & (t_scan_end >= t2), t2 + 1.0, t_next)
    return xyzs, deltas, ts, n_eff, t_next
