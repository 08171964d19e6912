"""Occupancy-grid-guided ray marching for the test-time renderer (port of
arnerf_tpu/ops/marching.py: occupancy_lookup, coarse_dilation_radius,
build_coarse_occupancy, march_rays_test).

The reference's serial per-ray DDA (raymarching_test_kernel,
models/csrc/raymarching.cu:335-454) becomes the closed-form step lattice
(ops/stepping.py) evaluated for all candidates at once, one vectorized
occupancy test, and a row-local sort that packs each ray's occupied
candidates to the front in order. The occupancy grid is a flat uint8 0/1
array (cascades*G^3,) laid out [mip, x, y, z] row-major.

The training marchers (`march_rays_train`, `march_rays_train_pooled`)
compact each ray's occupied samples into one static buffer of m_cap slots,
exactly the reference's (ray_start, count) segment layout, deterministic.
When total demand exceeds the buffer (or the segment pool), every ray's
allocation is scaled down and its samples are strided along the ray
instead of truncated, as in the JAX package. Samples are selected with
order-preserving sorts, the JAX package's selection="sort" (its
"search" selection gives the same sample sets and has no counterpart).
While tracing is on (utils/profiling.py) they count, for the enclosing
span's unit, the samples the buffer kept (its allocated slots).

What runs where: `march_rays_test` on CUDA tensors launches the
hand-written sm_90a kernel csrc/marching.cu, one launch a call (one warp a
ray, candidates in registers, no sort), or raises; on CPU tensors it takes
the plain version `_march_rays_test_plain`, whose float32 arithmetic the
kernel repeats. The JAX package has no kernel for this march (plain XLA),
so the kernel replaces none; it was added because the plain version led
the view's device time. The wrapper counts its launches. The training
marchers are plain PyTorch on every device.
"""

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import build
from ..utils import profiling
from .stepping import SQRT3, calc_dt, fma, lattice_t, mip_from_pos, \
    mip_from_dt

COARSE_FACTOR = 8   # coarse supercell = 8^3 fine occupancy cells

# march_rays_test kernel launches since the last reset (plain version calls
# do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


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
    as the JAX counterpart (its docstring has the full contract). CUDA
    tensors go to the kernel (csrc/marching.cu), CPU tensors to the plain
    version; both give the same values.
    """
    kw = dict(scale=scale, cascades=cascades,
              exp_step_factor=exp_step_factor, grid_size=grid_size,
              max_samples=max_samples, n_candidates=n_candidates,
              n_samples=n_samples, occ_coarse=occ_coarse, seg_cap=seg_cap,
              dt_scale=dt_scale)
    if rays_o.device.type == "cpu":
        return _march_rays_test_plain(rays_o, rays_d, t_cur, t2, occ_flat,
                                      **kw)
    if rays_o.device.type != "cuda":
        raise ValueError(f"march_rays_test: unsupported device "
                         f"{rays_o.device}")
    return _march_cuda(rays_o, rays_d, t_cur, t2, occ_flat, **kw)


def _march_rays_test_plain(rays_o, rays_d, t_cur, t2, occ_flat, *,
                           scale: float, cascades: int,
                           exp_step_factor: float, grid_size: int,
                           max_samples: int, n_candidates: int,
                           n_samples: int, occ_coarse=None,
                           seg_cap: int = 32, dt_scale: float = None):
    """march_rays_test in plain PyTorch: every candidate of the round as
    (N, K) rows, each ray's eligible ones packed to the front by a
    row-local sort."""
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


class _Params(ctypes.Structure):
    """csrc/marching.cu's ArnerfMarchParams."""
    _fields_ = [("n_rays", ctypes.c_int64),
                ("t_cur_stride", ctypes.c_int64),
                ("t2_stride", ctypes.c_int64),
                ("o_stride", ctypes.c_int64 * 2),
                ("d_stride", ctypes.c_int64 * 2),
                ("n_candidates", ctypes.c_int32),
                ("n_samples", ctypes.c_int32),
                ("seg_cap", ctypes.c_int32),
                ("two_level", ctypes.c_int32),
                ("exp_steps", ctypes.c_int32),
                ("cascades", ctypes.c_int32),
                ("grid_size", ctypes.c_int32),
                ("coarse_size", ctypes.c_int32)] \
        + [(name, ctypes.c_float) for name in (
            "lat_dt_min", "lat_dt_max", "lat_a", "lat_b", "lat_inv_dt_min",
            "lat_log1pf", "lat_inv_log1pf", "step_factor", "dt_min",
            "dt_max", "scale", "inv_coarse_bound")]


def kernel_constants(*, scale: float, exp_step_factor: float,
                     grid_size: int, max_samples: int,
                     step_scale: float) -> dict:
    """The kernel's float32 constants, each rounded as the plain version's
    CUDA tensor ops round it: a Python number meeting a float32 tensor is
    its nearest float32 (stepping.f32 for the fma operands), and a tensor
    divided by a Python number is multiplied by the float32 reciprocal of
    that number's float32 (`_march_rays_test_plain`'s `pos_s / mb`,
    lattice_t's `/ dt_min` and `/ log1pf`)."""
    f32 = np.float32
    dt_min = SQRT3 / max_samples                       # calc_dt's
    dt_max = SQRT3 * 2 * step_scale / grid_size
    dt_lat = min(dt_min, dt_max)                       # lattice_t's
    f = exp_step_factor
    c = dict(lat_dt_min=f32(dt_lat), lat_dt_max=f32(dt_max),
             step_factor=f32(f), dt_min=f32(dt_min), dt_max=f32(dt_max),
             scale=f32(scale),
             inv_coarse_bound=f32(1) / f32(min(0.5, scale)),
             lat_a=f32(0), lat_b=f32(0), lat_inv_dt_min=f32(0),
             lat_log1pf=f32(0), lat_inv_log1pf=f32(0))
    if f != 0.0:
        log1pf = math.log1p(f)
        c.update(lat_a=f32(dt_lat / f), lat_b=f32(dt_max / f),
                 lat_inv_dt_min=f32(1) / f32(dt_lat),
                 lat_log1pf=f32(log1pf),
                 lat_inv_log1pf=f32(1) / f32(log1pf))
    return {k: float(v) for k, v in c.items()}


@functools.lru_cache(maxsize=None)
def _base_params(*, scale, cascades, exp_step_factor, grid_size,
                 max_samples, n_candidates, n_samples, seg_cap, two_level,
                 step_scale) -> bytes:
    """The call's constants apart from the rays and their strides, built
    once a configuration."""
    p = _Params(n_candidates=n_candidates, n_samples=n_samples,
                seg_cap=seg_cap, two_level=int(two_level),
                exp_steps=int(exp_step_factor != 0.0), cascades=cascades,
                grid_size=grid_size, coarse_size=grid_size // COARSE_FACTOR,
                **kernel_constants(scale=scale,
                                   exp_step_factor=exp_step_factor,
                                   grid_size=grid_size,
                                   max_samples=max_samples,
                                   step_scale=step_scale))
    return bytes(p)


def _library():
    lib = build.load("marching")
    fn = lib.arnerf_march_rays_test
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.POINTER(_Params),
                                                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.arnerf_march_error_string.argtypes = [ctypes.c_int]
        lib.arnerf_march_error_string.restype = ctypes.c_char_p
    return lib


def check_kernel_inputs(rays_o, rays_d, t_cur, t2, occ_flat, occ_coarse, *,
                        cascades: int, grid_size: int, n_candidates: int,
                        n_samples: int, seg_cap: int):
    """Raise ValueError on what csrc/marching.cu does not take: inputs on
    two devices; rays not (N, 3) float32 or t_cur, t2 not (N,) float32 (at
    any strides); an occupancy grid that is not a contiguous 1-D uint8 or
    bool tensor of at least C*G^3 cells, or (G/8)^3 for occ_coarse (read on
    one cascade only); counts out of range."""
    two_level = occ_coarse is not None and cascades == 1
    grids = [("occ_flat", occ_flat, cascades * grid_size ** 3)]
    if two_level:
        grids.append(("occ_coarse", occ_coarse,
                      (grid_size // COARSE_FACTOR) ** 3))
    dev = rays_o.device
    for x in (rays_d, t_cur, t2, *(g for _, g, _ in grids)):
        if x.device != dev:
            raise ValueError(f"march_rays_test: inputs on {dev} and "
                             f"{x.device}")
    n = rays_o.shape[0] if rays_o.ndim else -1
    for name, x in (("rays_o", rays_o), ("rays_d", rays_d)):
        if x.dtype != torch.float32 or tuple(x.shape) != (n, 3):
            raise ValueError(f"march_rays_test: {name} must be (N, 3) "
                             f"float32, got {x.dtype} {tuple(x.shape)}")
    for name, x in (("t_cur", t_cur), ("t2", t2)):
        if x.dtype != torch.float32 or tuple(x.shape) != (n,):
            raise ValueError(f"march_rays_test: {name} must be ({n},) "
                             f"float32, got {x.dtype} {tuple(x.shape)}")
    for name, g, cells in grids:
        if g.dtype not in (torch.uint8, torch.bool) or g.ndim != 1 \
                or not g.is_contiguous() or g.numel() < cells:
            raise ValueError(f"march_rays_test: {name} must be a contiguous "
                             f"1-D uint8 or bool grid of at least {cells} "
                             f"cells, got {g.dtype} {tuple(g.shape)}")
    if cascades < 1 or grid_size < (COARSE_FACTOR if two_level else 1):
        raise ValueError(f"march_rays_test: {cascades} cascades of "
                         f"{grid_size}^3 cells")
    if not (1 <= n_candidates < 1 << 24 and 1 <= n_samples < 1 << 24
            and (not two_level or 1 <= seg_cap < 1 << 24)):
        raise ValueError(f"march_rays_test: n_candidates {n_candidates}, "
                         f"n_samples {n_samples}, seg_cap {seg_cap}: the "
                         f"kernel takes 1 to 2^24 - 1")


def _march_cuda(rays_o, rays_d, t_cur, t2, occ_flat, *, scale: float,
                cascades: int, exp_step_factor: float, grid_size: int,
                max_samples: int, n_candidates: int, n_samples: int,
                occ_coarse, seg_cap: int, dt_scale):
    """march_rays_test on the card: one launch of csrc/marching.cu."""
    check_kernel_inputs(rays_o, rays_d, t_cur, t2, occ_flat, occ_coarse,
                        cascades=cascades, grid_size=grid_size,
                        n_candidates=n_candidates, n_samples=n_samples,
                        seg_cap=seg_cap)
    two_level = occ_coarse is not None and cascades == 1
    N, S = rays_o.shape[0], n_samples
    dev = rays_o.device
    xyzs = torch.empty((N, S, 3), dtype=torch.float32, device=dev)
    deltas = torch.empty((N, S), dtype=torch.float32, device=dev)
    ts = torch.empty((N, S), dtype=torch.float32, device=dev)
    n_eff = torch.empty((N,), dtype=torch.int64, device=dev)
    t_next = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return xyzs, deltas, ts, n_eff, t_next
    params = _Params.from_buffer_copy(_base_params(
        scale=scale, cascades=cascades, exp_step_factor=exp_step_factor,
        grid_size=grid_size, max_samples=max_samples,
        n_candidates=n_candidates, n_samples=S,
        seg_cap=seg_cap if two_level else 0, two_level=two_level,
        step_scale=scale if dt_scale is None else dt_scale))
    params.n_rays = N
    params.t_cur_stride, params.t2_stride = t_cur.stride(0), t2.stride(0)
    params.o_stride[:] = rays_o.stride()
    params.d_stride[:] = rays_d.stride()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arnerf_march_rays_test(
            rays_o.data_ptr(), rays_d.data_ptr(), t_cur.data_ptr(),
            t2.data_ptr(), occ_flat.data_ptr(),
            occ_coarse.data_ptr() if two_level else None, xyzs.data_ptr(),
            deltas.data_ptr(), ts.data_ptr(), n_eff.data_ptr(),
            t_next.data_ptr(), ctypes.byref(params), stream)
    if err:
        raise RuntimeError("march_rays_test launch failed: "
                           + lib.arnerf_march_error_string(err).decode())
    global launches
    launches += 1
    return xyzs, deltas, ts, n_eff, t_next


# --------------------------------------------------------------------------
# Training marchers (port of arnerf_tpu/ops/marching.py:97-618)
# --------------------------------------------------------------------------

class MarchResults(NamedTuple):
    xyzs: torch.Tensor        # (M, 3) sample positions (0 where invalid)
    dirs: torch.Tensor        # (M, 3) ray directions per sample
    deltas: torch.Tensor      # (M,) integration step (stride-scaled)
    ts: torch.Tensor          # (M,) sample distances
    ray_idx: torch.Tensor     # (M,) which ray each sample belongs to
    valid: torch.Tensor       # (M,) bool sample validity
    ray_start: torch.Tensor   # (N,) segment start of each ray in the buffer
    counts: torch.Tensor      # (N,) samples allocated per ray
    rm_samples: torch.Tensor  # () total demanded samples
    # () max occupied-dilated segments any ray intersected, pre-clamp (0 on
    # the single-level path): the adaptive seg_cap's truncation guard
    max_nseg: torch.Tensor = None
    # () total occupied-dilated segments over all rays (pooled path only)
    total_nseg: torch.Tensor = None


def _lower_bound_rows(c_flat, rows, queries, K: int):
    """For each (row, q): smallest j in [0, K) with c[row, j] >= q (== K if
    none). c_flat: (N*K,) row-major, nondecreasing within each row.
    Branchless binary search, log2(K) rounds of one gather each."""
    lo = torch.zeros(queries.shape, dtype=torch.int64, device=queries.device)
    hi = torch.full(queries.shape, K, dtype=torch.int64,
                    device=queries.device)
    base = rows * K
    for _ in range(max(1, K.bit_length())):   # search space [0, K]
        mid = (lo + hi) // 2
        ge = c_flat[base + torch.clamp(mid, max=K - 1)] >= queries
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return lo


def _starts_to_rows(starts, n_slots: int):
    """Slot p -> the ray owning it, for sorted `starts` (N,) with
    starts[0] == 0: one small scatter of N marks + one cumsum. Rays with
    zero allocation stack their marks on one slot, matching
    searchsorted(side='right') - 1."""
    s = starts[1:]
    s = s[s < n_slots]
    marks = torch.zeros(n_slots, dtype=torch.int64, device=starts.device)
    marks.index_add_(0, s, torch.ones_like(s))
    return torch.cumsum(marks, dim=0)


def _exclusive_cumsum(x):
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=x.device),
                      torch.cumsum(x, dim=0)[:-1]])


def _allocate(demand, cap: int):
    """Demand-proportional allocation of `cap` slots with uniform striding:
    (alloc, stride, start) per ray. alloc == demand while the demand fits."""
    total = demand.sum()
    ratio = torch.clamp(cap / torch.clamp(total, min=1).to(torch.float32),
                        max=1.0)
    alloc = torch.floor(demand.to(torch.float32) * ratio).to(torch.int64)
    stride = demand.to(torch.float32) \
        / torch.clamp(alloc, min=1).to(torch.float32)
    return alloc, stride, _exclusive_cumsum(alloc), total


def _perturbed_t1(hits_t, noise, cd):
    """The first sample of each ray jittered by noise * dt (reference:
    custom_functions.py:83, raymarching.cu:195-198), one rounding as XLA
    contracts it. t values are constants w.r.t. the rays (the reference's
    RayMarcher backward)."""
    hits_t = hits_t.detach()
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    ray_ok = t1 >= 0
    return torch.where(ray_ok, fma(cd(t1), noise, t1), t1), t2, ray_ok


def _coarse_cells(rays_o, rays_d, t_seg, scale: float, CG: int):
    """Supercell index of each segment start (single cascade: mip 0)."""
    pos_s = _points(rays_o, rays_d, t_seg)
    mb = min(0.5, scale)
    nc = torch.clamp(0.5 * (pos_s / mb + 1.0) * CG, 0.0, CG - 1.0)
    nc = nc.to(torch.int64)
    return (nc[..., 0] * CG + nc[..., 1]) * CG + nc[..., 2]


def march_rays_train(rays_o, rays_d, hits_t, occ_flat, noise, *,
                     scale: float, cascades: int, exp_step_factor: float,
                     grid_size: int, max_samples: int, n_candidates: int,
                     m_cap: int, s_cap: int, occ_coarse=None,
                     seg_cap: int = 64) -> MarchResults:
    """March N rays into a compact (M = m_cap) sample buffer.

    rays_o, rays_d: (N, 3); hits_t: (N, 2) from ray_aabb_intersect_single;
    occ_flat: (cascades*G^3,) uint8 occupancy; noise: (N,) U[0, 1).
    With `occ_coarse` on a single-cascade scene, a coarse pre-pass keeps
    only each ray's first seg_cap occupied 8-step segments (exactly the
    single-level result while no ray exceeds seg_cap). The compaction is
    a row-local sort.
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    K = n_candidates

    def cd(t):
        return calc_dt(t, exp_step_factor, max_samples, grid_size, scale)

    def lt(t1, k):
        return lattice_t(t1, k, exp_step_factor, max_samples, grid_size,
                         scale)

    t1, t2, ray_ok = _perturbed_t1(hits_t, noise, cd)

    if occ_coarse is not None and cascades == 1:
        Fc = COARSE_FACTOR
        K1 = pl_cdiv(K, Fc)
        t_seg = lt(t1[:, None],
                   (torch.arange(K1, device=dev) * Fc)[None, :])   # (N, K1)
        cflat = _coarse_cells(rays_o, rays_d, t_seg, scale,
                              grid_size // Fc)
        seg_elig = (occ_coarse[cflat] > 0) & (t_seg < t2[:, None]) \
            & ray_ok[:, None]
        c1 = torch.cumsum(seg_elig.to(torch.int64), dim=1)
        max_nseg = c1[:, -1].max()          # pre-clamp: truncation guard
        nseg = torch.clamp(c1[:, -1], max=seg_cap)
        srows = torch.arange(N, device=dev)[:, None].expand(N, seg_cap)
        squer = torch.arange(1, seg_cap + 1, device=dev)[None, :] \
            .expand(N, seg_cap)
        sel_j = _lower_bound_rows(c1.reshape(-1), srows.reshape(-1),
                                  squer.reshape(-1), K1).reshape(N, seg_cap)
        slot_ok = torch.arange(seg_cap, device=dev)[None, :] < nseg[:, None]
        # ks: global lattice step of every fine candidate (N, seg_cap*F)
        ks = (torch.clamp(sel_j, max=K1 - 1) * Fc)[:, :, None] \
            + torch.arange(Fc, device=dev)[None, None, :]
        ks = ks.reshape(N, seg_cap * Fc)
        slot_mask = torch.repeat_interleave(slot_ok, Fc, dim=1)
        Kf = seg_cap * Fc
    else:
        ks = torch.arange(K, device=dev)[None, :].expand(N, K)
        slot_mask = None
        Kf = K
        max_nseg = torch.zeros((), dtype=torch.int64, device=dev)

    # ---- candidate lattice + occupancy test -------------------------------
    t_cand = lt(t1[:, None], ks)                               # (N, Kf)
    pos = _points(rays_o, rays_d, t_cand)
    occ = occupancy_lookup(occ_flat, pos, cd(t_cand), scale=scale,
                           cascades=cascades, grid_size=grid_size)
    elig = occ & (t_cand < t2[:, None]) & ray_ok[:, None]
    if slot_mask is not None:
        elig = elig & slot_mask

    # ---- order-preserving compaction --------------------------------------
    demand = torch.clamp(elig.sum(dim=1), max=s_cap)
    alloc, stride, ray_start, total_demand = _allocate(demand, m_cap)
    m = torch.arange(m_cap, device=dev)

    # row-local sort: per-row keys (elig ? col : Kf+col) are unique, so the
    # j-th eligible candidate of ray r is sel_col[r, j]
    colsK = torch.arange(Kf, device=dev)[None, :]
    skeyK = torch.sort(torch.where(elig, colsK, Kf + colsK), dim=1).values
    sel_col = torch.where(skeyK < Kf, skeyK, Kf - 1)
    r = torch.clamp(_starts_to_rows(ray_start, m_cap), max=N - 1)  # (M,)
    s = m - ray_start[r]
    valid = s < alloc[r]
    # occupied ordinal along the ray, strided when over budget
    j = torch.floor(s.to(torch.float32) * stride[r]).to(torch.int64)
    j = torch.minimum(j, torch.clamp(demand[r] - 1, min=0))
    q_sel = sel_col.reshape(-1)[r * Kf + j]
    k_sel = ks.reshape(-1)[r * Kf + q_sel]                     # global step

    # ---- sample attributes from the closed form ---------------------------
    t_m = lt(t1[r], k_sel)
    dt_m = cd(t_m) * stride[r]
    dirs = rays_d[r]
    xyzs = fma(t_m[:, None], dirs, rays_o[r])
    fvalid = valid.to(t_m.dtype)
    profiling.count("samples_kept", alloc.sum)
    return MarchResults(
        xyzs=xyzs * fvalid[:, None], dirs=dirs * fvalid[:, None],
        deltas=dt_m * fvalid, ts=t_m * fvalid, ray_idx=r, valid=valid,
        ray_start=ray_start, counts=alloc, rm_samples=total_demand,
        max_nseg=max_nseg)


def march_rays_train_pooled(rays_o, rays_d, hits_t, occ_flat, noise, *,
                            scale: float, cascades: int,
                            exp_step_factor: float, grid_size: int,
                            max_samples: int, n_candidates: int,
                            m_cap: int, s_cap: int, occ_coarse,
                            seg_pool_cap: int) -> MarchResults:
    """Two-level train marching with a shared cross-ray segment pool of
    `seg_pool_cap` slots: capacity follows the batch's mean segment demand
    instead of the worst ray's. Over-demand strides each ray's occupied
    segments (never truncates); when demand fits, the sample set equals
    march_rays_train's single-level path. Needs `occ_coarse` and one
    cascade. Each compaction is one order-preserving sort.
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    K = n_candidates
    Fc = COARSE_FACTOR
    K1 = pl_cdiv(K, Fc)
    Sp = seg_pool_cap

    def cd(t):
        return calc_dt(t, exp_step_factor, max_samples, grid_size, scale)

    def lt(t1, k):
        return lattice_t(t1, k, exp_step_factor, max_samples, grid_size,
                         scale)

    t1, t2, ray_ok = _perturbed_t1(hits_t, noise, cd)

    # ---- coarse pass: occupied-dilated supercell segments per ray ----------
    t_seg = lt(t1[:, None], (torch.arange(K1, device=dev) * Fc)[None, :])
    cflat = _coarse_cells(rays_o, rays_d, t_seg, scale, grid_size // Fc)
    seg_elig = (occ_coarse[cflat] > 0) & (t_seg < t2[:, None]) \
        & ray_ok[:, None]
    dseg = seg_elig.sum(dim=1)                                 # (N,)
    max_nseg = dseg.max()
    total_nseg = dseg.sum()

    # ---- segment compaction into the shared pool ---------------------------
    alloc_s, stride_s, seg_start, _ = _allocate(dseg, Sp)
    p = torch.arange(Sp, device=dev)
    r_p = torch.clamp(_starts_to_rows(seg_start, Sp), max=N - 1)  # (Sp,)
    s_p = p - seg_start[r_p]
    valid_p = s_p < alloc_s[r_p]
    j_p = torch.floor(s_p.to(torch.float32) * stride_s[r_p]).to(torch.int64)
    j_p = torch.minimum(j_p, torch.clamp(dseg[r_p] - 1, min=0))
    # keys are unique, so the sort is order-preserving: the first
    # total_nseg keys are the eligible (ray, segment) flats, ray-major
    flatK = torch.arange(N * K1, device=dev)
    skey = torch.sort(torch.where(seg_elig.reshape(-1), flatK,
                                  N * K1 + flatK)).values
    sel_flat = skey[torch.clamp(_exclusive_cumsum(dseg)[r_p] + j_p,
                                max=N * K1 - 1)]
    k_base = (sel_flat % K1) * Fc

    # ---- fine pass over pooled segments only -------------------------------
    ks_f = k_base[:, None] + torch.arange(Fc, device=dev)[None, :]
    t_cand = lt(t1[r_p][:, None], ks_f)                        # (Sp, F)
    pos = _points(rays_o[r_p], rays_d[r_p], t_cand)
    occ = occupancy_lookup(occ_flat, pos, cd(t_cand), scale=scale,
                           cascades=cascades, grid_size=grid_size)
    elig = occ & (t_cand < t2[r_p][:, None]) & valid_p[:, None]

    # ---- sample compaction (global cumsum over the ray-contiguous pool) ----
    cg0 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     torch.cumsum(elig.reshape(-1).to(torch.int64), dim=0)])
    fine_base = seg_start * Fc                                 # (N,)
    fine_len = alloc_s * Fc
    cnt = cg0[torch.clamp(fine_base + fine_len, max=Sp * Fc)] - cg0[fine_base]
    demand = torch.clamp(cnt, max=s_cap)
    alloc, stride, ray_start, total_demand = _allocate(demand, m_cap)
    m = torch.arange(m_cap, device=dev)

    r = torch.clamp(_starts_to_rows(ray_start, m_cap), max=N - 1)  # (M,)
    s = m - ray_start[r]
    valid = s < alloc[r]
    j = torch.floor(s.to(torch.float32) * stride[r]).to(torch.int64)
    j = torch.minimum(j, torch.clamp(demand[r] - 1, min=0))
    # the (j+1)-th eligible candidate of ray r is a direct read of the
    # compacted candidate array
    flatF = torch.arange(Sp * Fc, device=dev)
    order = torch.sort(torch.where(elig.reshape(-1), flatF,
                                   Sp * Fc + flatF)).indices
    comp_k = ks_f.reshape(-1)[order]
    k_sel = comp_k[torch.clamp(cg0[fine_base][r] + j, max=Sp * Fc - 1)]

    # ---- sample attributes from the closed form ---------------------------
    t_m = lt(t1[r], k_sel)
    # the step scales by both thinning factors (segment and sample striding)
    dt_m = cd(t_m) * stride[r] * stride_s[r]
    dirs = rays_d[r]
    xyzs = fma(t_m[:, None], dirs, rays_o[r])
    fvalid = valid.to(t_m.dtype)
    profiling.count("samples_kept", alloc.sum)
    return MarchResults(
        xyzs=xyzs * fvalid[:, None], dirs=dirs * fvalid[:, None],
        deltas=dt_m * fvalid, ts=t_m * fvalid, ray_idx=r, valid=valid,
        ray_start=ray_start, counts=alloc, rm_samples=total_demand,
        max_nseg=max_nseg, total_nseg=total_nseg)
