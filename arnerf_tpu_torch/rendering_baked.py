"""Baked-field renderer (port of arnerf_tpu/rendering_baked.py): the trained
field baked into one dense voxel grid whose row holds everything a sample
needs, density plus a 9-term spherical-harmonics fit of the radiance per
channel (PlenOctrees/SNeRG), so a sample costs one row read.

  bake_ngp -> bake_field / bake_field_mc -> BakedField
  render_baked -> cull_and_buckets -> render_baked_bricks (single cascade,
      stochastic, split colour), render_baked_mc_uniform (several
      cascades) or render_baked_uniform (trilinear, or no split)

The bake evaluates the field only at occupied voxels (the trainer's
occupancy, resampled to the bake's resolution and dilated by one voxel),
with `n_dirs` quadrature directions per voxel, and projects the colours
onto SH9 by ridge least squares. It also builds the derived tables the
renderers read: the coarse occupancy mip, its Chebyshev distance field,
the brick-packed log-coded sigma (`sigma_bricks`) and the quantised
occupied-only colour table (`rows_q`, `row_index`).

Every render result equals the JAX package's on the same inputs: the same
phase schedule and alive-first permutation between phases (the per-sample
jitter counter is `rounds * Np * S + position` within the current phase),
the same per-bucket seeds (`jax.random.split` / `bits` through
ops/threefry.py) and the same counter hash (ops/rng.py). The round loops
run on the host, one alive count read back per round, where JAX runs a
device while_loop. The bake's chunk formula is JAX's, so a stochastic
bake gives each voxel the same corner draws.

Not ported yet: the delta bake (`bake_field_delta`, `bake_ngp_delta`) and
the GUI frame functions (`baked_frame_device_fn`, `baked_frame_display_fn`).

A render runs under `record_function` spans ("cull", "prelude", "march",
"color") so a profile attributes its device time.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .insert.sh_math import sh9_basis
from .ops import threefry
from .ops.composite import composite_test_step
from .ops.intersection import ray_aabb_intersect_single
from .ops.rng import hash_uniform3
from .ops.stepping import f32, fma, mip_from_pos

# row layout: [sigma, r_sh(9), g_sh(9), b_sh(9), pad(4)] -> 32 channels
N_CH = 32
N_SH = 9
MIP_FACTOR = 8
# brick-packed sigma: 8^3 voxels a row, code = round(LOGQ * log2(1 + sigma))
BRICK = 8
LOGQ = 24.0


@dataclass
class BakedField:
    """A baked field. `rows` (C*B^3, 32) z-fastest voxel rows of cascade
    c's cube of half-extent cascade_half_extents()[c]; `sigma` their sigma
    column; `aabb_lo`/`aabb_hi` (3,) tight bounds of the density-carrying
    voxels; `mip` (ceil(B/8)^3,) uint8 dilated coarse occupancy and
    `mip_dist` its Chebyshev distance field; `sigma_bricks`
    (ceil(B/8)^3, 640) uint8 log codes of each 8^3 brick with the brick's
    distance in lane 512; `rows_q` (1 + V, 32) int8 quantised colours
    [sh27, pad, f32 scale bytes] with row 0 empty, and `row_index`
    (C*B^3,) int32 voxel -> rows_q row. Single-cascade fields carry every
    table; multi-cascade ones no mip and no bricks."""
    rows: torch.Tensor
    resolution: int
    scale: float
    aabb_lo: torch.Tensor = None
    aabb_hi: torch.Tensor = None
    mip: torch.Tensor = None
    sigma: torch.Tensor = None
    row_index: torch.Tensor = None
    rows_q: torch.Tensor = None
    cascades: int = 1
    sigma_bricks: torch.Tensor = None
    mip_dist: torch.Tensor = None


def _pow2_bucket(n: int, min_bucket: int) -> int:
    """The smallest power of two >= n, at least min_bucket
    (rendering.py:441)."""
    return max(min_bucket, 1 << int(np.ceil(np.log2(max(n, 1)))))


def _f32_inv(x: float) -> float:
    """1 / x in float32, as XLA turns a division by a constant into a
    product with its float32 reciprocal."""
    return float(np.float32(1.0) / np.float32(x))


# --------------------------------------------------------------------------
# Derived tables
# --------------------------------------------------------------------------

def sigma_encode(sigma):
    """f32 sigma -> uint8 log code (0 -> exactly 0; ~1.5% relative step)."""
    c = torch.round(LOGQ * torch.log2(1.0 + torch.clamp(sigma, min=0.0)))
    return torch.clamp(c, 0, 255).to(torch.uint8)


def sigma_decode(code):
    """uint8/int32 log code -> f32 sigma."""
    return torch.exp2(code.to(torch.float32) / LOGQ) - 1.0


def _pad_cube(x, size: int):
    p = size - x.shape[0]
    return F.pad(x, (0, p, 0, p, 0, p)) if p else x


def build_sigma_bricks(rows_sigma, B: int, mip_dist=None):
    """(B^3,) sigma -> (ceil(B/8)^3, 512) uint8 brick table (row b = brick
    b's 8^3 voxels z-fastest, log-coded); with `mip_dist`, 640 lanes and
    lane 512 the brick's distance value."""
    Fb = BRICK
    Bb = -(-B // Fb)
    sig = _pad_cube(rows_sigma.reshape(B, B, B), Bb * Fb)
    codes = sigma_encode(sig).reshape(Bb, Fb, Bb, Fb, Bb, Fb)
    bricks = codes.permute(0, 2, 4, 1, 3, 5).reshape(Bb ** 3, Fb ** 3)
    if mip_dist is None:
        return bricks
    ext = torch.zeros((Bb ** 3, 128), dtype=torch.uint8, device=sig.device)
    ext[:, 0] = mip_dist.to(torch.uint8)
    return torch.cat([bricks, ext], dim=1)


def _dilate3(occ):
    """3^3 max filter of a (n, n, n) bool grid, zero outside."""
    return F.max_pool3d(occ[None, None].float(), 3, 1, padding=1)[0, 0] > 0


def build_sigma_mip(rows_sigma, B: int):
    """(B^3,) sigma -> (ceil(B/8)^3,) uint8: 1 where a supercell, dilated by
    one supercell, holds a voxel with sigma > 0."""
    Fm = MIP_FACTOR
    Bc = -(-B // Fm)
    sig = _pad_cube(rows_sigma.reshape(B, B, B) > 0, Bc * Fm)
    coarse = sig.reshape(Bc, Fm, Bc, Fm, Bc, Fm).any(5).any(3).any(1)
    return _dilate3(coarse).reshape(-1).to(torch.uint8)


def build_mip_dist(mip, Bc: int):
    """Chebyshev (max-norm) distance transform of the mip: 0 on dilated-
    occupied supercells, else the supercell distance to the nearest one
    (Bc everywhere in an empty field), clipped to 255; Bc - 1 relaxations
    of a 3^3 min filter."""
    occ = mip.reshape(Bc, Bc, Bc) > 0
    d = torch.where(occ, 0.0, float(Bc)).to(torch.float32)
    for _ in range(Bc - 1):
        # min filter as -max(-d); max_pool pads with -inf, i.e. +inf here
        m = -F.max_pool3d(-d[None, None], 3, 1, padding=1)[0, 0]
        d = torch.minimum(d, m + 1.0)
    return torch.clamp(d, 0, 255).reshape(-1).to(torch.uint8)


def build_mip_dist_mc(sigma, B: int, cascades: int):
    """One outer-cube Chebyshev distance field over every cascade's
    occupancy: cascade c's written voxels max-pooled into the outer
    supercells its cube spans, dilated by one supercell, then
    build_mip_dist."""
    Fm = MIP_FACTOR
    if B % Fm:
        raise ValueError("build_mip_dist_mc needs MIP_FACTOR | B")
    Bc = B // Fm
    sig = sigma.reshape(cascades, B, B, B)
    occ_out = torch.zeros((Bc, Bc, Bc), dtype=torch.bool, device=sig.device)
    for c in range(cascades):
        f = 2 ** (cascades - 1 - c)
        m = Bc // f
        if m == 0:
            continue
        pool = Fm * f
        occ_c = (sig[c] > 0).reshape(m, pool, m, pool, m, pool) \
            .any(5).any(3).any(1)
        lo = (Bc - m) // 2
        occ_out[lo:lo + m, lo:lo + m, lo:lo + m] |= occ_c
    return build_mip_dist(_dilate3(occ_out).reshape(-1).to(torch.uint8), Bc)


def fibonacci_sphere(n: int) -> np.ndarray:
    """Deterministic near-uniform sphere directions (n, 3)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=-1).astype(np.float32)


# --------------------------------------------------------------------------
# Bake
# --------------------------------------------------------------------------

def _bake_finalize(rows, scale: float, B: int, dtype):
    """Tight bounds of the density-carrying voxels (+1 voxel), the mip, its
    distance field and the brick table."""
    sig = rows[:, 0]
    occ3 = (sig > 1e-4).reshape(B, B, B)
    any_occ = bool(occ3.any())
    vox = 2 * scale / B
    los, his = [], []
    for red in ((1, 2), (0, 2), (0, 1)):
        m = occ3.any(red[1]).any(red[0]).to(torch.uint8)
        first = int(torch.argmax(m))
        last = B - 1 - int(torch.argmax(m.flip(0)))
        los.append(np.float32(first) * np.float32(vox) - np.float32(scale)
                   - np.float32(vox))
        his.append((np.float32(last) + 1) * np.float32(vox)
                   - np.float32(scale) + np.float32(vox))
    dev = rows.device
    if any_occ:
        aabb_lo = torch.tensor(np.array(los, np.float32), device=dev)
        aabb_hi = torch.tensor(np.array(his, np.float32), device=dev)
    else:
        aabb_lo = torch.full((3,), -scale, dtype=torch.float32, device=dev)
        aabb_hi = torch.full((3,), scale, dtype=torch.float32, device=dev)
    mip = build_sigma_mip(sig, B)
    mip_dist = build_mip_dist(mip, -(-B // MIP_FACTOR))
    return dict(rows=rows.to(dtype), aabb_lo=aabb_lo, aabb_hi=aabb_hi,
                mip=mip, sigma=sig.to(torch.float32).clone(),
                mip_dist=mip_dist,
                sigma_bricks=build_sigma_bricks(sig, B, mip_dist=mip_dist))


def bake_field(field_fn, scale: float, resolution: int = 256,
               occ_mask=None, n_dirs: int = 32, chunk: int = 1 << 15,
               dtype=torch.float32, mean_sigma: bool = False,
               seeded: bool = False, sh_ridge: float = 1e-3,
               quantize_colors: bool = True, device="cpu") -> BakedField:
    """Bake a radiance field into a dense SH voxel grid on `device`.

    field_fn(xyz (M, 3), dirs (M, 3)[, seed]) -> (sigma (M,), rgb (M, 3)) is
    called with each voxel centre repeated for `n_dirs` directions; with
    `seeded` it also takes the chunk index as its uint32 seed. occ_mask:
    optional (B^3,) bool numpy (z-fastest); only its voxels are evaluated,
    the others stay zero. mean_sigma averages sigma over the directions
    (stochastic fields) instead of taking the first. sh_ridge is the
    Tikhonov weight of the SH projection. quantize_colors also builds the
    int8 colour table (rows_q, row_index)."""
    B = resolution
    dev = torch.device(device)
    occ_idx = (np.nonzero(np.asarray(occ_mask).reshape(-1))[0]
               if occ_mask is not None else np.arange(B ** 3))
    dirs = fibonacci_sphere(n_dirs)
    basis = sh9_basis(torch.from_numpy(dirs)).numpy()             # (D, 9)
    btb = basis.T @ basis + sh_ridge * np.eye(N_SH, dtype=np.float32)
    pinv = torch.from_numpy(np.linalg.solve(btb, basis.T)
                            .astype(np.float32)).to(dev)          # (9, D)
    d_j = torch.from_numpy(dirs).to(dev)

    rows = torch.zeros((B ** 3, N_CH), dtype=torch.float32, device=dev)
    V = len(occ_idx)
    n_chunks = -(-V // chunk)
    idx_all = torch.as_tensor(occ_idx, dtype=torch.int64, device=dev)
    inv_b = _f32_inv(B)
    for ci in range(n_chunks):
        idx = idx_all[ci * chunk:(ci + 1) * chunk]
        m = idx.shape[0]
        f = torch.stack([(idx // (B * B)) % B, (idx // B) % B, idx % B],
                        dim=-1).to(torch.float32)
        # ((f + 0.5) / B * 2) * scale - scale, contracted as XLA does
        c = fma((f + 0.5) * inv_b * 2, f32(scale), f32(-scale))
        x_rep = c.repeat_interleave(n_dirs, dim=0)
        d_rep = d_j.repeat(m, 1)
        if seeded:
            sigma, rgb = field_fn(x_rep, d_rep, ci)
        else:
            sigma, rgb = field_fn(x_rep, d_rep)
        sigma = sigma.reshape(m, n_dirs).float()
        sigma = sigma.mean(dim=1) if mean_sigma else sigma[:, 0]
        rgb = rgb.reshape(m, n_dirs, 3).float()
        coeffs = torch.einsum("kd,mdc->mkc", pinv, rgb)           # (m, 9, 3)
        rows[idx] = torch.cat(
            [sigma[:, None], coeffs.permute(0, 2, 1).reshape(m, 27),
             torch.zeros((m, N_CH - 28), device=dev)], dim=1)
    fin = _bake_finalize(rows, scale, B, dtype)
    row_index = rows_q = None
    if quantize_colors and V:
        rows_q, row_index = quantize_color_table(fin["rows"], occ_idx,
                                                 B ** 3)
    return BakedField(resolution=B, scale=scale, row_index=row_index,
                      rows_q=rows_q, **fin)


def quantize_color_table(rows, occ_idx_np, n_rows_total: int):
    """Occupied-only int8 colour table: (1 + V, 32) int8 rows [sh27 int8,
    pad, f32 scale bytes] (per-voxel symmetric scale max|sh| / 127, row 0
    all zeros for empty voxels) and the (n_rows_total,) int32 voxel ->
    row index."""
    dev = rows.device
    occ = torch.as_tensor(np.asarray(occ_idx_np), dtype=torch.int64,
                          device=dev)
    V = occ.shape[0]
    sh = rows[occ, 1:28].to(torch.float32)                        # (V, 27)
    sc = torch.amax(torch.abs(sh), dim=1) / 127.0                 # (V,)
    q = torch.round(sh / torch.clamp(sc, min=1e-20)[:, None]) \
        .to(torch.int8)
    sbits = sc.contiguous().view(torch.int8).reshape(V, 4)
    row = torch.cat([q, torch.zeros((V, N_CH - 31), dtype=torch.int8,
                                    device=dev), sbits], dim=1)
    rq = torch.cat([torch.zeros((1, N_CH), dtype=torch.int8, device=dev),
                    row], dim=0)
    ri = torch.zeros(n_rows_total, dtype=torch.int32, device=dev)
    ri[occ] = torch.arange(1, V + 1, dtype=torch.int32, device=dev)
    return rq, ri


def _dequantize(rows_q, row_index, vid):
    """The SH coefficients (M, 27) of voxels `vid` from the int8 table."""
    fq = rows_q[row_index[vid].long()]
    sc = fq[:, N_CH - 4:].contiguous().view(torch.float32)        # (M, 1)
    return fq[:, :27].to(torch.float32) * sc


def cascade_half_extents(cascades: int, scale: float):
    """World half-extent of each cascade's cube: 0.5, 1, 2, ... capped at
    scale (the training grid's nesting)."""
    return [float(min(2.0 ** (c - 1) if c else 0.5, scale))
            for c in range(cascades)]


def bake_field_mc(field_fn, scale: float, cascades: int,
                  resolution: int = 128, occ_masks=None,
                  quantize_colors: bool = True, **bake_kw) -> BakedField:
    """Multi-cascade bake: one B^3 grid per nested cascade cube (bake_field
    at that cascade's half-extent), concatenated into one (C*B^3, 32)
    table. The bounds are the union of the cascades' bounds; the colour
    table (needs occ_masks) spans the concatenated layout."""
    B = resolution
    parts = [bake_field(field_fn, h, resolution=B,
                        occ_mask=None if occ_masks is None else occ_masks[c],
                        quantize_colors=False, **bake_kw)
             for c, h in enumerate(cascade_half_extents(cascades, scale))]
    rows = torch.cat([p.rows for p in parts])
    sigma = torch.cat([p.sigma for p in parts])
    aabb_lo = torch.stack([p.aabb_lo for p in parts]).amin(0)
    aabb_hi = torch.stack([p.aabb_hi for p in parts]).amax(0)
    row_index = rows_q = None
    if quantize_colors and occ_masks is not None:
        occ_idx = np.concatenate(
            [np.nonzero(np.asarray(occ_masks[c]).reshape(-1))[0] + c * B ** 3
             for c in range(cascades)])
        if len(occ_idx):
            rows_q, row_index = quantize_color_table(rows, occ_idx,
                                                     cascades * B ** 3)
    mip_dist = (build_mip_dist_mc(sigma, B, cascades)
                if B % MIP_FACTOR == 0 else None)
    return BakedField(rows=rows, resolution=B, scale=scale, aabb_lo=aabb_lo,
                      aabb_hi=aabb_hi, sigma=sigma, cascades=cascades,
                      row_index=row_index, rows_q=rows_q, mip_dist=mip_dist)


def _resample_dilate(occ_xyz, B: int, G: int, dilate: bool = True):
    """Occupancy (G, G, G) bool numpy -> bake mask (B^3,) bool: resampled to
    the bake's resolution (nearest cell up, any-pool down), then dilated
    by one voxel."""
    if B >= G:
        ci = (np.arange(B) * G) // B
        mask = occ_xyz[np.ix_(ci, ci, ci)]
    else:
        bi = (np.arange(G) * B) // G
        mask = np.zeros((B, B, B), bool)
        np.logical_or.at(mask, np.ix_(bi, bi, bi), occ_xyz)
    if not dilate:
        return mask.reshape(-1)
    p = np.pad(mask, 1)
    d = np.zeros_like(mask)
    for dx in (0, 1, 2):
        for dy in (0, 1, 2):
            for dz in (0, 1, 2):
                d |= p[dx:dx + B, dy:dy + B, dz:dz + B]
    return d.reshape(-1)


def bake_ngp(params, grid_state, cfg, resolution: int = 256,
             n_dirs: int = 32, dtype=torch.float32, chunk: int = None,
             stoch="auto") -> BakedField:
    """Bake a trained NGP on its parameters' device. The voxels are the
    trainer's occupancy resampled to `resolution` and dilated by one
    voxel; several cascades bake one grid each (bake_field_mc).

    stoch ("auto" | True | False): evaluate with stochastic single-corner
    hash gathers, sigma averaged over the directions; "auto" is on except
    on the CPU. The default chunk keeps chunk * n_dirs * gather rows per
    sample at 2^24, as JAX's does, so a stochastic bake visits the same
    chunks (and seeds) as JAX's."""
    from .models.ngp import ngp_forward
    dev = params["hash_table"].device
    use_stoch = stoch is True or (stoch == "auto" and dev.type != "cpu")
    if chunk is None:
        rows_per_sample = cfg.n_levels * (1 if use_stoch else 8)
        chunk = max(1 << 12, (1 << 24) // max(1, n_dirs * rows_per_sample))
    B, G = resolution, cfg.grid_size
    occ = grid_state.occ_flat.cpu().numpy().reshape(cfg.cascades, G, G, G)
    masks = [_resample_dilate(occ[c] > 0, B, G) for c in range(cfg.cascades)]

    if use_stoch:
        def field_fn(x, dirs, seed):
            return ngp_forward(params, x, dirs, cfg, seed=seed)
    else:
        def field_fn(x, dirs):
            return ngp_forward(params, x, dirs, cfg)

    kw = dict(n_dirs=n_dirs, dtype=dtype, chunk=chunk, seeded=use_stoch,
              mean_sigma=use_stoch, device=dev)
    with torch.no_grad():
        if cfg.cascades == 1:
            return bake_field(field_fn, cfg.scale, resolution=B,
                              occ_mask=masks[0], **kw)
        return bake_field_mc(field_fn, cfg.scale, cfg.cascades, resolution=B,
                             occ_masks=masks, **kw)


# --------------------------------------------------------------------------
# Render
# --------------------------------------------------------------------------

def _counter(rounds: int, n: int, device):
    """The jitter counters of one round: (rounds * n + arange(n)) mod 2^32."""
    return (rounds * n + torch.arange(n, device=device)) & 0xFFFFFFFF


def _voxel_coord(x, scale: float, B: int):
    """(x + scale) / (2 scale) * B - 0.5: voxel-centre coordinates."""
    return (x + scale) * _f32_inv(2 * scale) * B - 0.5


def _phase_sizes(N: int, phase_floor: int, phase_max: int,
                 phase_ratio: float):
    """The alive-first phases' sizes: N, then shrinking by phase_ratio
    (rounded up to 256) down to phase_floor, at most phase_max phases."""
    sizes = [N]
    while len(sizes) < phase_max:
        nxt = max(phase_floor,
                  (int(sizes[-1] / phase_ratio) + 255) // 256 * 256)
        if nxt >= sizes[-1]:
            break
        sizes.append(nxt)
    return sizes


def _alive_first(alive):
    """The strict alive-first order of one phase's rays."""
    Np = alive.shape[0]
    key = torch.where(alive, 0, Np) + torch.arange(Np, device=alive.device)
    return torch.argsort(key)


def _run_phases(carry, rays, sizes, alive, make_body, go):
    """Run a round loop over shrinking alive-first prefixes.

    carry: per-ray state tensors; rays: per-ray constants; alive(carry):
    the rays still to march; make_body(rays, Np) -> body(carry, rounds) ->
    carry; go(carry, rounds, next_n) -> bool. Between phases the rays are
    reordered alive-first and the tail is parked; at the end every
    permutation is unwound. Returns (carry, rounds, per-phase
    (cumulative rounds, alive count))."""
    rounds = 0
    perms, tails, anatomy = [], [], []
    for pi, Np in enumerate(sizes):
        next_n = sizes[pi + 1] if pi + 1 < len(sizes) else 0
        body = make_body(rays, Np)
        while go(carry, rounds, next_n):
            carry = body(carry, rounds)
            rounds += 1
        anatomy.append((rounds, int(alive(carry).sum())))
        if next_n:
            perm = _alive_first(alive(carry))
            carry = [c[perm] for c in carry]
            rays = [r[perm] for r in rays]
            perms.append(perm)
            tails.append([c[next_n:] for c in carry])
            carry = [c[:next_n] for c in carry]
            rays = [r[:next_n] for r in rays]
    for perm, tail in zip(reversed(perms), reversed(tails)):
        inv = torch.argsort(perm)
        carry = [torch.cat([c, t])[inv] for c, t in zip(carry, tail)]
    return carry, rounds, anatomy


def _ray_setup(aabb_lo, aabb_hi, rays_o, rays_d, t_far):
    """Unit directions, their norms, and the tight-box hits with the
    optional far clamp (in the caller's ray parameterisation)."""
    dn = torch.clamp(torch.linalg.norm(rays_d, dim=-1, keepdim=True),
                     min=1e-12)
    rays_d = rays_d / dn
    hits = ray_aabb_intersect_single(rays_o, rays_d, (aabb_lo + aabb_hi) / 2,
                                     (aabb_hi - aabb_lo) / 2)
    t1 = torch.clamp(hits[:, 0], min=0.0)
    t2 = hits[:, 1]
    if t_far is not None:
        tf = t_far * dn[:, 0]
        t2 = torch.where(t_far >= 1e-6,
                         torch.maximum(torch.minimum(t2, tf), t1), t2)
    return rays_d, dn, hits, t1, t2


def _split_weights(sig, dts, opacity, in_range, T_threshold: float):
    """Compositing weights of one round from sigma alone (the weight math
    of composite_test_step, per-sample steps)."""
    sd = sig * dts
    sd_excl = torch.cumsum(sd, dim=1) - sd
    T_before = (1.0 - opacity)[:, None] * torch.exp(-sd_excl)
    alpha = 1.0 - torch.exp(-sd)
    included = (T_before > T_threshold) & in_range
    return alpha * T_before * included.to(sig.dtype), T_before


def _window_color(w, ii, sh_p, rows, row_index, rows_q, Wc: int):
    """Colour of one round over each ray's weight support: `Wc` stride-
    adaptive buckets tile [first, last] sample with w > 1e-4; a bucket's
    weight is an exact cumsum difference, its colour the row at its
    centre. Returns the (Np, 3) colour to add."""
    Np, S = w.shape
    sel = w > 1e-4
    any_sel = sel.any(dim=1)
    sel_i = sel.to(torch.uint8)
    start = torch.argmax(sel_i, dim=1)
    last = S - 1 - torch.argmax(sel_i.flip(1), dim=1)
    span = torch.clamp(last - start + 1, min=1)
    stride = (span + Wc - 1) // Wc
    k = torch.arange(Wc, device=w.device)[None, :]
    b0 = start[:, None] + k * stride[:, None]
    b1 = torch.clamp(b0 + stride[:, None], max=S)
    slot_ok = (b0 <= last[:, None]) & any_sel[:, None]
    cw = torch.cumsum(w, dim=1)
    hi_w = torch.gather(cw, 1, torch.clamp(b1 - 1, 0, S - 1))
    lo_w = torch.where(b0 > 0,
                       torch.gather(cw, 1, torch.clamp(b0 - 1, 0, S - 1)),
                       0.0)
    w_slot = (hi_w - lo_w) * slot_ok.to(w.dtype)
    jc = torch.clamp(torch.minimum(b0 + stride[:, None] // 2, last[:, None]),
                     0, S - 1)
    ii_sel = torch.gather(ii, 1, jc).reshape(-1)
    if rows_q is not None:
        sh = _dequantize(rows_q, row_index, ii_sel)
    else:
        sh = rows[ii_sel].to(torch.float32)[:, 1:28]
    sh = sh.reshape(Np, Wc, 3, N_SH)
    rgb_sel = torch.clamp(torch.einsum("nwck,nk->nwc", sh, sh_p), min=0.0)
    return torch.sum(w_slot[..., None] * rgb_sel, dim=1)


def sample_baked(rows, xyz, sh_d, B: int, scale: float, interp: str,
                 jitter=None):
    """Evaluate the baked field at xyz (N, 3); sh_d is sh9_basis of the
    directions, per sample or per ray (then xyz holds (rays, S) samples).
    interp="stochastic" reads one row, the voxel index rounded with the
    (3,) tuple of uniform `jitter` (trilinear in expectation);
    "trilinear" blends the 8 rows."""
    u = _voxel_coord(xyz, scale, B)

    def fetch(ix, iy, iz):
        ii = torch.clamp(ix, 0, B - 1) * (B * B) \
            + torch.clamp(iy, 0, B - 1) * B + torch.clamp(iz, 0, B - 1)
        return rows[ii].to(torch.float32)

    def decode(f):
        sh = f[:, 1:28].reshape(-1, 3, N_SH)
        if sh_d.shape[0] != f.shape[0]:
            S = f.shape[0] // sh_d.shape[0]
            rgb = torch.einsum("nsck,nk->nsc",
                               sh.reshape(sh_d.shape[0], S, 3, N_SH),
                               sh_d).reshape(-1, 3)
        else:
            rgb = torch.einsum("nck,nk->nc", sh, sh_d)
        return f[:, 0], torch.clamp(rgb, min=0.0)

    if interp == "stochastic":
        ids = [torch.floor(u[:, d] + jitter[d]).to(torch.int64)
               for d in range(3)]
        return decode(fetch(*ids))
    i0 = torch.floor(u).to(torch.int64)
    frac = u - torch.floor(u)
    acc = None
    for cx in (0, 1):
        wx = frac[:, 0] if cx else 1.0 - frac[:, 0]
        for cy in (0, 1):
            wy = frac[:, 1] if cy else 1.0 - frac[:, 1]
            for cz in (0, 1):
                wz = frac[:, 2] if cz else 1.0 - frac[:, 2]
                w = (wx * wy * wz)[:, None]
                f = fetch(i0[:, 0] + cx, i0[:, 1] + cy, i0[:, 2] + cz)
                acc = f * w if acc is None else acc + f * w
    return decode(acc)


def _prelude_dist(mip_dist, roc, rdc, t1c, t2c, B: int, scale: float,
                  Sc: int = 8):
    """Distance-stepping coarse prelude: per ray, the first and last
    dilated-occupied supercell probes in [t1c, t2c], sphere-traced on the
    Chebyshev distance field forward and backward at max(D - 1, 1)
    supercells a probe, `Sc` probes a round, unresolved rays compacted to
    N/4 and N/16 prefixes. Returns (any_occ, first_t, last_t)."""
    Fm = MIP_FACTOR
    Bc = -(-B // Fm)
    wd = Fm * 2.0 * scale / B
    Nc = roc.shape[0]
    BIG = 1e30
    K_max = int(np.ceil(2 * np.sqrt(3.0) * scale / wd)) + 2
    hard_rounds = -(-K_max // Sc) + 1
    inv = _f32_inv(2 * scale)

    def cells(p):
        ids = [torch.clamp(torch.floor((p[:, d] + scale) * inv * B), 0, B - 1)
               .to(torch.int64) // Fm for d in range(3)]
        return (ids[0] * Bc + ids[1]) * Bc + ids[2]

    def make_body(rays, Np):
        ro_p, rd_p, t1p, t2p = rays

        def body(carry, rounds):
            tf, tb, first, last, done_f, done_b = carry
            for _ in range(Sc):
                Df = mip_dist[cells(ro_p + tf[:, None] * rd_p)].float()
                hit_f = (Df == 0.0) & ~done_f
                first = torch.where(hit_f, torch.minimum(first, tf), first)
                done_f = done_f | hit_f
                tf = torch.where(done_f, tf,
                                 tf + torch.clamp(Df - 1.0, min=1.0) * wd)
                done_f = done_f | (tf >= t2p)
                Db = mip_dist[cells(ro_p + tb[:, None] * rd_p)].float()
                hit_b = (Db == 0.0) & ~done_b
                last = torch.where(hit_b, torch.maximum(last, tb), last)
                done_b = done_b | hit_b
                tb = torch.where(done_b, tb,
                                 tb - torch.clamp(Db - 1.0, min=1.0) * wd)
                done_b = done_b | (tb <= t1p)
            return [tf, tb, first, last, done_f, done_b]
        return body

    def go(carry, rounds, next_n):
        undone = int((~(carry[4] & carry[5])).sum())
        ok = undone > 0 and rounds < hard_rounds
        return ok and (not next_n or undone > next_n)

    sizes = [Nc]
    while len(sizes) < 3 and sizes[-1] // 4 >= 2048:
        sizes.append(sizes[-1] // 4)
    tf0 = t1c + 0.5 * wd
    tb0 = t2c - 0.5 * wd
    carry = [tf0, tb0, torch.full_like(t1c, BIG), torch.full_like(t1c, -BIG),
             tf0 >= t2c, tb0 <= t1c]
    # a prelude ray stays in front until both marches have resolved
    carry, _, _ = _run_phases(carry, [roc, rdc, t1c, t2c], sizes,
                              lambda c: ~(c[4] & c[5]), make_body, go)
    first, last = carry[2], carry[3]
    f2 = torch.minimum(first, torch.where(last > -BIG / 2, last, BIG))
    l2 = torch.maximum(last, torch.where(first < BIG / 2, first, -BIG))
    return f2 < BIG / 2, f2, l2


def _ladder_prelude(mip, roc, rdc, t1c, t2c, B: int, scale: float,
                    step_c: float):
    """Fixed-stride coarse prelude: probes every `step_c` along [t1c, ...]
    over the cube diagonal; returns (any_occ, first_k, last_k, Kc)."""
    Fm = MIP_FACTOR
    Bc = -(-B // Fm)
    Kc = int(np.ceil(2 * np.sqrt(3.0) * scale / step_c)) + 2
    t_c = t1c[:, None] + (torch.arange(Kc, device=t1c.device) + 0.5) * step_c
    inv = _f32_inv(2 * scale)
    parts = []
    for d in range(3):
        p_d = roc[:, d:d + 1] + t_c * rdc[:, d:d + 1]
        parts.append(torch.clamp(torch.floor((p_d + scale) * inv * B),
                                 0, B - 1).to(torch.int64) // Fm)
    cix = (parts[0] * Bc + parts[1]) * Bc + parts[2]
    occ_c = (mip[cix] > 0) & (t_c < t2c[:, None])
    any_occ = occ_c.any(dim=1)
    occ_i = occ_c.to(torch.uint8)
    first_k = torch.argmax(occ_i, dim=1)
    last_k = Kc - 1 - torch.argmax(occ_i.flip(1), dim=1)
    return any_occ, first_k, last_k


def _block_rays(rays_o, rays_d, t1, t2):
    """Each 2x2 pixel block's first ray and the union of its hitting
    members' intervals (an all-miss block gets an empty interval)."""
    hit4 = (t2 > t1).reshape(-1, 4)
    t1c = torch.where(hit4, t1.reshape(-1, 4), 1e30).amin(dim=1)
    t2c = torch.where(hit4, t2.reshape(-1, 4), -1e30).amax(dim=1)
    return rays_o[0::4], rays_d[0::4], t1c, t2c


def render_baked_uniform(rows, aabb_lo, aabb_hi, rays_o, rays_d, key, *,
                         B: int, scale: float, interp: str = "stochastic",
                         T_threshold: float = 1e-2, n_steps: int = 128,
                         samples_per_round: int = 32, mip=None, sigma=None,
                         color_window: int = 8, block4: bool = False,
                         phase_floor: int = 4096, phase_max: int = 7,
                         phase_ratio: float = 2.0, row_index=None,
                         rows_q=None, t_far=None):
    """Uniform-stepping baked render of one bucket of rays.

    dt spans the tight box diagonal in n_steps; `samples_per_round`
    samples a round. With `mip` a coarse prelude finds each ray's
    occupied interval first (block4: rays come in 2x2 pixel blocks
    and only each block's first ray marches it). With `sigma` and
    interp="stochastic", colour_window > 0 selects the split path: sigma
    for every sample, colour rows only over the weight support
    (_window_color), from rows_q when given. key: the (2,) uint32 threefry
    key whose bits seed the jitter."""
    N = rays_o.shape[0]
    dev = rays_o.device
    use_split = color_window > 0 and sigma is not None \
        and interp == "stochastic"
    rays_d, dn, hits, t1, t2 = _ray_setup(aabb_lo, aabb_hi, rays_o, rays_d,
                                          t_far)
    dt = torch.linalg.norm(aabb_hi - aabb_lo) * _f32_inv(n_steps)
    S = samples_per_round
    seed = int(threefry.bits(key))
    sh_d = sh9_basis(rays_d)

    t_end = t2
    prelude = mip is not None
    if prelude:
        w_c = MIP_FACTOR * 2 * scale / B
        if block4:
            roc, rdc, t1c, t2c = _block_rays(rays_o, rays_d, t1, t2)
            step_c = w_c
        else:
            roc, rdc, t1c, t2c = rays_o, rays_d, t1, t2
            step_c = 2 * w_c
        with record_function("prelude"):
            any_occ, first_k, last_k = _ladder_prelude(
                mip, roc, rdc, t1c, t2c, B, scale, step_c)
        t_start = t1c + (first_k + 0.5).float() * step_c - 1.5 * w_c
        t_end = t1c + (last_k + 0.5).float() * step_c + 1.5 * w_c
        if block4:
            any_occ = any_occ.repeat_interleave(4)
            t_start = t_start.repeat_interleave(4)
            t_end = t_end.repeat_interleave(4)
        t_start = torch.maximum(t_start, t1)
        t_end = torch.minimum(t_end, t2)

    alive0 = (hits[:, 0] > -0.5) & (t2 > t1)
    if prelude:
        alive0 = alive0 & any_occ
        t0v = torch.where(alive0, t_start, t2 + 1.0)
    else:
        t0v = t1
    n_prelude_alive = int(alive0.sum())
    k_half = torch.arange(S, device=dev) + 0.5

    def make_body(rays, Np):
        ro_p, rd_p, sh_p, te_p = rays

        def body(carry, rounds):
            t_cur, opacity, depth, rgb, alive = carry
            ts = t_cur[:, None] + k_half * dt                      # (Np, S)
            flat_x = (ro_p[:, None, :] + ts[..., None] * rd_p[:, None, :]) \
                .reshape(Np * S, 3)
            jitter = None
            if interp == "stochastic":
                jitter = hash_uniform3(_counter(rounds, Np * S, dev), seed,
                                       stream=1)
            in_range = (ts < te_p[:, None]) & alive[:, None]
            if not use_split:
                sig, col = sample_baked(rows, flat_x, sh_p, B, scale,
                                        interp, jitter)
                n_eff = in_range.sum(dim=1)
                sig = torch.where(in_range, sig.reshape(Np, S), 0.0)
                opacity, depth, rgb, still = composite_test_step(
                    sig, col.reshape(Np, S, 3), dt.expand(Np, S), ts, n_eff,
                    opacity, depth, rgb, T_threshold)
            else:
                u = _voxel_coord(flat_x, scale, B)
                ids = [torch.clamp(torch.floor(u[:, d] + jitter[d])
                                   .to(torch.int64), 0, B - 1)
                       for d in range(3)]
                ii = (ids[0] * (B * B) + ids[1] * B + ids[2]).reshape(Np, S)
                sig = torch.where(in_range, sigma[ii], 0.0)
                w, _ = _split_weights(sig, dt, opacity, in_range,
                                      T_threshold)
                opacity = opacity + w.sum(dim=1)
                depth = depth + (w * ts).sum(dim=1)
                rgb = rgb + _window_color(w, ii, sh_p, rows, row_index,
                                          rows_q, color_window)
                still = (1.0 - opacity) > T_threshold
            t_cur = torch.where(alive, t_cur + S * dt, t_cur)
            alive = alive & still & (t_cur < te_p)
            return [t_cur, opacity, depth, rgb, alive]
        return body

    def go(carry, rounds, next_n):
        n_alive = int(carry[4].sum())
        ok = n_alive > 0 and rounds * S < n_steps
        return ok and (not next_n or n_alive > next_n)

    sizes = _phase_sizes(N, phase_floor, phase_max, phase_ratio)
    zeros = torch.zeros(N, device=dev)
    carry = [t0v, zeros, zeros.clone(), torch.zeros((N, 3), device=dev),
             alive0]
    with record_function("march"):
        carry, rounds, anatomy = _run_phases(
            carry, [rays_o, rays_d, sh_d, t_end], sizes, lambda c: c[4],
            make_body, go)
    _, opacity, depth, rgb, _ = carry
    return {"opacity": opacity, "depth": depth / dn[:, 0], "rgb": rgb,
            "rounds": rounds, "n_prelude_alive": n_prelude_alive,
            "phase_rounds": [a[0] for a in anatomy],
            "phase_alive": [a[1] for a in anatomy], "phase_sizes": sizes}


def _mc_voxel_index(x, jitter, B: int, scale: float, cascades: int):
    """Stochastic-trilerp row of multi-cascade tables: the finest cascade
    containing the point, then that cascade's voxel. Returns (M,) int64
    into the concatenated (C*B^3,) layout."""
    c = mip_from_pos(x, cascades)
    h = torch.clamp(torch.exp2(c.to(torch.float32) - 1.0), max=scale)
    ids = []
    for d in range(3):
        u = (x[:, d] + h) / (2.0 * h) * B - 0.5
        ids.append(torch.clamp(torch.floor(u + jitter[d]).to(torch.int64),
                               0, B - 1))
    return ((c * B + ids[0]) * B + ids[1]) * B + ids[2]


def render_baked_mc_uniform(rows, aabb_lo, aabb_hi, rays_o, rays_d, key, *,
                            B: int, scale: float, cascades: int,
                            T_threshold: float = 1e-2,
                            samples_per_round: int = 16, t_far=None,
                            sigma=None, color_window: int = 0,
                            row_index=None, rows_q=None, mip_dist=None):
    """Multi-cascade baked render of one bucket: exponential stepping,
    dt(t) = clip(t * 2/B, inner voxel, outer voxel), so a step tracks the
    local cascade's voxel size, for at most 512 steps; samples read the
    finest cascade holding them. `sigma` + color_window > 0: the split
    colour path; `mip_dist` (build_mip_dist_mc): the distance prelude.
    Alive rays are compacted into halving phases."""
    N = rays_o.shape[0]
    dev = rays_o.device
    S = samples_per_round
    rays_d, dn, hits, t1, t2 = _ray_setup(aabb_lo, aabb_hi, rays_o, rays_d,
                                          t_far)
    seed = int(threefry.bits(key))
    sh_d = sh9_basis(rays_d)
    use_split = color_window > 0 and sigma is not None
    g = 2.0 / B
    dt0 = 2.0 * 0.5 / B
    dt_max = 2.0 * scale / B
    max_rounds = -(-512 // S)

    t_begin, t_end = t1, t2
    alive0 = (hits[:, 0] > -0.5) & (t2 > t1)
    if mip_dist is not None:
        w_c = MIP_FACTOR * 2.0 * scale / B
        with record_function("prelude"):
            any_occ, first_t, last_t = _prelude_dist(
                mip_dist, rays_o, rays_d, t1, t2, B, scale)
        t_begin = torch.clamp(first_t - 1.5 * w_c, min=t1, max=t2)
        t_end = torch.minimum(last_t + 1.5 * w_c, t2)
        alive0 = alive0 & any_occ
    n_prelude_alive = int(alive0.sum())

    def make_body(rays, Np):
        ro_p, rd_p, sh_p, te_p = rays

        def body(carry, rounds):
            t_cur, opacity, depth, rgb, alive = carry
            t, ts, dts = t_cur, [], []
            for _ in range(S):
                dt = torch.clamp(t * g, dt0, dt_max)
                ts.append(t + 0.5 * dt)
                dts.append(dt)
                t = t + dt
            t_next = t
            ts = torch.stack(ts, dim=1)                           # (Np, S)
            dts = torch.stack(dts, dim=1)
            flat_x = (ro_p[:, None, :] + ts[..., None] * rd_p[:, None, :]) \
                .reshape(Np * S, 3)
            jitter = hash_uniform3(_counter(rounds, Np * S, dev), seed,
                                   stream=1)
            ii = _mc_voxel_index(flat_x, jitter, B, scale, cascades)
            in_range = (ts < te_p[:, None]) & alive[:, None]
            if not use_split:
                f = rows[ii].to(torch.float32)
                sig = torch.where(in_range, f[:, 0].reshape(Np, S), 0.0)
                sh = f[:, 1:28].reshape(Np, S, 3, N_SH)
                col = torch.clamp(torch.einsum("nsck,nk->nsc", sh, sh_p),
                                  min=0.0)
                opacity, depth, rgb, still = composite_test_step(
                    sig, col, dts, ts, in_range.sum(dim=1), opacity, depth,
                    rgb, T_threshold)
            else:
                iiNS = ii.reshape(Np, S)
                sig = torch.where(in_range, sigma[iiNS], 0.0)
                w, _ = _split_weights(sig, dts, opacity, in_range,
                                      T_threshold)
                opacity = opacity + w.sum(dim=1)
                depth = depth + (w * ts).sum(dim=1)
                rgb = rgb + _window_color(w, iiNS, sh_p, rows, row_index,
                                          rows_q, color_window)
                still = (1.0 - opacity) > T_threshold
            t_cur = torch.where(alive, t_next, t_cur)
            alive = alive & still & (t_cur < te_p)
            return [t_cur, opacity, depth, rgb, alive]
        return body

    def go(carry, rounds, next_n):
        n_alive = int(carry[4].sum())
        ok = n_alive > 0 and rounds < max_rounds
        return ok and (not next_n or n_alive > next_n)

    sizes = [N]
    while len(sizes) < 7 and sizes[-1] // 2 >= 4096:
        sizes.append(sizes[-1] // 2)
    zeros = torch.zeros(N, device=dev)
    carry = [torch.where(alive0, t_begin, t2 + 1.0), zeros, zeros.clone(),
             torch.zeros((N, 3), device=dev), alive0]
    with record_function("march"):
        carry, rounds, _ = _run_phases(carry, [rays_o, rays_d, sh_d, t_end],
                                       sizes, lambda c: c[4], make_body, go)
    _, opacity, depth, rgb, _ = carry
    return {"opacity": opacity, "depth": depth / dn[:, 0], "rgb": rgb,
            "rounds": rounds, "n_prelude_alive": n_prelude_alive}


def _brick_extract(codes, off):
    """codes (R, 512) uint8, off (R, K) in [0, 512) -> (R, K) int32 codes
    (JAX's lane-masked reduce; a gather here)."""
    return torch.gather(codes, 1, off).to(torch.int32)


def render_baked_bricks(bricks, rows, row_index, rows_q, mip,
                        aabb_lo, aabb_hi, rays_o, rays_d, key, *,
                        B: int, scale: float, dt: float, K: int,
                        T_threshold: float = 1e-2, color_window: int = 8,
                        block4: bool = False, phase_floor: int = 4096,
                        phase_max: int = 7, phase_ratio: float = 2.0,
                        t_far=None):
    """Brick-marching baked render of one bucket: a round reads one
    `sigma_bricks` row per ray (the 8^3 brick under the ray's next sample)
    and evaluates up to K ladder samples inside it from that row; the
    distance lane (512) skips provably empty space in one round; at most
    512 rounds. Opacity and
    depth are exact per sample; colour rides `color_window` opacity-
    quantile buckets (sample weight mass and mean depth), coloured after
    the march with one row read each. `dt` and `K` come from
    brick_render_args."""
    N = rays_o.shape[0]
    dev = rays_o.device
    Wc = color_window
    Fb = BRICK
    Bb = -(-B // Fb)
    vox = 2.0 * scale / B
    rays_d, dn, hits, t1, t2 = _ray_setup(aabb_lo, aabb_hi, rays_o, rays_d,
                                          t_far)
    seed = int(threefry.bits(key))

    w_c = MIP_FACTOR * 2 * scale / B
    if block4:
        roc, rdc, t1c, t2c = _block_rays(rays_o, rays_d, t1, t2)
        step_c = w_c
    else:
        roc, rdc, t1c, t2c = rays_o, rays_d, t1, t2
        step_c = 2 * w_c
    with record_function("prelude"):
        any_occ, first_k, last_k = _ladder_prelude(mip, roc, rdc, t1c, t2c,
                                                   B, scale, step_c)
    t_start = t1c + (first_k + 0.5).float() * step_c - 1.5 * w_c
    t_end = t1c + (last_k + 0.5).float() * step_c + 1.5 * w_c
    if block4:
        any_occ = any_occ.repeat_interleave(4)
        t_start = t_start.repeat_interleave(4)
        t_end = t_end.repeat_interleave(4)
    t_start = torch.maximum(t_start, t1)
    t_end = torch.minimum(t_end, t2)
    alive0 = (hits[:, 0] > -0.5) & (t2 > t1) & any_occ
    t0v = torch.where(alive0, t_start + 0.5 * dt, t2 + 1.0)
    n_prelude_alive = int(alive0.sum())
    inv_dt = _f32_inv(dt)
    inv_2s = _f32_inv(2 * scale)
    ks = torch.arange(K, device=dev)[None, :]
    wcs = torch.arange(Wc, device=dev)[None, None, :]

    def make_body(rays, Np):
        ro_p, rd_p, te_p = rays

        def body(carry, rounds):
            t_cur, opacity, depth, bw, bwt, alive = carry
            pos0 = ro_p + t_cur[:, None] * rd_p
            v0 = torch.clamp(torch.floor((pos0 + scale) * inv_2s * B),
                             0, B - 1).to(torch.int64)
            bidx = v0 // Fb
            codes = bricks[(bidx[:, 0] * Bb + bidx[:, 1]) * Bb + bidx[:, 2]]
            blo = bidx.to(torch.float32) * (Fb * vox) - scale
            bhi = blo + Fb * vox
            far = torch.where(rd_p > 0, bhi, blo)
            tax = torch.where(torch.abs(rd_p) > 1e-9, (far - ro_p) / rd_p,
                              float("inf"))
            t_exit = tax.amin(dim=1)
            d_sk = codes[:, Fb ** 3].to(torch.float32)
            ex = torch.clamp(d_sk - 1.0, min=0.0)[:, None] * (Fb * vox)
            far2 = torch.where(rd_p > 0, bhi + ex, blo - ex)
            tax2 = torch.where(torch.abs(rd_p) > 1e-9,
                               (far2 - ro_p) / rd_p, float("inf"))
            t_exit = torch.where(d_sk >= 1.0, tax2.amin(dim=1), t_exit)
            n_adv = torch.clamp(torch.ceil((t_exit - t_cur) * inv_dt)
                                .to(torch.int64), min=1)
            n_in = torch.clamp(n_adv, max=K)
            n_step = torch.where(d_sk >= 1.0, n_adv, n_in)
            ts = t_cur[:, None] + ks.to(torch.float32) * dt       # (Np, K)
            in_range = (ks < n_in[:, None]) & (ts < te_p[:, None]) \
                & alive[:, None]
            jit3 = hash_uniform3(_counter(rounds, Np * K, dev), seed,
                                 stream=1)
            pos = ro_p[:, None, :] + ts[..., None] * rd_p[:, None, :]
            u = _voxel_coord(pos, scale, B)                       # (Np,K,3)
            offs = []
            for d in range(3):
                idd = torch.floor(u[..., d] + jit3[d].reshape(Np, K)) \
                    .to(torch.int64)
                lo = bidx[:, d:d + 1] * Fb
                idd = torch.minimum(torch.maximum(idd, lo), lo + Fb - 1)
                offs.append(idd - lo)
            off = (offs[0] * Fb + offs[1]) * Fb + offs[2]
            sig = sigma_decode(_brick_extract(codes[:, :Fb ** 3], off))
            sig = torch.where(in_range, sig, 0.0)
            w, T_before = _split_weights(sig, dt, opacity, in_range,
                                         T_threshold)
            opacity = opacity + w.sum(dim=1)
            depth = depth + (w * ts).sum(dim=1)
            b_k = torch.clamp(((1.0 - T_before) * Wc).to(torch.int32),
                              0, Wc - 1)
            ob = (b_k[:, :, None] == wcs).to(w.dtype)
            bw = bw + torch.sum(w[:, :, None] * ob, dim=1)
            bwt = bwt + torch.sum((w * ts)[:, :, None] * ob, dim=1)
            t_cur = torch.where(alive, t_cur + n_step.to(torch.float32) * dt,
                                t_cur)
            alive = alive & ((1.0 - opacity) > T_threshold) & (t_cur < te_p)
            return [t_cur, opacity, depth, bw, bwt, alive]
        return body

    def go(carry, rounds, next_n):
        n_alive = int(carry[5].sum())
        ok = n_alive > 0 and rounds < 512
        return ok and (not next_n or n_alive > next_n)

    sizes = _phase_sizes(N, phase_floor, phase_max, phase_ratio)
    zeros = torch.zeros(N, device=dev)
    carry = [t0v, zeros, zeros.clone(), torch.zeros((N, Wc), device=dev),
             torch.zeros((N, Wc), device=dev), alive0]
    with record_function("march"):
        carry, rounds, anatomy = _run_phases(carry, [rays_o, rays_d, t_end],
                                             sizes, lambda c: c[5],
                                             make_body, go)
    _, opacity, depth, bw, bwt, _ = carry
    with record_function("color"):
        rgb = _bucket_color(rows, row_index, rows_q, rays_o, rays_d, bw, bwt,
                            B, scale)
    return {"opacity": opacity, "depth": depth / dn[:, 0], "rgb": rgb,
            "rounds": rounds, "n_prelude_alive": n_prelude_alive,
            "phase_rounds": [a[0] for a in anatomy],
            "phase_alive": [a[1] for a in anatomy], "phase_sizes": sizes}


def _bucket_color(rows, row_index, rows_q, rays_o, rays_d, bw, bwt, B: int,
                  scale: float):
    """render_baked_bricks' whole-ray colour: one row per opacity bucket at
    its weight-averaged depth, weighted by the bucket's mass."""
    N, Wc = bw.shape
    sh_d = sh9_basis(rays_d)
    t_b = bwt / torch.clamp(bw, min=1e-12)
    ok_b = bw > 1e-4
    pos_b = rays_o[:, None, :] + t_b[..., None] * rays_d[:, None, :]
    vb = torch.clamp(torch.floor(_voxel_coord(pos_b, scale, B) + 0.5),
                     0, B - 1).to(torch.int64)
    vid = ((vb[..., 0] * B + vb[..., 1]) * B + vb[..., 2]).reshape(-1)
    vid = torch.where(ok_b.reshape(-1), vid, 0)
    if rows_q is not None:
        sh = _dequantize(rows_q, row_index, vid)
    else:
        sh = rows[vid].to(torch.float32)[:, 1:28]
    rgb_b = torch.clamp(torch.einsum("nwck,nk->nwc",
                                     sh.reshape(N, Wc, 3, N_SH), sh_d),
                        min=0.0)
    return torch.sum(torch.where(ok_b, bw, 0.0)[..., None] * rgb_b, dim=1)


def brick_render_args(baked: BakedField, n_steps: int = 128):
    """render_baked_bricks' step (the tight box diagonal / n_steps, rounded
    to 4 significant digits) and per-brick sample bound K."""
    lo = baked.aabb_lo.cpu().numpy().astype(np.float64)
    hi = baked.aabb_hi.cpu().numpy().astype(np.float64)
    dt = float(np.linalg.norm(hi - lo)) / n_steps
    dt = float(np.format_float_positional(dt, precision=4, unique=False,
                                          fractional=False))
    vox = 2.0 * baked.scale / baked.resolution
    K = int(np.clip(np.ceil(BRICK * np.sqrt(3.0) * vox / dt) + 1, 2, 24))
    return dt, K


def cull_and_buckets(baked: BakedField, rays_o, rays_d, chunk: int = 1 << 18,
                     img_wh=None):
    """Tight-box cull on the host and power-of-two buckets.

    Returns (buckets, N, blocked): each bucket (sl, ro, rd, n) holds the
    original ray indices `sl` (numpy), the padded rays on the rays' device
    and the valid count. img_wh = (W, H), both even, with row-major rays:
    cull and bucket in 2x2 pixel blocks (a block survives if any member
    hits), four consecutive slots a block, which enables block4. Pad rays
    start far outside the box and point away from it."""
    N = rays_o.shape[0]
    dev = rays_o.device
    ro_np = rays_o.detach().cpu().numpy().astype(np.float32)
    rd_np = rays_d.detach().cpu().numpy().astype(np.float32)
    lo = baked.aabb_lo.cpu().numpy()
    hi = baked.aabb_hi.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / rd_np
        ta = (lo[None, :] - ro_np) * inv
        tb = (hi[None, :] - ro_np) * inv
        t1 = np.maximum(np.minimum(ta, tb).max(axis=1), 0.0)
        t2 = np.maximum(ta, tb).min(axis=1)
    hit = t2 > t1
    blocked = False
    if img_wh is not None:
        W, H = img_wh
        if W * H == N and W % 2 == 0 and H % 2 == 0:
            blk = (np.arange(N).reshape(H // 2, 2, W // 2, 2)
                   .transpose(0, 2, 1, 3).reshape(-1, 4))
            idx0 = blk[hit[blk].any(axis=1)].reshape(-1)
            blocked = True
    if not blocked:
        idx0 = np.where(hit)[0]
    buckets = []
    M = len(idx0)
    if M:
        bucket = min(chunk, _pow2_bucket(M, 4096))
        for i in range(0, M, bucket):
            n = min(bucket, M - i)
            pad = bucket - n
            sl = idx0[i:i + n]
            ro = torch.from_numpy(np.concatenate(
                [ro_np[sl], np.full((pad, 3), 1e6, np.float32)])).to(dev)
            rd = torch.from_numpy(np.concatenate(
                [rd_np[sl], np.ones((pad, 3), np.float32)])).to(dev)
            buckets.append((sl, ro, rd, n))
    return buckets, N, blocked


def render_baked(baked: BakedField, grid_state, rays_o, rays_d, cfg, *,
                 key=None, interp: str = "stochastic",
                 T_threshold: float = 1e-2, n_steps: int = 128,
                 samples_per_round: int = 16, chunk: int = 1 << 18,
                 stats: dict = None, color_window: int = 8, img_wh=None,
                 mesh_depth_map=None, bricks: bool = True,
                 display: bool = False,
                 white_bg: float = 1.0):
    """Full-frame baked render: host cull and buckets, then per bucket
    render_baked_bricks (single cascade, stochastic, colour window, brick
    table present), render_baked_mc_uniform (several cascades) or
    render_baked_uniform. key: a (2,) uint32 threefry key (default
    PRNGKey(0)), split into one seed per bucket as JAX splits it.
    grid_state and cfg are unused (render_test's signature). stats, if a
    dict, receives the frame anatomy (rays, buckets, rounds per bucket).
    display=True returns `rgb_u8` (background blended, clipped, rounded)
    and float16-rounded opacity and depth instead of float rgb."""
    if key is None:
        key = threefry.prng_key(0)
    N = rays_o.shape[0]
    dev = rays_o.device
    opacity = torch.zeros(N, device=dev)
    depth = torch.zeros(N, device=dev)
    if display:
        rgb8 = torch.full((N, 3), int(np.clip(white_bg, 0, 1) * 255 + 0.5),
                          dtype=torch.uint8, device=dev)
    else:
        rgb = torch.zeros((N, 3), device=dev)
    with record_function("cull"):
        buckets, _, blocked = cull_and_buckets(baked, rays_o, rays_d, chunk,
                                               img_wh=img_wh)
    if stats is not None:
        stats.update(n_rays=N, n_aabb_hit=sum(n for *_, n in buckets),
                     bucket=buckets[0][1].shape[0] if buckets else 0,
                     dispatches=len(buckets), rounds=[], n_prelude_alive=[],
                     samples_per_round=samples_per_round)
    keys = threefry.split(key, max(1, len(buckets)))
    mc = baked.cascades > 1
    use_bricks = (bricks and not mc and interp == "stochastic"
                  and color_window > 0 and baked.sigma_bricks is not None)
    if use_bricks:
        dt_b, K_b = brick_render_args(baked, n_steps)
    for (sl, ro, rd, n), k in zip(buckets, keys):
        t_far = None
        if mesh_depth_map is not None:
            t_far = torch.zeros(ro.shape[0], device=dev)
            t_far[:n] = torch.as_tensor(mesh_depth_map,
                                        device=dev)[torch.from_numpy(sl)
                                                    .to(dev)]
        if use_bricks:
            res = render_baked_bricks(
                baked.sigma_bricks, baked.rows, baked.row_index,
                baked.rows_q, baked.mip, baked.aabb_lo, baked.aabb_hi,
                ro, rd, k, B=baked.resolution, scale=baked.scale,
                dt=dt_b, K=K_b, T_threshold=T_threshold,
                color_window=color_window, block4=blocked, t_far=t_far)
        elif mc:
            res = render_baked_mc_uniform(
                baked.rows, baked.aabb_lo, baked.aabb_hi, ro, rd, k,
                B=baked.resolution, scale=baked.scale,
                cascades=baked.cascades, T_threshold=T_threshold,
                samples_per_round=samples_per_round, t_far=t_far,
                sigma=baked.sigma, color_window=color_window,
                row_index=baked.row_index, rows_q=baked.rows_q,
                mip_dist=baked.mip_dist)
        else:
            res = render_baked_uniform(
                baked.rows, baked.aabb_lo, baked.aabb_hi, ro, rd, k,
                B=baked.resolution, scale=baked.scale, interp=interp,
                T_threshold=T_threshold, n_steps=n_steps,
                samples_per_round=samples_per_round, mip=baked.mip,
                sigma=baked.sigma, color_window=color_window, block4=blocked,
                row_index=baked.row_index, rows_q=baked.rows_q, t_far=t_far)
        idx = torch.from_numpy(sl).to(dev)
        if display:
            o = res["opacity"][:n]
            r8 = torch.clamp(res["rgb"][:n] + white_bg * (1.0 - o)[:, None],
                             0.0, 1.0) * 255 + 0.5
            rgb8[idx] = r8.to(torch.uint8)
            opacity[idx] = o.half().float()
            depth[idx] = res["depth"][:n].half().float()
        else:
            opacity[idx] = res["opacity"][:n]
            depth[idx] = res["depth"][:n]
            rgb[idx] = res["rgb"][:n]
        if stats is not None:
            stats["rounds"].append(res["rounds"])
            stats["n_prelude_alive"].append(res["n_prelude_alive"])
    if display:
        return {"opacity": opacity, "depth": depth, "rgb_u8": rgb8}
    return {"opacity": opacity, "depth": depth, "rgb": rgb}
