"""Multiresolution hash-grid encoding (port of arnerf_tpu/ops/hashgrid.py;
tinycudann "Grid/Hash", reference: models/networks.py:37-57).

One concatenated (total_entries, F) table holds every level. Levels whose
dense vertex count fits in T = 2^log2_hashmap_size are indexed densely,
the rest with the instant-NGP spatial hash
(x ^ y*2654435761 ^ z*805459861) mod T, which wraps like uint32: the
products are formed in int64 and masked to 32 bits.

`hashgrid_encode(table, x, cfg, seed=None)` is differentiable:
  * seed=None, the exact 8-corner trilerp: the table gradient is one
    segment sum of the N*L*8 corner updates w*g into the table's global
    rows, passed as (N, L*8) so that the kernel merges a column's runs of
    equal rows (ops/segments.py, exact f32, the hand-written CUDA kernel on
    the card) and the position gradient is the analytic trilinear derivative
    (zero where x was clamped);
  * seed=<uint32>, the stochastic single-corner estimator: each axis picks
    its +1 corner with probability frac_d from the counter hash of
    ops/rng.py, so it picks the JAX package's corners bit for bit given the
    seed. Its table gradient is a segment sum of N*L updates, with
    bf16-rounded values on the card (pack=True, the JAX default); its
    position gradient is zero (the sampled forward is piecewise constant
    in x).
Both backwards recompute the indices instead of saving (N, L, 8) tensors,
as the JAX custom VJPs do. The gather itself is plain tensor indexing; a
hand kernel for it is later work.
"""

from dataclasses import dataclass, field
import math

import numpy as np
import torch

from .rng import hash_uniform
from .segments import segment_sum
from .stepping import fma

_PRIME_Y = 2654435761
_PRIME_Z = 805459861
_U32 = 0xFFFFFFFF

# the 8 trilinear corner offsets, (8, 3)
_CORNERS = np.array(
    [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)], dtype=np.int64
)


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 1.3819  # b = exp(ln(2048*scale/N_min)/(L-1))
    # derived, filled in __post_init__
    scales: tuple = field(default=None)
    resolutions: tuple = field(default=None)
    hashed: tuple = field(default=None)
    offsets: tuple = field(default=None)
    total_entries: int = field(default=None)

    def __post_init__(self):
        T = 1 << self.log2_hashmap_size
        scales, resolutions, hashed, offsets = [], [], [], []
        off = 0
        for l in range(self.n_levels):
            # tcnn convention: scale = b^l * N_min - 1; resolution = ceil(scale)+1
            s = self.base_resolution * (self.per_level_scale ** l) - 1.0
            r = int(math.ceil(s)) + 1
            dense_size = r ** 3
            is_hashed = dense_size > T
            size = T if is_hashed else dense_size
            scales.append(s)
            resolutions.append(r)
            hashed.append(is_hashed)
            offsets.append(off)
            off += size
        object.__setattr__(self, "scales", tuple(scales))
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "hashed", tuple(hashed))
        object.__setattr__(self, "offsets", tuple(offsets))
        object.__setattr__(self, "total_entries", off)

    @property
    def level_sizes(self):
        offs = list(self.offsets) + [self.total_entries]
        return tuple(offs[l + 1] - offs[l] for l in range(self.n_levels))

    @property
    def out_dim(self):
        return self.n_levels * self.n_features


def ngp_growth_factor(scale: float, n_levels: int = 16, n_min: int = 16,
                      max_res_factor: float = 2048.0) -> float:
    """b = exp(ln(2048*scale/N_min)/(L-1)) — reference: models/networks.py:34."""
    return float(np.exp(np.log(max_res_factor * scale / n_min) / (n_levels - 1)))


def hashgrid_init(cfg: HashGridConfig, generator: torch.Generator = None,
                  device="cpu") -> torch.Tensor:
    """U(-1e-4, 1e-4) init, matching tcnn's hash-table initialization
    (drawn on the CPU, so a seed gives the same table on every device)."""
    u = torch.rand((cfg.total_entries, cfg.n_features), generator=generator)
    return (u * 2e-4 - 1e-4).to(device)


def _indices_weights(x: torch.Tensor, cfg: HashGridConfig):
    """Per-sample table rows + trilinear corner weights.

    Returns flat (N, L, 8) int64 rows, cw = 3-tuple of (N, L, 8) per-dim
    corner weights, and the `inside` mask (N, 3) where x wasn't clamped.
    """
    dev = x.device
    scales, res, hashed, offsets = _level_tensors(cfg, dev)
    T_mask = (1 << cfg.log2_hashmap_size) - 1

    inside = (x > 0.0) & (x < 1.0)
    x = torch.clamp(x, 0.0, 1.0)
    res_hi = (res - 2).to(torch.float32)[None, :]
    i0, frac = [], []
    for d in range(3):
        # position in each level's grid, tcnn convention pos = x*s + 0.5
        pos_d = fma(x[:, d:d + 1], scales[None, :], 0.5)             # (N, L)
        # keep the +1 corner in range for dense levels
        i0_d = torch.minimum(torch.clamp(torch.floor(pos_d), min=0.0), res_hi)
        frac.append(pos_d - i0_d)
        i0.append(i0_d.to(torch.int64))

    cb = [torch.as_tensor(_CORNERS[:, d], device=dev) for d in range(3)]
    ix = i0[0][:, :, None] + cb[0][None, None, :]
    iy = i0[1][:, :, None] + cb[1][None, None, :]
    iz = i0[2][:, :, None] + cb[2][None, None, :]

    r = res[None, :, None]
    dense_idx = ix + iy * r + iz * (r * r)
    hash_idx = (ix ^ ((iy * _PRIME_Y) & _U32) ^ ((iz * _PRIME_Z) & _U32)) \
        & T_mask
    idx = torch.where(hashed[None, :, None], hash_idx, dense_idx)
    flat = idx + offsets[None, :, None]                              # (N, L, 8)

    # per-dim corner weights: frac or (1-frac) per corner bit
    cw = tuple(
        torch.where(cb[d][None, None, :] > 0, frac[d][:, :, None],
                    1.0 - frac[d][:, :, None])                        # (N, L, 8)
        for d in range(3))
    return flat, cw, inside


def _level_tensors(cfg: HashGridConfig, dev):
    return (torch.tensor(cfg.scales, dtype=torch.float32, device=dev),
            torch.tensor(cfg.resolutions, dtype=torch.int64, device=dev),
            torch.tensor(cfg.hashed, dtype=torch.bool, device=dev),
            torch.tensor(cfg.offsets, dtype=torch.int64, device=dev))


def _encode_fwd_impl(table, x, cfg: HashGridConfig):
    flat, cw, _ = _indices_weights(x, cfg)
    n = x.shape[0]
    feats = table[flat.reshape(-1)].reshape(n, cfg.n_levels, 8,
                                            cfg.n_features)
    w = cw[0] * cw[1] * cw[2]                                        # (N, L, 8)
    out = torch.sum(feats * w[..., None].to(feats.dtype), dim=2)     # (N, L, F)
    return out.reshape(n, cfg.out_dim)


class _Encode(torch.autograd.Function):
    """Exact encode; the backward follows the JAX package's custom VJP
    (arnerf_tpu/ops/hashgrid.py:189-240)."""

    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(table, x)
        return _encode_fwd_impl(table, x, cfg)

    @staticmethod
    def backward(ctx, gout):
        table, x = ctx.saved_tensors
        cfg = ctx.cfg
        n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
        flat, cw, inside = _indices_weights(x, cfg)
        scales = _level_tensors(cfg, x.device)[0]
        g = gout.reshape(n, L, F).float()
        d_table = d_x = None
        if ctx.needs_input_grad[0]:
            # sum over n of w[n,l,c] * g[n,l,:] into table row flat[n,l,c]:
            # one segment sum of the N*L*8 exact f32 updates (pack=False),
            # as N samples of L*8 updates each
            w = cw[0] * cw[1] * cw[2]
            upd = w[..., None].float() * g[:, :, None, :]          # (N, L, 8, F)
            d_table = segment_sum(flat.reshape(n, L * 8).to(torch.int32),
                                  upd.reshape(-1, F), cfg.total_entries,
                                  pack=False).to(table.dtype)
        if ctx.needs_input_grad[1]:
            feats = table[flat.reshape(-1)].reshape(n, L, 8, F).float()
            s_c = torch.sum(feats * g[:, :, None, :], dim=-1)       # (N, L, 8)
            pe = (cw[1] * cw[2], cw[0] * cw[2], cw[0] * cw[1])
            cols = []
            for d in range(3):
                sign = torch.as_tensor(np.where(_CORNERS[:, d] > 0, 1.0, -1.0),
                                       dtype=torch.float32, device=x.device)
                dfrac = torch.sum(s_c * sign[None, None, :] * pe[d], dim=2)
                cols.append(torch.sum(dfrac * scales[None, :], dim=1))
            d_x = torch.where(inside, torch.stack(cols, dim=-1), 0.0) \
                .to(x.dtype)
        return d_table, d_x, None


def _stoch_indices(x: torch.Tensor, seed: int, cfg: HashGridConfig):
    """One sampled corner row per (sample, level): (N, L) int64 flat rows.
    Axis d takes its +1 corner where hash_uniform(n*L + l, seed, d+1) <
    frac_d (arnerf_tpu/ops/hashgrid.py:273-298)."""
    scales, res, hashed, offsets = _level_tensors(cfg, x.device)
    T_mask = (1 << cfg.log2_hashmap_size) - 1
    n, L = x.shape[0], cfg.n_levels
    x = torch.clamp(x, 0.0, 1.0)
    res_hi = (res - 2).to(torch.float32)[None, :]
    # per-(sample, level) counter for the hash RNG
    lin = torch.arange(n, dtype=torch.int64, device=x.device)[:, None] * L \
        + torch.arange(L, dtype=torch.int64, device=x.device)[None, :]
    idx_axes = []
    for d in range(3):
        pos_d = fma(x[:, d:d + 1], scales[None, :], 0.5)             # (N, L)
        i0_d = torch.minimum(torch.clamp(torch.floor(pos_d), min=0.0), res_hi)
        frac_d = pos_d - i0_d
        bit = hash_uniform(lin, seed, stream=d + 1) < frac_d         # P = frac
        idx_axes.append(i0_d.to(torch.int64) + bit.to(torch.int64))
    ix, iy, iz = idx_axes
    r = res[None, :]
    dense_idx = ix + iy * r + iz * (r * r)
    hash_idx = (ix ^ ((iy * _PRIME_Y) & _U32) ^ ((iz * _PRIME_Z) & _U32)) \
        & T_mask
    return torch.where(hashed[None, :], hash_idx, dense_idx) \
        + offsets[None, :]                                           # (N, L)


class _EncodeStoch(torch.autograd.Function):
    """Stochastic single-corner encode (arnerf_tpu/ops/hashgrid.py:301-343):
    table gradient only; the position gradient is zero."""

    @staticmethod
    def forward(ctx, table, x, seed, cfg):
        ctx.cfg, ctx.seed = cfg, seed
        ctx.table_meta = (table.shape, table.dtype)
        ctx.save_for_backward(x)
        flat = _stoch_indices(x, seed, cfg)
        return table[flat.reshape(-1)].reshape(x.shape[0], cfg.out_dim)

    @staticmethod
    def backward(ctx, gout):
        (x,) = ctx.saved_tensors
        cfg = ctx.cfg
        n, L, F = x.shape[0], cfg.n_levels, cfg.n_features
        d_table = None
        if ctx.needs_input_grad[0]:
            flat = _stoch_indices(x, ctx.seed, cfg)                  # (N, L)
            # on the card the upstream cotangents are rounded to bf16
            # (pack), the quantisation of the JAX package's TPU default; on
            # the CPU the sum is exact, as the JAX package's is there
            d_table = segment_sum(flat.to(torch.int32),
                                  gout.reshape(n * L, F).float(),
                                  cfg.total_entries,
                                  pack=gout.is_cuda).to(ctx.table_meta[1])
        d_x = torch.zeros_like(x) if ctx.needs_input_grad[1] else None
        return d_table, d_x, None, None


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig, seed=None) -> torch.Tensor:
    """Encode positions with the multiresolution hash grid.

    table: (total_entries, F); x: (N, 3) positions in [0, 1]^3 (out-of-range
    is clamped); seed: None for the exact 8-corner trilerp, a uint32 int for
    the stochastic single-corner estimator. Returns (N, L*F) features in the
    table's dtype, level-major like tcnn. Differentiable in table (both
    paths) and x (exact path).
    """
    if seed is None:
        return _Encode.apply(table, x, cfg)
    return _EncodeStoch.apply(table, x, int(seed), cfg)
