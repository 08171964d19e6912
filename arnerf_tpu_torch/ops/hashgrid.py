"""Multiresolution hash-grid encoding (port of arnerf_tpu/ops/hashgrid.py;
tinycudann "Grid/Hash", reference: models/networks.py:37-57).

One concatenated (total_entries, F) table holds every level. Levels whose
dense vertex count fits in T = 2^log2_hashmap_size are indexed densely,
the rest with the instant-NGP spatial hash
(x ^ y*2654435761 ^ z*805459861) mod T, which wraps like uint32: the
products are formed in int64 and masked to 32 bits.

Only the exact 8-corner forward is here. The stochastic single-corner
encode and the table gradient come with the training path. The gather
itself is plain tensor indexing; a hand kernel for it is later work.
"""

from dataclasses import dataclass, field
import math

import numpy as np
import torch

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
    scales = torch.tensor(cfg.scales, dtype=torch.float32, device=dev)
    res = torch.tensor(cfg.resolutions, dtype=torch.int64, device=dev)
    hashed = torch.tensor(cfg.hashed, dtype=torch.bool, device=dev)
    offsets = torch.tensor(cfg.offsets, dtype=torch.int64, device=dev)
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


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig) -> torch.Tensor:
    """Exact 8-corner trilinear encode.

    table: (total_entries, F); x: (N, 3) positions in [0, 1]^3 (out-of-range
    is clamped). Returns (N, L*F) features in the table's dtype, level-major
    like tcnn.
    """
    flat, cw, _ = _indices_weights(x, cfg)
    n = x.shape[0]
    feats = table[flat.reshape(-1)].reshape(n, cfg.n_levels, 8,
                                            cfg.n_features)
    w = cw[0] * cw[1] * cw[2]                                        # (N, L, 8)
    out = torch.sum(feats * w[..., None].to(feats.dtype), dim=2)     # (N, L, F)
    return out.reshape(n, cfg.out_dim)
