"""Operations and bytes the work needs, counted from the samples the inputs
demand and the model's widths, never from a kernel's launch grid, and the
least time the card could take for them (peaks.json).

Per sample of the field (widths from the configuration file):
  * the MLPs: sigma L*F -> H -> S_out and rgb (16 + S_out) -> R -> R -> 3,
    bias-free, 2 FLOPs a multiply-add;
  * the exact hash encode: per level and corner, the weight (2 products)
    and F multiply-adds; the stochastic encode gathers one corner a level
    and does no arithmetic;
  * training: the forward, and the backward's two products of each matmul
    (input and weight gradients), so 3x the MLPs' FLOPs, plus one add per
    table-gradient value (L*F); the grid update evaluates the sigma MLP
    forward on its cells.
"""

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
SH_DIM = 16


def sigma_macs(cfg: dict) -> int:
    enc = cfg["n_levels"] * cfg["n_features"]
    return enc * cfg["sigma_hidden"] + cfg["sigma_hidden"] * cfg["sigma_out"]


def rgb_macs(cfg: dict) -> int:
    r = cfg["rgb_hidden"]
    return (SH_DIM + cfg["sigma_out"]) * r + r * r + r * 3


def field_flops(cfg: dict, exact: bool) -> int:
    """Forward FLOPs of one sample: the MLPs and (exact) the encode."""
    enc = cfg["n_levels"] * 8 * (2 + 2 * cfg["n_features"]) if exact else 0
    return 2 * (sigma_macs(cfg) + rgb_macs(cfg)) + enc


def train_flops(cfg: dict, samples: float, grid_cells: float) -> float:
    """FLOPs of training steps that evaluated `samples` samples (stochastic
    corners) and grid updates that evaluated `grid_cells` cells."""
    per = 3 * 2 * (sigma_macs(cfg) + rgb_macs(cfg)) \
        + cfg["n_levels"] * cfg["n_features"]
    return samples * per + grid_cells * 2 * sigma_macs(cfg)


def view_flops(cfg: dict, samples: float) -> float:
    return samples * field_flops(cfg, exact=True)


def head_bound_s(cfg: dict, rows: float, bf16: bool) -> float:
    """Least time of the fused head over `rows` rows: inputs read once
    (features in the compute type, SH in f32), outputs written once (h and
    rgb in f32); the larger of the FLOP and byte bounds."""
    enc = cfg["n_levels"] * cfg["n_features"]
    nbytes = rows * (enc * (2 if bf16 else 4) + 4 * SH_DIM
                     + 4 * cfg["sigma_out"] + 4 * 3)
    flops = rows * 2 * (sigma_macs(cfg) + rgb_macs(cfg))
    peak = PEAKS["bf16_flops_per_s"] if bf16 else PEAKS["f32_flops_per_s"]
    return max(flops / peak, nbytes / PEAKS["hbm_bytes_per_s"])


def segment_sum_bound_s(cfg: dict, updates: float) -> float:
    """Least time of the table-gradient segment sum over `updates` row
    updates: each update's int32 row and F float32 values read once. The
    touched output rows are left out (their count depends on collisions),
    so the bound is low and the share a lower bound."""
    nbytes = updates * (4 + 4 * cfg["n_features"])
    return nbytes / PEAKS["hbm_bytes_per_s"]
