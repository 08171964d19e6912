"""Occupancy-grid bit packing (port of arnerf_tpu/ops/packbits.py; the
reference's packbits_kernel, models/csrc/raymarching.cu:122-161).

The marchers read the uint8 0/1 grid `occ_flat`; the packed bitfield (8
cells a byte, least significant bit first, the reference's layout) is kept
for checkpoint parity.
"""

import torch

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def packbits(density_grid: torch.Tensor, density_threshold) -> torch.Tensor:
    """(density_grid > threshold) packed LSB-first: (..., N) -> (..., N//8)
    uint8, N divisible by 8."""
    occ = (density_grid > density_threshold).to(torch.int32)
    occ = occ.reshape(*occ.shape[:-1], -1, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=occ.device)
    return torch.sum(occ * w, dim=-1).to(torch.uint8)


def unpackbits(bitfield: torch.Tensor) -> torch.Tensor:
    """Inverse of packbits: (..., M) uint8 -> (..., M*8) uint8 in {0, 1}."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bitfield.device)
    bits = (bitfield[..., None] & w) > 0
    return bits.reshape(*bitfield.shape[:-1], -1).to(torch.uint8)
