"""3D Morton (Z-order) encode and decode (port of arnerf_tpu/ops/morton.py;
reference: models/csrc/raymarching.cu:35-119, `morton3D` and
`morton3D_invert`): 10-bit coordinates interleaved by the usual
magic-constant bit spreading, in int64 arithmetic (torch has no uint32).

The occupancy grids of both packages are row-major, not Morton-ordered;
these are kept for API parity and for tools that exchange Morton-indexed
grids.
"""

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v so there are two zero bits between each."""
    v = v.to(torch.int64) & _U32
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def _compact_bits(v):
    """Inverse of _expand_bits: every third bit into the low 10 bits."""
    v = v.to(torch.int64) & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x0000FFFF
    return v


def morton3d(coords):
    """(..., 3) integer coordinates, each < 1024 -> (...,) Morton codes."""
    x = _expand_bits(coords[..., 0])
    y = _expand_bits(coords[..., 1])
    z = _expand_bits(coords[..., 2])
    return (x | (y << 1) | (z << 2)).to(torch.int32)


def morton3d_invert(indices):
    """(...,) Morton codes -> (..., 3) int32 coordinates."""
    idx = indices.to(torch.int64) & _U32
    return torch.stack([_compact_bits(idx), _compact_bits(idx >> 1),
                        _compact_bits(idx >> 2)], dim=-1).to(torch.int32)
