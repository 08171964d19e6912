"""Degree-4 real spherical-harmonics direction encoding (port of
arnerf_tpu/ops/sh.py; tinycudann "SphericalHarmonics", reference:
models/networks.py:59-66). Takes unit direction vectors."""

import torch


def sh_encode(d: torch.Tensor) -> torch.Tensor:
    """d: (..., 3) unit directions -> (..., 16) SH basis values."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z

    out = [
        torch.full_like(x, 0.28209479177387814),          # l=0
        -0.48860251190291987 * y,                          # l=1
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,                           # l=2
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),        # l=3
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(out, dim=-1)
