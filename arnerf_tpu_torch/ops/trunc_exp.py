"""Truncated-gradient exponential (port of arnerf_tpu/ops/trunc_exp.py;
reference: models/custom_functions.py:162-173).

Forward is exp(x); the backward clamps x to [-15, 15] before
exponentiating, preventing gradient explosion from large densities.
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
