"""Small bias-free MLPs (port of arnerf_tpu/models/mlp.py; the reference's
tcnn FullyFusedMLPs, models/networks.py:50-56, 68-78).

Weights are stored (in, out), as in the JAX package, so `x @ w` applies a
layer and converted checkpoints need no transpose.
"""

import numpy as np
import torch


def mlp_init(in_dim: int, hidden: int, out_dim: int, n_hidden: int,
             generator: torch.Generator = None, device="cpu"):
    """He-uniform init of a bias-free MLP: in -> [hidden]*n_hidden -> out."""
    dims = [in_dim] + [hidden] * n_hidden + [out_dim]
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        bound = float(np.sqrt(6.0 / din))
        u = torch.rand((din, dout), generator=generator, dtype=torch.float32)
        layers.append((u * (2 * bound) - bound).to(device))
    return layers


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b with both operands rounded to `dtype` and the products summed
    in float32 — JAX's dot(..., preferred_element_type=float32). A product
    of two bf16 values is exact in float32, so a float32 product of the
    rounded operands is the same function."""
    return a.to(dtype).float() @ b.to(dtype).float()


def mlp_apply(layers, x, out_activation=None, dtype=torch.float32):
    """ReLU between layers; optional output activation ('sigmoid' or None).
    `dtype` is the operand type of each layer; accumulation is float32 and
    the result is float32."""
    h = x.to(dtype)
    for i, w in enumerate(layers):
        h = matmul_f32acc(h, w, dtype)
        if i < len(layers) - 1:
            h = torch.relu(h).to(dtype)
    if out_activation == "sigmoid":
        h = torch.sigmoid(h)
    return h.float()
