"""Fused NGP field head: the sigma MLP and the rgb MLP in one CUDA kernel.

Port of arnerf_tpu/ops/fused_head.py, whose Pallas TPU kernel
`_head_kernel` becomes the hand-written sm_90a kernel in
csrc/fused_head.cu (tinycudann FullyFusedMLP counterpart, reference:
models/networks.py:50-78). Per row:
  h    = (feats @ W0).relu @ W1                      (sigma features, 32->64->16)
  rgb~ = ((sh @ V0a + h @ V0b).relu @ V1).relu @ V2  (rgb head, 32->64->64->3)
Output activations (trunc_exp / sigmoid / HDR heads) stay outside.

`fused_field_head` launches the kernel for CUDA tensors and uses the plain
version `_head_torch` only for CPU tensors; on a CUDA tensor it launches or
raises. Forward only: the render path runs it under torch.no_grad(), and
the gradient comes with the training path. The kernel is built at first
use (build.py), never on import.
"""

import ctypes

import torch

from .. import build

SIGMA_OUT = 16
HEAD_SHAPES = ((32, 64), (64, 16), (32, 64), (64, 64), (64, 3))

# kernel launches since the last reset (plain version calls do not count)
launches = 0


def reset_launches():
    global launches
    launches = 0


def _head_torch(feats, sh, weights, dtype):
    """Plain PyTorch version, with the kernel's cast points (the counterpart
    of _head_xla): operands rounded to `dtype` at each layer input, products
    summed in float32."""
    def q(t):
        return t.to(dtype).float()

    w0, w1, v0, v1, v2 = (q(w) for w in weights)
    h1 = q(torch.relu(q(feats) @ w0))
    h = h1 @ w1
    rin = torch.cat([q(sh), q(h)], dim=-1)
    r1 = q(torch.relu(rin @ v0))
    r2 = q(torch.relu(r1 @ v1))
    return h, r2 @ v2


def _library():
    lib = build.load("fused_head")
    fn = lib.arnerf_fused_head_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.arnerf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.arnerf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"fused_field_head: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"fused_field_head: {name} has dtype {t.dtype}, "
                         f"expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_field_head: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_field_head: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"fused_field_head: {name} must be 16-byte aligned")


def _head_cuda(feats, sh, weights, dtype):
    dev = feats.device
    n = feats.shape[0]
    _check("feats", feats, (n, 32), (torch.float32, torch.bfloat16), dev)
    _check("sh", sh, (n, 16), (torch.float32,), dev)
    for i, (w, shape) in enumerate(zip(weights, HEAD_SHAPES)):
        _check(f"weights[{i}]", w, shape, (torch.float32,), dev)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_field_head: compute dtype {dtype} is not "
                         f"float32 or bfloat16")
    if feats.dtype == torch.bfloat16 and dtype != torch.bfloat16:
        raise ValueError("fused_field_head: bfloat16 feats need the "
                         "bfloat16 compute dtype")
    h = torch.empty((n, SIGMA_OUT), dtype=torch.float32, device=dev)
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return h, rgb
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arnerf_fused_head_forward(
            feats.data_ptr(), sh.data_ptr(),
            *(w.data_ptr() for w in weights), h.data_ptr(), rgb.data_ptr(),
            n, int(feats.dtype == torch.bfloat16),
            int(dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError("fused_field_head launch failed: "
                           + lib.arnerf_cuda_error_string(err).decode())
    global launches
    launches += 1
    return h, rgb


def fused_field_head(feats, sh, weights, dtype=torch.bfloat16):
    """feats (N,32), sh (N,16), weights (W0,W1,V0,V1,V2) ->
    (h (N,16) raw sigma-net output, rgb (N,3) raw rgb-net output), float32.

    CUDA tensors go to the kernel (which takes exactly the full-width
    shapes above); CPU tensors go to the plain version."""
    if feats.device.type == "cpu":
        return _head_torch(feats, sh, weights, dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_field_head: unsupported device {feats.device}")
    return _head_cuda(feats, sh, weights, dtype)


def head_weights_from_params(params):
    """(sigma_mlp [W0,W1], rgb_mlp [V0,V1,V2]) -> kernel weight tuple."""
    return (params["sigma_mlp"][0], params["sigma_mlp"][1],
            params["rgb_mlp"][0], params["rgb_mlp"][1],
            params["rgb_mlp"][2])
