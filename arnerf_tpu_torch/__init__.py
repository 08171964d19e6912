"""arnerf_tpu_torch — the PyTorch/CUDA port of arnerf_tpu for NVIDIA Hopper.

The JAX package `arnerf_tpu` is the reference; this package mirrors its
layout and names module by module, so each function's counterpart is found
at the same path. It imports torch and never jax, and nothing of
`arnerf_tpu`.

What is ported so far is the test-time render path: `eval` ->
`rendering.render_test(fast=True)` -> marching, the hash-grid encode, the
fused field head (a hand-written sm_90a CUDA kernel, csrc/fused_head.cu)
and compositing. Kernels are compiled at first use, never on import.
"""

__version__ = "0.1.0"
