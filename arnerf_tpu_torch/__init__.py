"""arnerf_tpu_torch — the PyTorch/CUDA port of arnerf_tpu for NVIDIA Hopper.

The JAX package `arnerf_tpu` is the reference; this package mirrors its
layout and names module by module, so each function's counterpart is found
at the same path. It imports torch and never jax, and nothing of
`arnerf_tpu`.

What is ported so far: the test-time render path (`eval` ->
`rendering.render_test(fast=True)` -> marching, the hash-grid encode, the
fused field head, a hand-written sm_90a CUDA kernel in csrc/fused_head.cu,
and compositing), training (`train`, with the segment-sum kernel of
csrc/segment_sum.cu in the hash-grid backward) and the AR insertion
server's network path (`insert.main`). Kernels are compiled at first use,
never on import.
"""

__version__ = "0.1.0"
