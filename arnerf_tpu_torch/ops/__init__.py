"""The port's compute ops: plain PyTorch, plus hand-written CUDA kernels for
what the JAX package wrote in Pallas (csrc/)."""
