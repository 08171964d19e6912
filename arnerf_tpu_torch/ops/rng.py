"""Stateless counter-based RNG (port of arnerf_tpu/ops/rng.py).

`hash_u32` is the "lowbias32" integer finalizer and `hash_uniform` maps
(element index, seed, stream) to a uniform in [0, 1) from the top 24 bits.
Given the same seed it draws exactly the JAX package's bits, which is what
makes the stochastic-corner picks of ops/hashgrid.py equal across the two
packages. torch has no uint32 arithmetic, so the values live in int64 and
every product is reduced mod 2^32 (`_mul32`, split so no product leaves the
int64 range). `hash_uniform3` slices one hash into three coarser uniforms
for the baked renderer's per-sample jitter (rendering_baked.py).
"""

import torch

_U32 = 0xFFFFFFFF
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64: the product is
    formed from the 16-bit halves of c, each below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _hash_u32_int(x: int) -> int:
    """lowbias32 of one Python int (the seed's hash, computed on the host so
    no scalar is copied to the device)."""
    x &= _U32
    x ^= x >> 16
    x = (x * _M1) & _U32
    x ^= x >> 15
    x = (x * _M2) & _U32
    return x ^ (x >> 16)


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on uint32 values held in int64 -> int64 in [0, 2^32)."""
    x = x.to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def uniform_from_u32(h: torch.Tensor) -> torch.Tensor:
    """uint32 (in int64) -> float32 uniform in [0, 1) from the top 24 bits."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def hash_uniform(idx: torch.Tensor, seed: int, stream: int = 0):
    """Uniform [0, 1) per element of `idx` (any integer tensor, taken mod
    2^32), decorrelated across the uint32 `seed` and the `stream` id."""
    off = (stream * _GOLDEN) & _U32
    hs = _hash_u32_int(int(seed) + off)
    return uniform_from_u32(hash_u32((idx.to(torch.int64) & _U32) ^ hs))


def hash_uniform3(idx: torch.Tensor, seed: int, stream: int = 0):
    """Three uniforms per element from one hash: its 32 bits cut into
    11/11/10-bit fields (resolution 2^-11, 2^-11, 2^-10), the JAX
    package's render-time jitter, bit for bit."""
    off = (stream * _GOLDEN) & _U32
    hs = _hash_u32_int(int(seed) + off)
    h = hash_u32((idx.to(torch.int64) & _U32) ^ hs)
    u0 = (h & 0x7FF).to(torch.float32) * (2.0 ** -11)
    u1 = ((h >> 11) & 0x7FF).to(torch.float32) * (2.0 ** -11)
    u2 = (h >> 22).to(torch.float32) * (2.0 ** -10)
    return u0, u1, u2
