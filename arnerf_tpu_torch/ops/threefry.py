"""The Threefry-2x32 key PRNG in numpy: the draws `jax.random` makes under
its defaults (threefry2x32 keys, `jax_threefry_partitionable` on), for
the few places where the port must reproduce a JAX draw exactly: the
random-feature LPIPS weights (training/lpips.py) and the per-bucket
render seeds of the baked renderer (rendering_baked.py).

A key is a (2,) uint32 array. With the partitionable layout, element i
of a draw of shape `shape` (row-major linear index i) is the block
threefry2x32(key, (i >> 32, i & 0xffffffff)); `split` keeps both output
words as the new key, `bits` xors them. `uniform` and `normal` follow
jax.random's float32 constructions: 23 random mantissa bits under an
exponent of 1, and sqrt(2) * erfinv(u) with XLA's single-precision
erfinv polynomial (M. Giles, "Approximating the erfinv function").

Threefry-2x32 itself: J. Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011 (20 rounds, rotations 13 15 26 6 / 17 29 16 24).
"""

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block function: key (2,) uint32, counters x0, x1
    (uint32 arrays of one shape) -> the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a non-negative seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _blocks(key, shape):
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0.reshape(shape), b1.reshape(shape)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) -> (num, 2) uint32."""
    b0, b1 = _blocks(key, (num,))
    return np.stack([b0, b1], axis=1)


def bits(key, shape=()) -> np.ndarray:
    """jax.random.bits(key, shape, dtype=uint32)."""
    b0, b1 = _blocks(key, tuple(shape))
    return b0 ^ b1


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape) in float32: [minval, maxval)."""
    b = bits(key, shape)
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, f * (hi - lo) + lo).astype(np.float32)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def erfinv_f32(x) -> np.ndarray:
    """XLA's float32 erfinv: the degree-8 Giles polynomial in w = -log1p(-x^2)
    (w < 5: in w - 2.5; else in sqrt(w) - 3), each Horner step one fused
    multiply-add, as the CPU backend contracts it."""
    x = np.asarray(x, np.float32).astype(np.float64)
    w = _f32(-np.log1p(_f32(-(x * x))))
    lt = w < 5.0
    v = np.where(lt, _f32(w - 2.5), _f32(_f32(np.sqrt(w)) - 3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    p = _f32(p)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = _f32(np.where(lt, a, b))
        p = _f32(p * v + c)        # exact product in f64, one rounding
    out = _f32(p * x)
    out = np.where(np.abs(x) == 1.0, x * np.inf, out)
    return out.astype(np.float32)


def normal(key, shape=()) -> np.ndarray:
    """jax.random.normal(key, shape) in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2.0)) * erfinv_f32(u)).astype(np.float32)
