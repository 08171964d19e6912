"""The Threefry-2x32 key PRNG: the draws `jax.random` makes under its
defaults (threefry2x32 keys, `jax_threefry_partitionable` on), for the few
places where the port must reproduce a JAX draw exactly: the
random-feature LPIPS weights (training/lpips.py), the per-bucket render
seeds of the baked renderer (rendering_baked.py), the amortised SG
fitter's weights and batch order (insert/envfit.py) and the BRDF
regression's draws (insert/train_brdf.py). Keys and draws are numpy
arrays; `uniform(..., device=)` returns the same values as a torch tensor
computed on that device, for draws too large for the host.

A key is a (2,) uint32 array. With the partitionable layout, element i
of a draw of shape `shape` (row-major linear index i) is the block
threefry2x32(key, (i >> 32, i & 0xffffffff)); `split` keeps both output
words as the new key, `bits` xors them. `uniform` and `normal` follow
jax.random's float32 constructions: 23 random mantissa bits under an
exponent of 1, and sqrt(2) * erfinv(u) with XLA's single-precision
erfinv polynomial (M. Giles, "Approximating the erfinv function").

Threefry-2x32 itself: J. Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3", SC 2011 (20 rounds, rotations 13 15 26 6 / 17 29 16 24). It
runs once, in `_blocks`, over int64 torch lanes that hold uint32 values.
"""

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a non-negative seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M32, seed & _M32], np.uint32)


def _blocks(key, n: int, device="cpu"):
    """The Threefry-2x32 output words of counters 0 .. n-1 under `key`
    (counter i the pair (i >> 32, i & 0xffffffff)): two (n,) int64
    tensors on `device` holding uint32 values."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0 = ((i >> 32) + ks[0]) & _M32
    x1 = ((i & _M32) + ks[1]) & _M32
    for r5 in range(5):
        for r in _ROT[r5 % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(r5 + 1) % 3]) & _M32
        x1 = (x1 + ks[(r5 + 2) % 3] + r5 + 1) & _M32
    return x0, x1


def _u32(t, shape):
    return t.numpy().astype(np.uint32).reshape(shape)


def split(key, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) -> (num, 2) uint32."""
    b0, b1 = _blocks(key, num)
    return np.stack([_u32(b0, (num,)), _u32(b1, (num,))], axis=1)


def bits(key, shape=()) -> np.ndarray:
    """jax.random.bits(key, shape, dtype=uint32)."""
    shape = tuple(shape)
    b0, b1 = _blocks(key, int(np.prod(shape, dtype=np.int64)))
    return _u32(b0 ^ b1, shape)


def uniform(key, shape=(), minval=0.0, maxval=1.0, device=None):
    """jax.random.uniform(key, shape) in float32: [minval, maxval), the
    scale and shift one fused multiply-add (rounded once), as XLA's CPU
    backend contracts them. A numpy array, or with `device` the same
    values as a torch tensor computed there."""
    shape = tuple(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    b0, b1 = _blocks(key, int(np.prod(shape, dtype=np.int64)),
                     "cpu" if device is None else device)
    mant = ((b0 ^ b1) >> 9) | 0x3F800000
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    # f * span is exact in float64; the sum rounds once to float32
    out = (f.double() * float(hi - lo) + float(lo)).float()
    out = torch.clamp_min(out, float(lo)).reshape(shape)
    return out if device is not None else out.numpy()


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


def permutation(key, n: int) -> np.ndarray:
    """jax.random.permutation(key, n): arange(n) shuffled by
    ceil(3 ln n / ln(2^32 - 1)) rounds, each splitting the key and sorting
    (stably) by 32 random bits of the round's subkey (jax's _shuffle)."""
    x = np.arange(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(0xFFFFFFFF)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(bits(sub, (n,)), kind="stable")]
    return x
