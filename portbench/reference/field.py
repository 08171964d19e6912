"""The Instant-NGP field in plain PyTorch: multiresolution hash encoding,
degree-4 spherical harmonics and the two bias-free MLPs (Mueller et al.
2022, sections 3-4; the tiny-cuda-nn conventions ngp_pl uses).

Everything is float32 unless `rnd` rounds an operand: the controls pass a
rounding to a lower precision (round_fp8, round_bf16), applied to the table,
to every matmul operand and to every hidden activation, and in the backward
to their gradients. No matmul here may run in TF32 unless a control
asks for it (see `matmul_tf32`).
"""

import contextlib
import math

import torch

PRIME_Y = 2654435761
PRIME_Z = 805459861
U32 = 0xFFFFFFFF


def identity(x):
    return x


class _Round(torch.autograd.Function):
    """A rounding applied to a value and, in the backward, to its
    gradient, as a computation held in that precision both ways does."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fp8(x):
    s = torch.clamp(torch.amax(torch.abs(x)), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def round_bf16(x):
    """bfloat16 rounding of a value and of its gradient."""
    return _Round.apply(x, _bf16)


def round_fp8(x):
    """float8 e4m3 rounding under one per-tensor scale (amax -> 448) of a
    value and of its gradient: the lower-precision step a later change
    might take from bf16."""
    return _Round.apply(x, _fp8)


@contextlib.contextmanager
def matmul_tf32(allow: bool = False):
    """float32 matmuls at full precision (or, with allow=True, in TF32) for
    the duration; the previous settings come back afterwards."""
    m, c = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Grid:
    """Level layout of the hash table: level l has scale s_l = N_min * b^l
    - 1, resolution ceil(s_l) + 1, and is hashed into T rows when its dense
    vertex count exceeds T; b = exp(ln(2048 * scale / N_min) / (L - 1)).
    `primes` are the hash's multipliers of y and z."""

    def __init__(self, scale: float, n_levels: int, n_features: int,
                 log2_hashmap_size: int, base_resolution: int):
        self.L, self.F = n_levels, n_features
        self.T = 1 << log2_hashmap_size
        b = math.exp(math.log(2048 * scale / base_resolution)
                     / (n_levels - 1))
        self.scales, self.res, self.hashed, self.offsets = [], [], [], []
        off = 0
        for lvl in range(n_levels):
            s = base_resolution * b ** lvl - 1.0
            r = int(math.ceil(s)) + 1
            self.scales.append(s)
            self.res.append(r)
            self.hashed.append(r ** 3 > self.T)
            self.offsets.append(off)
            off += self.T if r ** 3 > self.T else r ** 3
        self.rows = off
        self.primes = (PRIME_Y, PRIME_Z)


def _lowbias32(x):
    """The lowbias32 integer finalizer on uint32 values held in int64."""
    def mul(v, c):
        return ((v * (c & 0xFFFF)) + (((v * (c >> 16)) & 0xFFFF) << 16)) & U32
    x = x & U32
    x = x ^ (x >> 16)
    x = mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(counter, seed: int, stream: int):
    """U[0, 1) from the top 24 bits of lowbias32(counter ^ lowbias32(seed +
    stream * golden)): the stochastic-corner estimator's draws."""
    hs = int(_lowbias32(torch.tensor((int(seed) + stream * 0x9E3779B9) & U32,
                                     dtype=torch.int64)))
    h = _lowbias32((counter & U32) ^ hs)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def _corner_rows(grid: Grid, ix, iy, iz, lvl):
    r = grid.res[lvl]
    if grid.hashed[lvl]:
        py, pz = grid.primes
        idx = (ix ^ ((iy * py) & U32) ^ ((iz * pz) & U32)) & (grid.T - 1)
    else:
        idx = ix + iy * r + iz * r * r
    return idx + grid.offsets[lvl]


def encode(table, xn, grid: Grid, seed=None, rnd=identity):
    """Hash-grid features (N, L * F), level-major, of unit-cube points xn
    (N, 3), clamped to [0, 1]. seed None: the trilinear blend of the 8
    corners. seed an int: the stochastic estimator, one corner a level,
    axis d taking its +1 corner when counter_uniform(n * L + l, seed, d + 1)
    < frac_d for row n. Differentiable in table."""
    table = rnd(table)
    x = torch.clamp(xn, 0.0, 1.0)
    n = x.shape[0]
    dev = x.device
    feats = []
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    for lvl in range(grid.L):
        pos = x * grid.scales[lvl] + 0.5
        i0 = torch.clamp(torch.floor(pos), min=0.0)
        i0 = torch.minimum(i0, torch.tensor(float(grid.res[lvl] - 2),
                                            device=dev))
        frac = pos - i0
        i0 = i0.to(torch.int64)
        if seed is None:
            acc = 0.0
            for c in range(8):
                bits = [(c >> (2 - d)) & 1 for d in range(3)]
                w = torch.ones(n, device=dev)
                for d in range(3):
                    w = w * (frac[:, d] if bits[d] else 1.0 - frac[:, d])
                row = _corner_rows(grid, i0[:, 0] + bits[0],
                                   i0[:, 1] + bits[1], i0[:, 2] + bits[2],
                                   lvl)
                acc = acc + w[:, None] * table[row]
            feats.append(acc)
        else:
            ctr = rows * grid.L + lvl
            pick = []
            for d in range(3):
                u = counter_uniform(ctr, int(seed), d + 1)
                pick.append(i0[:, d] + (u < frac[:, d]).to(torch.int64))
            feats.append(table[_corner_rows(grid, *pick, lvl)])
    return torch.cat(feats, dim=1)


def sh_encode(d):
    """Real spherical harmonics of degree 4 (16 values) of unit vectors d."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


def mlp(layers, x, rnd=identity):
    """Bias-free MLP, ReLU between layers; weights stored (in, out)."""
    h = x
    for i, w in enumerate(layers):
        h = rnd(h) @ rnd(w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def trunc_exp(x):
    """exp(x) whose gradient is exp(clamp(x, -15, 15))."""
    return torch.exp(x).detach() + \
        torch.exp(torch.clamp(x, -15.0, 15.0)).detach() * (x - x.detach())


def density(params, x, scale: float, grid: Grid, seed=None, rnd=identity):
    """(sigma (N,), h (N, 16)) at world points x (N, 3)."""
    feats = encode(params["hash_table"], (x + scale) / (2 * scale), grid,
                   seed=seed, rnd=rnd)
    h = mlp(params["sigma_mlp"], feats, rnd)
    return trunc_exp(h[:, 0]), h


def forward(params, x, d, scale: float, grid: Grid, seed=None, rnd=identity):
    """(sigma (N,), rgb (N, 3)) at world points x toward directions d."""
    sigma, h = density(params, x, scale, grid, seed=seed, rnd=rnd)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    rgb = torch.sigmoid(mlp(params["rgb_mlp"],
                            torch.cat([sh_encode(d), h], dim=1), rnd))
    return sigma, rgb
