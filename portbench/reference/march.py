"""Ray marching through an occupancy grid, in plain PyTorch: the step
lattice, the occupancy test and the selection of samples (Instant-NGP
section 4; ngp_pl's raymarching kernels, whose serial step t += dt(t) has
the closed form used here).

The step is dt(t) = clamp(t * f, dt_min, dt_max) with dt_min = sqrt(3) /
max_samples and dt_max = 2 sqrt(3) step_scale / G. Its lattice from t1 is
t1 + k dt_min while t < A = dt_min / f, then geometric with ratio 1 + f up
to B = dt_max / f, then B + k dt_max; with f = 0 it is t1 + k *
min(dt_min, dt_max). The lattice is evaluated in float64 and rounded to
float32 once.
"""

import math

import torch

from .scene import aabb_hits

SQRT3 = math.sqrt(3.0)
NEAR = 0.01


class Steps:
    """The step rule of one marcher: exp factor f, max_samples, grid size G
    and the scale that sets dt_max."""

    def __init__(self, f: float, max_samples: int, G: int,
                 step_scale: float):
        self.f = f
        self.dt_min = SQRT3 / max_samples
        self.dt_max = SQRT3 * 2 * step_scale / G

    def dt(self, t):
        return torch.clamp(t * self.f, self.dt_min, self.dt_max)

    def t(self, t1, k):
        """t(k) of the lattice anchored at t1 (float32 in, float32 out)."""
        t1 = t1.double()
        k = k.double()
        if self.f == 0.0:
            return (t1 + k * min(self.dt_min, self.dt_max)).float()
        dmin = min(self.dt_min, self.dt_max)
        A, B = dmin / self.f, self.dt_max / self.f
        lg = math.log1p(self.f)
        k_A = torch.clamp((A - t1) / dmin, min=0.0)
        t_A = torch.clamp(t1, A, B)
        k_B = k_A + torch.clamp(torch.log(B / torch.clamp(t_A, min=1e-12))
                                / lg, min=0.0)
        return torch.where(
            k <= k_A, t1 + k * dmin,
            torch.where(k <= k_B, t_A * torch.exp((k - k_A) * lg),
                        B + (k - k_B) * self.dt_max)).float()

    def count(self, t_min: float, t_max: float) -> int:
        """Lattice steps that cover [t_min, t_max] from any start >= t_min."""
        dmin = min(self.dt_min, self.dt_max)
        if self.f == 0.0:
            return int(math.ceil((t_max - t_min) / dmin)) + 1
        A, B = dmin / self.f, self.dt_max / self.f
        k = max(0.0, (A - t_min) / dmin)
        t = max(t_min, A)
        if t_max > t:
            k += max(0.0, math.log(min(t_max, B) / t) / math.log1p(self.f))
        if t_max > B:
            k += (t_max - B) / self.dt_max
        return int(math.ceil(k)) + 1


def hits(rays_o, rays_d, scale: float):
    """AABB entry and exit with the near clamp: t1 in [0, NEAR) -> NEAR."""
    t1, t2 = aabb_hits(rays_o, rays_d, scale)
    t1 = torch.where((t1 >= 0) & (t1 < NEAR), NEAR, t1)
    return t1, t2


def occupied(occ, pos, dt, scale: float, cascades: int, G: int):
    """The occupancy bit of each point: its cascade is the larger of the one
    its position's magnitude needs (|x| < 2^(c-1)) and the one its step
    needs (dt < 2^c / G), its cell the point's in that cascade's grid over
    [-min(2^(c-1), scale), +...]^3; occ is laid out [c, x, y, z]."""
    mx = torch.amax(torch.abs(pos), dim=-1)
    c_pos = torch.floor(torch.log2(torch.clamp(mx, min=1e-12))) + 2
    c_dt = torch.floor(torch.log2(torch.clamp(dt * G, min=1e-12))) + 1
    c = torch.clamp(torch.maximum(c_pos, c_dt), 0, cascades - 1)
    bound = torch.clamp(torch.exp2(c - 1.0), max=scale)
    cell = torch.clamp(0.5 * (pos / bound[..., None] + 1.0) * G, 0.0, G - 1.0)
    cell = cell.to(torch.int64)
    c = c.to(torch.int64)
    flat = ((c * G + cell[..., 0]) * G + cell[..., 1]) * G + cell[..., 2]
    return occ[flat] > 0


def coarse_occupancy(occ, G: int, radius: int):
    """The supercell grid of one cascade: 1 where any fine cell of the 8^3
    block, or of the blocks within `radius` of it, is occupied."""
    CG = G // 8
    c = occ[:G ** 3].reshape(CG, 8, CG, 8, CG, 8).amax(dim=(1, 3, 5))
    c = torch.nn.functional.max_pool3d(c.float()[None, None],
                                       2 * radius + 1, 1, radius)
    return (c[0, 0] > 0).reshape(-1)


def dilation_radius(steps: Steps, scale: float, G: int) -> int:
    """Supercells a segment's 8 steps can cross from its start, plus one."""
    worst = steps.dt_max if steps.f > 0 else min(steps.dt_min, steps.dt_max)
    return int(math.floor(7 * worst / (2.0 * min(0.5, scale) / (G // 8)))) + 1


def _allocate(demand, cap: int):
    """floor(demand * min(1, cap / total)) slots a row and its stride."""
    ratio = torch.clamp(cap / torch.clamp(demand.sum(), min=1).float(),
                        max=1.0)
    alloc = torch.floor(demand.float() * ratio).long()
    return alloc, demand.float() / torch.clamp(alloc, min=1).float()


def _first(el, cols):
    """The columns `cols` (N, K) of each row's true entries of `el`, in
    order, padded at the end (with the row's last column)."""
    K = el.shape[1]
    pos = torch.arange(K, device=el.device)[None, :]
    o = torch.sort(torch.where(el, pos, K + pos), dim=1).values
    return torch.gather(cols, 1, torch.clamp(o, max=K - 1))


def train_samples(rays_o, rays_d, t1, t2, noise, occ, steps: Steps, K: int,
                  scale: float, cascades: int, G: int, m_cap: int,
                  s_cap: int, pool: int = 0, ray_chunk: int = 2048):
    """The training march: each ray's occupied lattice points in [t1', t2),
    t1' = t1 + noise * dt(t1), at most s_cap of them, laid out ray after
    ray in one buffer of m_cap slots (a sample's slot numbers its draws in
    the stochastic encoder).

    Thinning, when the batch asks for more than there is room: n_r items
    of ray r in a buffer of `cap` get floor(n_r * cap / sum n) slots, and
    slot j takes the floor(j * stride_r)-th item, stride_r = n_r / slots_r,
    the step widened by stride_r. Samples are thinned so into m_cap. With
    `pool` > 0 (one cascade) a ray's points are looked for only in its
    segments of 8 steps whose start lies in an occupied supercell
    (coarse_occupancy, dilated so that no point is missed), and these
    segments are first thinned so into `pool` segment slots.

    Returns the filled slots (ray (M,), t (M,), dt (M,)) and the total
    demand."""
    dev = rays_o.device
    N = rays_o.shape[0]
    ok = t1 >= 0
    t1p = torch.where(ok, t1 + steps.dt(t1) * noise, t1)
    chunks = [slice(i, i + ray_chunk) for i in range(0, N, ray_chunk)]
    if pool:
        K1 = -(-K // 8)
        coarse = coarse_occupancy(occ, G, dilation_radius(steps, scale, G))
        CG, mb = G // 8, min(0.5, scale)
        ks1 = torch.arange(K1, device=dev)[None, :].expand(N, K1)
        t_seg = steps.t(t1p[:, None], ks1 * 8)
        pos = rays_o[:, None, :] + t_seg[..., None] * rays_d[:, None, :]
        nc = torch.clamp(0.5 * (pos / mb + 1.0) * CG, 0.0, CG - 1.0).long()
        sel = coarse[(nc[..., 0] * CG + nc[..., 1]) * CG + nc[..., 2]] \
            & (t_seg < t2[:, None]) & ok[:, None]
        dseg = sel.sum(dim=1)
        seg_order = _first(sel, ks1)
        alloc_s, stride_s = _allocate(dseg, pool)
    else:
        stride_s = torch.ones(N, device=dev)
    lists, demand = [], []
    for sl in chunks:
        n = t1p[sl].shape[0]
        if pool:
            p = torch.arange(K1, device=dev)[None, :]
            j = torch.minimum(torch.floor(p * stride_s[sl, None]).long(),
                              torch.clamp(dseg[sl, None] - 1, min=0))
            seg = torch.gather(seg_order[sl], 1, j)
            ks = (seg[:, :, None] * 8 + torch.arange(8, device=dev)) \
                .reshape(n, K1 * 8)
            live = (p < alloc_s[sl, None]).repeat_interleave(8, dim=1)
        else:
            ks = torch.arange(K, device=dev)[None, :].expand(n, K)
            live = torch.ones_like(ks, dtype=torch.bool)
        t = steps.t(t1p[sl, None], ks)
        pos = rays_o[sl, None, :] + t[..., None] * rays_d[sl, None, :]
        el = occupied(occ, pos, steps.dt(t), scale, cascades, G) \
            & (t < t2[sl, None]) & ok[sl, None] & live
        demand.append(torch.clamp(el.sum(dim=1), max=s_cap))
        lists.append(_first(el, ks))
    order = torch.cat(lists)
    demand = torch.cat(demand)
    alloc, stride = _allocate(demand, m_cap)
    ray = torch.repeat_interleave(torch.arange(N, device=dev), alloc)
    start = torch.cumsum(alloc, 0) - alloc
    s = torch.arange(len(ray), device=dev) - start[ray]
    j = torch.minimum(torch.floor(s.float() * stride[ray]).long(),
                      demand[ray] - 1)
    t = steps.t(t1p[ray], order[ray, j])
    return ray, t, steps.dt(t) * stride[ray] * stride_s[ray], \
        int(demand.sum())


def view_samples(rays_o, rays_d, occ, steps: Steps, scale: float,
                 cascades: int, G: int, cap: int):
    """The test-time march: each ray's occupied lattice points from its AABB
    entry to its exit, at most `cap`, padded: (t (N, cap), dt (N, cap),
    n (N,))."""
    dev = rays_o.device
    t1, t2 = hits(rays_o, rays_d, scale)
    ok = t1 >= 0
    K = steps.count(NEAR, NEAR + 2 * SQRT3 * scale)
    ks = torch.arange(K, device=dev)
    t = steps.t(t1[:, None], ks[None, :])
    pos = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :]
    el = occupied(occ, pos, steps.dt(t), scale, cascades, G) \
        & (t < t2[:, None]) & ok[:, None]
    n = torch.clamp(el.sum(dim=1), max=cap)
    order = torch.sort(torch.where(el, ks[None, :], K + ks[None, :]),
                       dim=1).values[:, :cap]
    if order.shape[1] < cap:
        order = torch.cat([order, torch.full(
            (order.shape[0], cap - order.shape[1]), 2 * K, device=dev)], 1)
    vmask = torch.arange(cap, device=dev)[None, :] < n[:, None]
    ts = steps.t(t1[:, None], torch.clamp(order, max=K - 1))
    return ts * vmask, steps.dt(ts) * vmask, n
