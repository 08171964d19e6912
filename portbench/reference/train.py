"""Instant-NGP training in plain PyTorch: the composite, the loss, one step's
gradient, Adam and the density-grid update (ngp_pl's train.py and
volume-rendering kernels; Mueller et al. 2022, sections 4-5).

The parameters are a dict {"hash_table": (rows, F), "sigma_mlp": [W0,
W1], "rgb_mlp": [V0, V1, V2]}; `named_leaves` lists them as the JAX tree
convention does (keys sorted, lists in order), which is also the order of
an Adam state's moments.
"""

import math

import torch

from . import field, march
from .scene import DENSITY_THRESHOLD


def named_leaves(params) -> list:
    """[(name, tensor)] with keys sorted and list items in order."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, (list, tuple)):
            out += [(f"{k}.{i}", w) for i, w in enumerate(v)]
        else:
            out.append((k, v))
    return out


def composite(sigma, rgb, t, dt, ray, n_rays: int, T_threshold: float):
    """Front-to-back compositing of samples laid out ray after ray: a sample
    counts while the transmittance before it exceeds T_threshold. Returns
    (opacity (N,), rgb (N, 3), depth (N,))."""
    sd = sigma * dt
    cum = torch.cumsum(sd.double(), 0)
    counts = torch.bincount(ray, minlength=n_rays)
    start = torch.cumsum(counts, 0) - counts
    base = torch.where(start[ray] > 0, cum[torch.clamp(start[ray] - 1,
                                                       min=0)], 0.0)
    T = torch.exp(-(cum - sd.double() - base).float())
    w = (1.0 - torch.exp(-sd)) * T * (T > T_threshold)
    z = torch.zeros(n_rays, device=sigma.device)
    return (z.index_add(0, ray, w),
            torch.zeros((n_rays, 3), device=sigma.device).index_add(
                0, ray, w[:, None] * rgb),
            z.index_add(0, ray, w * t))


class Spec:
    """What a step needs of a configuration: the model's sizes and the
    marcher's rules. `cfg` is the configuration file's dict."""

    def __init__(self, cfg: dict):
        self.scale = cfg["scale"]
        self.G = cfg["grid_size"]
        self.cascades = max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)
        self.f = 1 / 256 if self.scale > 0.5 else 0.0
        self.grid = field.Grid(self.scale, cfg["n_levels"], cfg["n_features"],
                               cfg["log2_hashmap_size"],
                               cfg["base_resolution"])
        self.steps = march.Steps(self.f, 1024, self.G, self.scale)
        self.K = self.steps.count(march.NEAR,
                                  march.NEAR + 2 * march.SQRT3 * self.scale)
        self.bg = 1.0 if self.f == 0.0 else 0.0
        self.lr = cfg["lr"]
        self.num_epochs = cfg["num_epochs"]
        self.steps_per_epoch = cfg["steps_per_epoch"]
        self.lambda_opacity = 1e-3


def step_loss(params, batch: dict, occ, spec: Spec, rnd=field.identity):
    """One rank's loss on its rays: batch holds rays_o, rays_d, rgb (B, 3),
    noise (B,), seed (the corner seed, or None for exact corners), m_cap
    and pool (the segment slots of the two-level march, 0 for none).
    Returns (loss, samples demanded)."""
    o, d = batch["rays_o"], batch["rays_d"]
    t1, t2 = march.hits(o, d, spec.scale)
    ray, t, dt, demand = march.train_samples(
        o, d, t1, t2, batch["noise"], occ, spec.steps, spec.K, spec.scale,
        spec.cascades, spec.G, batch["m_cap"], 1024, pool=batch["pool"])
    x = o[ray] + t[:, None] * d[ray]
    sigma, rgb = field.forward(params, x, d[ray], spec.scale, spec.grid,
                               seed=batch["seed"], rnd=rnd)
    opacity, col, _ = composite(sigma, rgb, t, dt, ray, o.shape[0], 1e-4)
    est = col + spec.bg * (1.0 - opacity[:, None])
    rgb_term = ((est - batch["rgb"]) / (est.detach() + 1e-3)) ** 2
    op = opacity + 1e-10
    loss = rgb_term.mean() + (spec.lambda_opacity * (-op * torch.log(op))) \
        .mean()
    return loss, demand


def learning_rate(spec: Spec, count: int) -> float:
    """Cosine annealing stepped per epoch to lr / 30 (ngp_pl train.py)."""
    epoch = min(count // spec.steps_per_epoch, spec.num_epochs)
    eta = spec.lr / 30.0
    return eta + 0.5 * (spec.lr - eta) * (1 + math.cos(math.pi * epoch
                                                       / spec.num_epochs))


@torch.no_grad()
def adam(leaves, grads, mu, nu, count: int, lr: float, b1=0.9, b2=0.999,
         eps=1e-15):
    """One Adam update in place; returns the new count."""
    count += 1
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    for p, g, m, v in zip(leaves, grads, mu, nu):
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return count


def follow(params, mu, nu, count: int, occ, steps: list, spec: Spec,
           rnd=field.identity):
    """Train from (params, Adam mu, nu, count) through `steps`, each a list
    of the ranks' batches whose gradients are averaged, on the occupancy
    grid `occ`. Returns (losses, first gradients {name: tensor}, params
    after the last step {name: tensor}, samples demanded per step)."""
    names = [n for n, _ in named_leaves(params)]
    leaves = [w.detach().clone().requires_grad_(True)
              for _, w in named_leaves(params)]
    p = rebuild(params, leaves)
    mu = [m.clone() for m in mu]
    nu = [v.clone() for v in nu]
    losses, demands, first = [], [], None
    for ranks in steps:
        total = 0.0
        grads = [torch.zeros_like(w) for w in leaves]
        demand = 0
        for b in ranks:
            loss, dem = step_loss(p, b, occ, spec, rnd)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc.add_(g, alpha=1.0 / len(ranks))
            total += float(loss.detach()) / len(ranks)
            demand += dem
        if first is None:
            first = dict(zip(names, grads))
        count = adam(leaves, grads, mu, nu, count,
                     learning_rate(spec, count))
        losses.append(total)
        demands.append(demand)
    return losses, first, dict(zip(names, [w.detach() for w in leaves])), \
        demands


def rebuild(params, leaves):
    """params' structure with `leaves` (named_leaves order) in place."""
    it = iter(leaves)
    out = {}
    for k in sorted(params):
        v = params[k]
        out[k] = [next(it) for _ in v] if isinstance(v, (list, tuple)) \
            else next(it)
    return out


@torch.no_grad()
def grid_update(params, density_grid, idx, jitter, seed, spec: Spec,
                decay: float = 0.95, rnd=field.identity, chunk: int = 1 << 18):
    """The density-grid update (ngp_pl networks.py update_density_grid):
    the density at each drawn cell (idx (C, m) per cascade, None for every
    cell in order), placed by the uniforms `jitter` (C * m, 3) within it,
    evaluated in row blocks of `chunk` whose corner seed is seed + block;
    the grid takes max(decayed, new) where visible (>= 0) and occupancy is
    grid > min(mean positive density, DENSITY_THRESHOLD). Returns (grid
    (C, G^3), occupancy uint8 (C * G^3,))."""
    G, C = spec.G, spec.cascades
    G3 = G ** 3
    dev = density_grid.device
    warm = idx is None
    if warm:
        idx = torch.arange(G3, device=dev).expand(C, G3)
    mip = torch.arange(C, device=dev)[:, None].expand(idx.shape).reshape(-1)
    i = idx.reshape(-1)
    coords = torch.stack([i // (G * G), (i // G) % G, i % G], -1).float()
    s = torch.clamp(torch.exp2(mip.float() - 1.0), max=spec.scale)
    half = (s / G)[:, None]
    xyz = (coords / (G - 1) * 2.0 - 1.0) * (s[:, None] - half) \
        + (jitter * 2.0 - 1.0) * half
    sig = torch.cat([
        field.density(params, xyz[r:r + chunk], spec.scale, spec.grid,
                      seed=None if seed is None else seed + b, rnd=rnd)[0]
        for b, r in enumerate(range(0, xyz.shape[0], chunk))])
    if warm:
        tmp = sig.reshape(C, G3)
    else:
        tmp = torch.zeros(C * G3, device=dev).scatter_reduce_(
            0, mip * G3 + i, sig, reduce="amax").reshape(C, G3)
    g = torch.where(density_grid < 0, density_grid,
                    torch.maximum(density_grid * decay, tmp))
    pos = g > 0
    mean = torch.sum(torch.where(pos, g, 0.0)) / torch.clamp(pos.sum(), min=1)
    thr = torch.clamp(mean, max=DENSITY_THRESHOLD)
    return g, (g > thr).to(torch.uint8).reshape(-1)
