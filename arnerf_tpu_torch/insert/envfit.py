"""Environment map -> spherical Gaussians (port of the serving half of
arnerf_tpu/insert/envfit.py; reference insert/envfit.py).

`EnvOptim` is the per-probe direct fit the server runs on every object
move (reference envfit.py:275-297, main.py:348): Adam at lr 0.1 on 32 raw
SGs for `n_iter` steps, warm-started from the last probe's fit. The JAX
package runs the steps as one `lax.scan`; here they are an eager loop of
autograd steps with optax's Adam update written out (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction from count 1). The
amortised CNN fitter (`EnvTrainer`, `sg_net_*`) is not on the serving path
(upstream leaves it off) and is not ported.
"""

import torch

from .sh_math import latlong_dirs as envmap_dirs

TINY = 1e-8


def parse_raw_sg(sg):
    lobes = sg[..., :3] / (torch.linalg.norm(sg[..., :3], dim=-1,
                                             keepdim=True) + TINY)
    return lobes, torch.abs(sg[..., 3:4]), torch.abs(sg[..., -3:])


def trans_raw_sg(sg):
    """Canonicalise raw SG params: unit axis, positive lambda and mu."""
    return torch.cat(parse_raw_sg(sg), dim=-1)


def sg2envmap(lgt_sgs, H, W, upper_hemi=False):
    """Render SGs (n, 7) to a lat-long env map (reference envfit.py:30-56),
    as two matrix products: the lobe cosines (HW, n) and the sum of the
    lobes' colours."""
    dirs = envmap_dirs(H, W, upper_hemi, lgt_sgs.device).reshape(-1, 3)
    lobes, lambdas, mus = parse_raw_sg(lgt_sgs)
    weights = torch.exp(lambdas.T * (dirs @ lobes.T - 1.0))     # (HW, n)
    return (weights @ mus).reshape(H, W, 3)


class Adam:
    """optax.adam / scale_by_adam on one tensor: mu, nu and the count, the
    update -lr(count) * mu_hat / (sqrt(nu_hat) + eps). `lr` is a float or
    a function of the 0-based update count (optax's scale_by_schedule)."""

    def __init__(self, param, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.count = 0

    def update(self, grad):
        """The additive update for `grad` (advances the state)."""
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        self.mu = self.b1 * self.mu + (1 - self.b1) * grad
        self.nu = self.b2 * self.nu + (1 - self.b2) * grad * grad
        mu_hat = self.mu / (1 - self.b1 ** self.count)
        nu_hat = self.nu / (1 - self.b2 ** self.count)
        return -lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)


def fit_sgs(init_sgs, im, n_iter: int):
    """n_iter Adam(0.1) steps on mean((sg2envmap(sgs) - im)^2) from
    init_sgs (envfit.py:58-74). Returns (sgs, per-step losses)."""
    H, W = im.shape[:2]
    sgs = init_sgs.detach().clone()
    opt = Adam(sgs, 1e-1)
    losses = []
    for _ in range(n_iter):
        p = sgs.requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean((sg2envmap(p, H, W) - im) ** 2)
            (g,) = torch.autograd.grad(loss, p)
        sgs = p.detach() + opt.update(g)
        losses.append(loss.detach())
    return sgs, losses


class EnvOptim:
    """Direct per-probe SG fit (reference envfit.py:275-297). The initial
    SGs are standard normals (lambda x 100) drawn from `generator` on the
    CPU, so a seed gives the same start on every device."""

    def __init__(self, num_lgt_sgs=32, n_iter=25, generator=None,
                 device="cpu"):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sgs = torch.randn((num_lgt_sgs, 7), generator=generator)
        sgs[:, 3:4] *= 100.0
        self.init_sgs = sgs.to(device)
        self.n_iter = n_iter
        self.lgt_sgs = self.init_sgs

    def eval(self, im, warm_start=True):
        """im: (H, W, 3) env map -> fitted raw SGs (n, 7)."""
        init = self.lgt_sgs if warm_start else self.init_sgs
        self.lgt_sgs, _ = fit_sgs(init, im, self.n_iter)
        return self.lgt_sgs
