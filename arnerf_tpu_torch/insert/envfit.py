"""Environment map -> spherical Gaussians (port of
arnerf_tpu/insert/envfit.py; reference insert/envfit.py).

`EnvOptim` is the per-probe direct fit the server runs on every object
move (reference envfit.py:275-297, main.py:348): Adam at lr 0.1 on 32 raw
SGs for `n_iter` steps, warm-started from the last probe's fit. The JAX
package runs the steps as one `lax.scan`; here they are an eager loop of
autograd steps with optax's Adam update written out (b1 0.9, b2 0.999,
eps 1e-8 outside the square root, bias correction from count 1).

`SGFittingNet` / `EnvTrainer` is the amortised fitter (reference
envfit.py:111-272; upstream leaves it off, NGPInsertor.load_or_train_envmaps
runs it): four 3x3 convolutions, each max-pooled and rectified, and a
linear layer from 128x128 maps to the raw SGs, trained to reproduce a
scene's maps through the SG renderer. Its initial weights and batch order
are the JAX package's draws (ops/threefry.py), its Adam optax's
scale_by_adam with the step -lr * 0.5^(count // 100), and its checkpoints
the JAX package's env_model_{epoch:06d}.npz, so a run starts where the
JAX one starts and either package resumes the other's checkpoints.
"""

import contextlib
import os

import numpy as np
import torch

from ..ops import threefry
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
    """Render SGs (..., n, 7) to lat-long env maps (..., H, W, 3)
    (reference envfit.py:30-56), as two matrix products: the lobe cosines
    (..., HW, n) and the sum of the lobes' colours."""
    dirs = envmap_dirs(H, W, upper_hemi, lgt_sgs.device).reshape(-1, 3) \
        .to(lgt_sgs.dtype)
    lobes, lambdas, mus = parse_raw_sg(lgt_sgs)
    cos = dirs @ lobes.transpose(-1, -2)                        # (..., HW, n)
    weights = torch.exp(lambdas.transpose(-1, -2) * (cos - 1.0))
    return (weights @ mus).reshape(*lgt_sgs.shape[:-2], H, W, 3)


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
        # optax's bias corrections, in float32
        f32 = np.float32
        mu_hat = self.mu / float(f32(1) - f32(self.b1) ** f32(self.count))
        nu_hat = self.nu / float(f32(1) - f32(self.b2) ** f32(self.count))
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


# ---------------------------------------------------------------------------
# the amortised CNN fitter (arnerf_tpu/insert/envfit.py:99-232)
# ---------------------------------------------------------------------------

CONVS = (("conv1", 3, 32), ("conv2", 32, 64), ("conv3", 64, 128),
         ("conv4", 128, 256))
LIN_IN = 256 * 8 * 8          # conv4's 256 channels at 8x8, NCHW order


def sg_net_init(key, output_sg_num=32) -> dict:
    """The JAX sg_net_init's weights from the same threefry key, flat in
    its checkpoint names (`conv1.w` (O, I, 3, 3), `conv1.b`, ...,
    `lin.w` (in, out), `lin.b`): He-normal convolutions with zero biases,
    a N(0, 1e-4) linear layer."""
    ks = threefry.split(np.asarray(key, np.uint32), 5)
    flat = {}
    for k, (name, cin, cout) in zip(ks, CONVS):
        flat[f"{name}.w"] = threefry.normal(k, (cout, cin, 3, 3)) \
            * np.float32(np.sqrt(2.0 / (cin * 9)))
        flat[f"{name}.b"] = np.zeros((cout,), np.float32)
    flat["lin.w"] = threefry.normal(ks[4], (LIN_IN, output_sg_num * 7)) \
        * np.float32(1e-2)
    flat["lin.b"] = np.zeros((output_sg_num * 7,), np.float32)
    return flat


class SGFittingNet(torch.nn.Module):
    """(B, 128, 128, 3) env maps -> (B, n_sg, 7) raw SGs (reference
    SGFittingNet, envfit.py:111-135): four 3x3 SAME convolutions
    (3 -> 32 -> 64 -> 128 -> 256), each followed by a 2x2 max-pool and
    then a ReLU, as the JAX _conv_pool orders them, and a linear layer on
    the NCHW flattening."""

    def __init__(self, output_sg_num=32):
        super().__init__()
        self.n_sg = output_sg_num
        for name, cin, cout in CONVS:
            setattr(self, name, torch.nn.Conv2d(cin, cout, 3, padding=1))
        self.lin = torch.nn.Linear(LIN_IN, output_sg_num * 7)

    def forward(self, im):
        x = im.permute(0, 3, 1, 2)
        for name, _, _ in CONVS:
            x = torch.relu(torch.nn.functional.max_pool2d(
                getattr(self, name)(x), 2))
        out = self.lin(x.reshape(x.shape[0], -1))
        return out.reshape(im.shape[0], self.n_sg, 7)


def sg_net_from_jax(params, device="cpu") -> SGFittingNet:
    """A JAX fitter's weights (its nested params dict, or the flat
    checkpoint names) -> SGFittingNet on `device`."""
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        elif k not in ("n_sg", "epoch"):
            flat[k] = v
    net = SGFittingNet(np.asarray(flat["lin.b"]).shape[0] // 7)
    with torch.no_grad():
        for name, _, _ in CONVS:
            conv = getattr(net, name)
            conv.weight.copy_(torch.from_numpy(np.array(flat[f"{name}.w"])))
            conv.bias.copy_(torch.from_numpy(np.array(flat[f"{name}.b"])))
        net.lin.weight.copy_(torch.from_numpy(np.array(flat["lin.w"])).T)
        net.lin.bias.copy_(torch.from_numpy(np.array(flat["lin.b"])))
    return net.to(device)


def sg_net_to_jax(net: SGFittingNet) -> dict:
    """SGFittingNet -> the flat JAX checkpoint names, float32 numpy."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)
    flat = {}
    for name, _, _ in CONVS:
        conv = getattr(net, name)
        flat[f"{name}.w"] = host(conv.weight)
        flat[f"{name}.b"] = host(conv.bias)
    flat["lin.w"] = np.ascontiguousarray(host(net.lin.weight).T)
    flat["lin.b"] = host(net.lin.bias)
    return flat


@contextlib.contextmanager
def _full_f32():
    """The fitter's convolutions and products in full float32 on the card:
    cuDNN would run f32 convolutions in TF32 (10-bit mantissas) by default
    on an H100, which puts a step's gradients 1e-3 to 3e-2 (relative) off
    a float64 step, against ~1e-6 in full float32 on the card as on the
    CPU (chip_smoke.py --envfit-precision). The fitter is small (~1.5
    GFLOP per 128x128 map and step), so full f32 costs little and keeps
    the card's steps to the CPU's and the JAX package's to float32
    rounding."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


class EnvTrainer:
    """Amortised SG fitting over a scene's env maps (reference
    envfit.py:166-272): trains SGFittingNet to reproduce each map through
    the SG renderer, mean squared error over batches of `batch_size`.

    As the JAX EnvTrainer: the initial weights are sg_net_init(key); each
    epoch splits the key and permutes the maps with jax.random.permutation
    (threefry.permutation); the last batch of an epoch is partial; Adam is
    optax's scale_by_adam (b1 0.9, b2 0.999, eps 1e-8) times the step
    -lr * 0.5^(count // 100), count the number of updates so far (so the
    rate halves every 100 steps, not every 100 epochs); the state lives on
    the trainer, so a second train() on it keeps Adam's moments, while a
    new trainer resuming from a checkpoint starts Adam and the schedule
    afresh (the checkpoints hold no optimizer state)."""

    def __init__(self, envmaps, output_sg_num=32, key=None, lr=4e-4,
                 device="cpu"):
        self.key = threefry.prng_key(0) if key is None \
            else np.asarray(key, np.uint32)
        self.device = torch.device(device)
        self.lr = lr
        self.params = sg_net_from_jax(sg_net_init(self.key, output_sg_num),
                                      self.device)
        self.envmaps = torch.as_tensor(np.asarray(envmaps, np.float32),
                                       device=self.device)
        self._adam = None

    def _schedule(self, count):
        return self.lr * 0.5 ** (count // 100)

    def step(self, batch):
        """One Adam step on `batch` (B, 128, 128, 3); returns the loss."""
        net = self.params
        if self._adam is None:
            self._adam = [Adam(p.detach(), self._schedule)
                          for p in net.parameters()]
        with _full_f32(), torch.enable_grad():
            sgs = net(batch)
            ims = sg2envmap(sgs, 128, 128)
            loss = torch.mean((ims - batch) ** 2)
            grads = torch.autograd.grad(loss, list(net.parameters()))
        with torch.no_grad():
            for p, g, opt in zip(net.parameters(), grads, self._adam):
                p.add_(opt.update(g))
        return loss.detach()

    def train(self, epochs=200, batch_size=16, ckpt_dir=None,
              ckpt_every=100):
        """Train to `epochs`, resuming from the newest env_model_*.npz in
        `ckpt_dir` (if any) and checkpointing every `ckpt_every` epochs
        and at the end. Returns the last batch's loss (inf when no step
        ran)."""
        n = self.envmaps.shape[0]
        start = 0
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            ckpts = sorted(f for f in os.listdir(ckpt_dir)
                           if f.startswith("env_model_"))
            if ckpts:
                with np.load(os.path.join(ckpt_dir, ckpts[-1])) as blob:
                    loaded = sg_net_from_jax(dict(blob), self.device)
                    start = int(blob["epoch"])
                self.params.load_state_dict(loaded.state_dict())
        loss = float("inf")
        for epoch in range(start, epochs):
            self.key, k = threefry.split(self.key)
            perm = torch.as_tensor(threefry.permutation(k, n),
                                   device=self.device)
            for i in range(0, n, batch_size):
                loss = self.step(self.envmaps[perm[i:i + batch_size]])
            if ckpt_dir and (epoch + 1) % ckpt_every == 0:
                self.save(ckpt_dir, epoch + 1)
        if ckpt_dir:
            self.save(ckpt_dir, epochs)
        return float(loss)

    def save(self, ckpt_dir, epoch):
        """env_model_{epoch:06d}.npz: the flat weights and `epoch`."""
        np.savez(os.path.join(ckpt_dir, f"env_model_{epoch:06d}.npz"),
                 epoch=np.asarray(epoch), **sg_net_to_jax(self.params))

    @torch.no_grad()
    def eval(self, im):
        """im: (128, 128, 3) env map -> its raw SGs (n_sg, 7)."""
        with _full_f32():
            return self.params(torch.as_tensor(
                im, dtype=torch.float32, device=self.device)[None])[0]
