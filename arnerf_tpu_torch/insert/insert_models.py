"""Global-SH inverse rendering: a 9-coefficient global environment light
and a positional-encoded albedo MLP, fitted jointly to planar surface
points (port of arnerf_tpu/insert/insert_models.py; reference
insert/insert_models.py).

Parameters keep the JAX package's layout, {"mlp": {"layers": [{"w",
"b"}, ...], "skips": (...)}, "global_sh": (9, 3)}, and checkpoints its
`mat_sh_{epoch:06d}.npz` layout, so a checkpoint written by either package
loads in the other. Random draws (initial weights, shuffles, the
smoothness jitter) come from torch.Generators; the training step takes its
jitter as an argument so that a test can feed JAX's.
"""

import os

import numpy as np
import torch

from .envfit import Adam
from .render_utils import irradiance_numerical, sh9_irradiance
from .sh_math import sh9_product_93
from .tonemapping import tonemapping_simple


# ---------------------------------------------------------------------------
# NeRF-style positional embedder + skip MLP (reference insert_models.py:14-89)
# ---------------------------------------------------------------------------

def get_embedder(multires, input_dims=3):
    """Returns (embed_fn, out_dim): [x, sin(2^k x), cos(2^k x)]."""
    freqs = 2.0 ** np.arange(multires, dtype=np.float32)
    out_dim = input_dims * (1 + 2 * multires)

    def embed(x):
        parts = [x]
        for f in freqs:
            parts.append(torch.sin(x * float(f)))
            parts.append(torch.cos(x * float(f)))
        return torch.cat(parts, dim=-1)

    return embed, out_dim


def mlp_skip_init(generator, input_ch, output_ch, D=2, W=64, skips=(),
                  device="cpu"):
    """Biased linear stack with optional skip concatenations (reference MLP,
    insert_models.py:14-40); U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights
    drawn on the CPU from `generator`, zero biases."""
    dims_in = []
    d = input_ch
    for i in range(D):
        dims_in.append(d)
        d = W + (input_ch if i in skips else 0)

    def layer(din, dout):
        bound = float(np.sqrt(1.0 / din))
        w = (torch.rand((din, dout), generator=generator) * 2 - 1) * bound
        return {"w": w.to(device), "b": torch.zeros(dout, device=device)}

    layers = [layer(din, W) for din in dims_in] + [layer(d, output_ch)]
    return {"layers": layers, "skips": tuple(skips)}


def mlp_skip_apply(params, x):
    h = x
    skips = params["skips"]
    for i, layer in enumerate(params["layers"][:-1]):
        h = torch.relu(h @ layer["w"] + layer["b"])
        if i in skips:
            h = torch.cat([x, h], dim=-1)
    out = params["layers"][-1]
    return h @ out["w"] + out["b"]


# ---------------------------------------------------------------------------
# global-SH training on precomputed probes (the production path; reference
# train_global_env_prec, insert_models.py:303-415)
# ---------------------------------------------------------------------------

def _log_loss(src, dst):
    return (torch.log((0.2935 + src) / (0.2935 + dst)) * 0.7607) ** 2


def init_global_sh(generator, sh_num=9, device="cpu"):
    """U(-1, 1) coefficients with a U(0, 1) DC, so that the initial
    irradiance is positive (reference create_model, :112-118)."""
    sh = torch.rand((sh_num, 3), generator=generator) * 2 - 1
    sh[0] = torch.rand(3, generator=generator)
    return sh.to(device)


def _leaves(params):
    """The trainable tensors of {"mlp", "global_sh"}, in a fixed order."""
    return [t for layer in params["mlp"]["layers"]
            for t in (layer["w"], layer["b"])] + [params["global_sh"]]


def _with_leaves(params, leaves):
    it = iter(leaves)
    layers = [{"w": next(it), "b": next(it)} for _ in params["mlp"]["layers"]]
    return {"mlp": {"layers": layers, "skips": params["mlp"]["skips"]},
            "global_sh": next(it)}


def prec_loss(params, batch, jitter, embed_fn, *, white_strong: bool,
              hdr_mapping=False, mat_smooth_range=1e-3,
              mat_smooth_weight=0.2, use_probes=True):
    """(total loss, colour loss) of one batch (insert_models.py:105-137).
    jitter: U[0, 1) of the points' shape, for the in-plane smoothness
    probe points."""
    mlp, gsh = params["mlp"], params["global_sh"]
    pts, gt, nrm = batch["pts"], batch["gt"], batch["normal"]
    albedo = torch.sigmoid(mlp_skip_apply(mlp, embed_fn(pts)))
    pts_sh = gsh[None].expand(pts.shape[0], *gsh.shape)
    lg = batch["rgb_shs"] + sh9_product_93(pts_sh, batch["opc_shs"]) \
        if use_probes else pts_sh
    irr = torch.nn.functional.leaky_relu(
        sh9_irradiance(nrm, lg, allow_neg=True), 0.01)
    col = albedo / np.pi * irr
    if hdr_mapping:
        col = tonemapping_simple(col)
    loss_c = torch.mean(_log_loss(col, gt))
    # albedo smoothness on in-plane jitters (reference :380-387)
    near = (jitter * 2 - 1) * mat_smooth_range
    plane_near = pts + near - torch.sum(near * nrm, -1, keepdim=True) * nrm
    albedo_near = torch.sigmoid(mlp_skip_apply(mlp, embed_fn(plane_near)))
    loss_mat = mat_smooth_weight * torch.mean((albedo - albedo_near) ** 2)
    loss_matless = torch.mean(albedo) * 0.2
    w_white = 2.0 if white_strong else 1.0
    loss_white = w_white * torch.mean(
        (gsh - gsh.mean(dim=-1, keepdim=True)) ** 2)
    return loss_c + loss_mat + loss_matless + loss_white, loss_c


class PrecTrainer:
    """The precomputed-probe trainer's step (make_prec_train_step,
    insert_models.py:96-143): optax's scale_by_adam followed by the
    schedule -lrate * 0.1 ** (count // lrate_decay), count 0 at the first
    update, one Adam state per leaf."""

    def __init__(self, params, embed_fn, *, hdr_mapping=False,
                 mat_smooth_range=1e-3, mat_smooth_weight=0.2,
                 use_probes=True, lrate=5e-3, lrate_decay=250):
        self.params = params
        self.embed_fn = embed_fn
        self.loss_kw = dict(hdr_mapping=hdr_mapping,
                            mat_smooth_range=mat_smooth_range,
                            mat_smooth_weight=mat_smooth_weight,
                            use_probes=use_probes)
        schedule = lambda s: lrate * (0.1 ** (s // lrate_decay))  # noqa: E731
        self.opts = [Adam(t, schedule) for t in _leaves(params)]

    def step(self, batch, jitter, white_strong: bool):
        """One update; returns the colour loss (a tensor)."""
        leaves = [t.detach().requires_grad_(True)
                  for t in _leaves(self.params)]
        with torch.enable_grad():
            loss, loss_c = prec_loss(_with_leaves(self.params, leaves), batch,
                                     jitter, self.embed_fn,
                                     white_strong=white_strong,
                                     **self.loss_kw)
            grads = torch.autograd.grad(loss, leaves)
        self.params = _with_leaves(self.params, [
            t.detach() + opt.update(g)
            for t, g, opt in zip(leaves, grads, self.opts)])
        return loss_c.detach()


def load_mat_sh_ckpt(path, device="cpu"):
    """A mat_sh_*.npz -> (params, epoch)."""
    blob = np.load(path, allow_pickle=True)
    flat = {k: torch.as_tensor(blob[k], device=device) for k in blob.files
            if k not in ("epoch", "skips")}
    n_layers = max(int(k.split("_")[1]) for k in flat
                   if k.startswith("w_")) + 1
    params = {"mlp": {"layers": [{"w": flat[f"w_{i}"], "b": flat[f"b_{i}"]}
                                 for i in range(n_layers)],
                      "skips": tuple(int(s) for s in blob["skips"])},
              "global_sh": flat["global_sh"]}
    return params, int(blob["epoch"])


def save_mat_sh_ckpt(model_save_path, params, epoch):
    blob = {"global_sh": params["global_sh"].detach().cpu().numpy(),
            "epoch": np.asarray(epoch),
            "skips": np.asarray(params["mlp"]["skips"], np.int64)}
    for i, layer in enumerate(params["mlp"]["layers"]):
        blob[f"w_{i}"] = layer["w"].detach().cpu().numpy()
        blob[f"b_{i}"] = layer["b"].detach().cpu().numpy()
    np.savez(os.path.join(model_save_path, f"mat_sh_{epoch:06d}.npz"),
             **blob)


def train_global_env_prec(pts, normal, gt, rgb_shs, opc_shs, model_save_path,
                          sh_num=9, generator=None, iters=200,
                          batch=20480 * 16, ckpt_save=400, hdr_mapping=False,
                          downsample_pts_num=None, device="cpu", **kwargs):
    """Train the global SH and albedo MLP against precomputed per-point
    probes: light at p = rgb_sh(p) + TripleProduct(global_sh, opacity_sh(p))
    (reference insert_models.py:303-415). Resumes from the newest
    mat_sh_*.npz in model_save_path. Returns global_sh (9, 3) as numpy.
    `generator` (on `device`) draws the initial weights (on the CPU from
    its seed), the shuffles and the jitter."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_gen = torch.Generator().manual_seed(int(generator.initial_seed()))
    embed_fn, input_ch = get_embedder(4)  # 3 -> 27
    os.makedirs(model_save_path, exist_ok=True)
    ckpts = sorted(f for f in os.listdir(model_save_path)
                   if f.startswith("mat_sh") and f.endswith(".npz"))
    start_epoch = 0
    if ckpts:
        params, start_epoch = load_mat_sh_ckpt(
            os.path.join(model_save_path, ckpts[-1]), device)
        print(f"Load ckpt: {ckpts[-1]} (epoch {start_epoch})")
    else:
        params = {"mlp": mlp_skip_init(init_gen, input_ch, 3, D=2, W=64,
                                       device=device),
                  "global_sh": init_global_sh(init_gen, sh_num, device)}
    trainer = PrecTrainer(
        params, embed_fn, hdr_mapping=hdr_mapping,
        use_probes=rgb_shs is not None,
        **{k: v for k, v in kwargs.items()
           if k in ("mat_smooth_range", "mat_smooth_weight", "lrate",
                    "lrate_decay")})

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    data = {"pts": dev(pts), "gt": dev(gt), "normal": dev(normal)}
    if rgb_shs is not None:
        data["rgb_shs"] = dev(rgb_shs)
        data["opc_shs"] = dev(opc_shs)
    n = data["pts"].shape[0]

    loss_c = float("inf")
    for epoch in range(start_epoch, iters):
        if epoch % 50 == 1 or epoch == start_epoch:
            perm = torch.randperm(n, generator=generator, device=device)
            shuffled = {k: v[perm] for k, v in data.items()}
        for i in range(0, downsample_pts_num or n, batch):
            b = {k: v[i:i + batch] for k, v in shuffled.items()}
            jitter = torch.rand(b["pts"].shape, generator=generator,
                                device=device)
            loss_c = trainer.step(b, jitter, white_strong=epoch < iters * 0.8)
        if epoch % 20 == 0:
            print(f"global-SH epoch {epoch}/{iters} loss={float(loss_c):.4f}")
        if epoch % ckpt_save == 0 and epoch > 0:
            save_mat_sh_ckpt(model_save_path, trainer.params, epoch)
    save_mat_sh_ckpt(model_save_path, trainer.params, iters - 1)
    return trainer.params["global_sh"].cpu().numpy()


def train_global_env(pts, normal, gt, model_save_path, sh_num=9,
                     probe_fn=None, generator=None, iters=200,
                     batch=20480 * 16, hdr_mapping=False, device="cpu",
                     **kwargs):
    """Legacy variant that re-renders probes online through the NeRF
    (reference train_global_env, insert_models.py:140-300); plain Adam.
    probe_fn(pts) -> (raw_rgb (x, c, 3), rays_d (x, c, 3)); when None, the
    global SH lights the points directly. Returns global_sh (9, 3)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_gen = torch.Generator().manual_seed(int(generator.initial_seed()))
    embed_fn, input_ch = get_embedder(2)  # 3 -> 15
    params = {"mlp": mlp_skip_init(init_gen, input_ch, 3, D=2, W=64,
                                   device=device),
              "global_sh": init_global_sh(init_gen, sh_num, device)}
    opts = [Adam(t, kwargs.get("lrate", 5e-3)) for t in _leaves(params)]

    def loss_fn(p, b, jitter, irr):
        albedo = torch.sigmoid(mlp_skip_apply(p["mlp"], embed_fn(b["pts"])))
        if irr is None:
            pts_sh = p["global_sh"][None].expand(b["pts"].shape[0], sh_num, 3)
            irr = torch.nn.functional.leaky_relu(
                sh9_irradiance(b["normal"], pts_sh, allow_neg=True), 0.01)
        col = albedo / np.pi * irr
        if hdr_mapping:
            col = tonemapping_simple(col)
        loss = torch.mean((col - b["gt"]) ** 2)
        near = (jitter * 2 - 1) * 1e-3
        pn = b["pts"] + near - torch.sum(near * b["normal"], -1,
                                         keepdim=True) * b["normal"]
        albedo_n = torch.sigmoid(mlp_skip_apply(p["mlp"], embed_fn(pn)))
        loss = loss + 0.2 * torch.mean((albedo - albedo_n) ** 2)
        gsh = p["global_sh"]
        return loss + 2 * torch.mean((gsh - gsh.mean(-1, keepdim=True)) ** 2)

    def dev(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    data = {"pts": dev(pts), "gt": dev(gt), "normal": dev(normal)}
    n = data["pts"].shape[0]
    for _ in range(iters):
        perm = torch.randperm(n, generator=generator, device=device)
        shuffled = {k: v[perm] for k, v in data.items()}
        for i in range(0, n, batch):
            b = {k: v[i:i + batch] for k, v in shuffled.items()}
            irr = None
            if probe_fn is not None:
                raw_rgb, rays_d = probe_fn(b["pts"] + b["normal"] * 0.01)
                irr = torch.nn.functional.leaky_relu(irradiance_numerical(
                    raw_rgb, rays_d, b["normal"], allow_neg=True), 0.01)
            jitter = torch.rand(b["pts"].shape, generator=generator,
                                device=device)
            leaves = [t.detach().requires_grad_(True)
                      for t in _leaves(params)]
            with torch.enable_grad():
                grads = torch.autograd.grad(
                    loss_fn(_with_leaves(params, leaves), b, jitter, irr),
                    leaves)
            params = _with_leaves(params, [
                t.detach() + opt.update(g)
                for t, g, opt in zip(leaves, grads, opts)])
    return params["global_sh"].cpu().numpy()
