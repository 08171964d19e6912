"""Fit the neural glossy-BRDF MLP of the SH shading path (port of the
repository's scripts/train_brdf.py):

  python -m arnerf_tpu_torch.insert.train_brdf [--steps 3000] [--out PATH]
      [--device cpu]

The SH glossy shade is spec = F0 * (s1 . L) + (s2 . L), L the light's SH9
and s1, s2 the MLP's outputs (insert/render_utils.py). With the GGX kernel
K = D G cos_l / (4 cos_v cos_l) and Schlick's w = (1 - h.v)^5, s1 and s2
are the SH projections of K (1 - w) and K w: ggx_kernel_sh estimates them
by Monte Carlo (4,096 sphere directions per configuration) for batches of
512 random (normal, view, roughness) configurations, and the MLP
(insert_models.mlp_skip_init: 2 x 128, the embedded normal and view and
the roughness in) is regressed on them with Adam (lr 1e-3, cosine decay to
1e-5 over the steps). The draws are the JAX script's, from the port's
threefry (the sphere directions on the device); the MLP's initial weights
are the port's own. Runs on the card unless --device cpu. Writes the
port's insert/data/model_brdf3.npz (w_i, b_i) by default, never the JAX
package's.
"""

import argparse
import math
import os
import sys
import time

import numpy as np
import torch

from ..ops import threefry
from .envfit import Adam
from .insert_models import get_embedder, mlp_skip_apply, mlp_skip_init
from .render_utils import geometry_blender
from .sh_math import sh9_basis, sphere_dirs

SH_ORDER = 3
BATCH = 512
OUT = os.path.join(os.path.dirname(__file__), "data",
                   f"model_brdf{SH_ORDER}.npz")


def ggx_kernel_sh(normals, vdirs, roughs, key, n_mc=4096):
    """SH projections (s1, s2) of the GGX kernel for a batch of
    configurations. normals, vdirs: (B, 3) unit; roughs: (B, 1); key: the
    threefry key of the sphere directions. Returns (B, 9), (B, 9)."""
    B = normals.shape[0]
    k1, k2 = threefry.split(key)
    dev = normals.device
    cos_t = 1.0 - 2.0 * threefry.uniform(k1, (B, n_mc), device=dev)
    omega = sphere_dirs(cos_t, threefry.uniform(k2, (B, n_mc), device=dev))
    n = normals[:, None, :]
    v = vdirs[:, None, :]
    m2 = roughs[:, None, :] ** 2

    cos_l = torch.sum(omega * n, -1, keepdim=True)              # (B, M, 1)
    cos_v = torch.clamp(torch.sum(v * n, -1, keepdim=True), min=1e-4)
    h = omega + v
    h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-9)
    cos_h = torch.clamp(torch.sum(h * n, -1, keepdim=True), min=0.0)
    hv = torch.clamp(torch.sum(h * v, -1, keepdim=True), min=0.0)

    denom = cos_h ** 2 * (m2 - 1.0) + 1.0                        # GGX NDF
    D = m2 / (math.pi * denom ** 2 + 1e-9)
    # the Blender-style geometry term, as sg_render_core has it
    G = 1.0 / (geometry_blender(cos_v, roughs[:, None, :]) * 2.0 + 1.0)
    w = (1.0 - hv) ** 5

    K = torch.where(cos_l > 0, D * G / (4.0 * cos_v + 1e-9),
                    torch.zeros_like(cos_l))
    Y = sh9_basis(omega)                                         # (B, M, 9)
    scale = 4 * math.pi / omega.shape[1]
    return (torch.sum(K * (1 - w) * Y, dim=1) * scale,
            torch.sum(K * w * Y, dim=1) * scale)


def batch(key, device):
    """One step's configurations and targets (the JAX script's draws)."""
    k1, k2, k3, k4 = threefry.split(key, 4)
    n = torch.as_tensor(threefry.normal(k1, (BATCH, 3)), device=device)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
    # the view in the upper hemisphere of each normal
    v = torch.as_tensor(threefry.normal(k2, (BATCH, 3)), device=device)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    nv = torch.sum(n * v, -1, keepdim=True)
    v = torch.where(nv < 0.05, -v + 2 * n * nv + 0.1 * n, v)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    rough = torch.as_tensor(threefry.uniform(k3, (BATCH, 1), 0.08, 1.0),
                            device=device)
    s1, s2 = ggx_kernel_sh(n, v, rough, k4)
    return n, v, rough, torch.cat([s1, s2], -1)


def cosine_decay(lr, steps, alpha=1e-2):
    """optax.cosine_decay_schedule(lr, steps, alpha)."""
    def sched(count):
        c = min(count, steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps))
                     + alpha)
    return sched


def train(steps, device="cpu", params=None, key=None, log_every=200):
    """`steps` Adam steps from `params` (default: mlp_skip_init from seed
    42) and the threefry `key` (default PRNGKey(0)). Returns (params,
    per-step losses as floats)."""
    embed_fn, input_ch = get_embedder(3)
    if params is None:
        params = mlp_skip_init(torch.Generator().manual_seed(42),
                               input_ch * 2 + 1, 2 * SH_ORDER ** 2, D=2,
                               W=128, device=device)
    leaves = [t for layer in params["layers"] for t in (layer["w"],
                                                        layer["b"])]
    sched = cosine_decay(1e-3, steps)
    opts = [Adam(t, sched) for t in leaves]
    key = threefry.prng_key(0) if key is None else key
    losses = []
    for i in range(steps):
        key, k = threefry.split(key)
        n, v, rough, target = batch(k, device)
        inp = torch.cat([embed_fn(n), embed_fn(v), rough], -1)
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            loss = torch.mean((mlp_skip_apply(params, inp) - target) ** 2)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g, opt in zip(leaves, grads, opts):
                t.requires_grad_(False)
                t.add_(opt.update(g))
        losses.append(loss.detach())
        if log_every and i % log_every == 0:
            print(f"step {i}/{steps} loss={float(losses[-1]):.5f}",
                  flush=True)
    return params, [float(x) for x in losses]


def save(params, out):
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    blob = {}
    for i, layer in enumerate(params["layers"]):
        blob[f"w_{i}"] = layer["w"].detach().cpu().numpy()
        blob[f"b_{i}"] = layer["b"].detach().cpu().numpy()
    np.savez(out, **blob)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    from ..device import resolve_device
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    params, losses = train(args.steps, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    save(params, args.out)
    print(f"saved neural BRDF -> {args.out} ({args.steps} steps in "
          f"{seconds:.1f} s, loss {losses[0]:.5f} -> {losses[-1]:.5f})",
          flush=True)
    return {"losses": losses, "seconds": seconds, "out": args.out}


if __name__ == "__main__":
    main()
