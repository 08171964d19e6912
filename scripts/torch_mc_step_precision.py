#!/usr/bin/env python3
"""How far float32 gradients of one multi-cascade training step lie from
float64 ones, in the JAX package and in the port (CPU, a few seconds):
the evidence behind the batches tests/test_torch_train_mc.py uses.

    JAX_PLATFORMS=cpu python3 scripts/torch_mc_step_precision.py [scale] [rays]

The step of test_multi_cascade_training_step_matches_jax (exact corners,
exp stepping, black background, the relative rgb loss) at `scale`
(default 2.0) on `rays` pixels (default 96). JAX runs with
jax_enable_x64, so its noise is drawn in float64 for both of its runs;
the port gets that noise rounded to float32. Printed per gradient leaf,
each relative to the leaf's largest entry: JAX float32 against JAX
float64, the port (float32) against JAX float64, and the port against
itself with its rays permuted (its own summation-order noise), and each
run's sample count. A float64 run can also place a sample differently
(a different count, or the same count with other cells): then every
float32 run differs from it alike, and the comparison says nothing about
rounding.
"""

import os
import sys

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import test_torch_train_mc as T  # noqa: E402


def rel(a, b):
    return [f"{np.abs(x - y).max() / np.abs(y).max():.1e}"
            for x, y in zip(a, b)]


def main():
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 2.0
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 96
    kw = dict(scale=scale, fused_head=False, **T.SMALL)
    jcfg, tcfg = T.JConfig(**kw), T.NGPConfig(**kw)
    jp32 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float32),
                        T.j_init(jax.random.PRNGKey(2), jcfg))
    occ = T.analytic_occupancy(scale, 32, jcfg.cascades).numpy()
    js = T.j_grid_init(jcfg)._replace(occ_flat=jnp.asarray(occ))
    ro, rd, gt = T._batch(scale, n=n)
    key = jax.random.PRNGKey(11)
    lc = T.j_losses.NeRFLossConfig(grid_scale=scale)

    def jax_grads(params, dtype):
        def loss(p):
            res = T.j_render_train(
                p, js, jnp.asarray(ro, dtype), jnp.asarray(rd, dtype), key,
                jcfg, exp_step_factor=T.EXP_STEP, m_cap=n * 32, seg_cap=8,
                stoch=False, seg_pool=0, selection="sort")
            return T.j_losses.total_loss(T.j_losses.nerf_loss(
                res, jnp.asarray(gt, dtype), lc)), res["rm_samples"]
        grads, samples = jax.grad(loss, has_aux=True)(params)
        return [np.asarray(g, np.float64)
                for g in jax.tree.leaves(grads)], int(samples)

    g32, n32 = jax_grads(jp32, jnp.float32)
    g64, n64 = jax_grads(jax.tree.map(lambda a: a.astype(jnp.float64),
                                      jp32), jnp.float64)
    noise = np.asarray(jax.random.uniform(jax.random.split(key, 3)[0],
                                          (n,))).astype(np.float32)

    def port_grads(perm):
        tp = T.params_from_jax(T._flatten(jp32, "params/"))
        for leaf in T.tree_leaves(tp):
            leaf.requires_grad_(True)
        st = T.grid_state_init(tcfg)._replace(occ_flat=T._t(occ))
        tc = T.t_trainer.TrainConfig(
            batch_size=n, samples_per_ray_budget=32,
            loss=T.NeRFLossConfig(grid_scale=scale))
        v, res = T.t_trainer.step_loss(
            tp, st, T._t(ro[perm]), T._t(rd[perm]), T._t(gt[perm]),
            noise=T._t(noise[perm]), seed=None, rgb_bg=None, cfg=tcfg,
            tc=tc, exp_step_factor=T.EXP_STEP, seg_cap=8)
        return [g.numpy().astype(np.float64)
                for g in torch.autograd.grad(v, T.tree_leaves(tp))], \
            int(res["rm_samples"])

    gp, n_port = port_grads(np.arange(n))
    gq, _ = port_grads(np.random.default_rng(1).permutation(n))
    print(f"scale {scale}, {n} rays; samples JAX f32 {n32}, JAX f64 {n64}, "
          f"port {n_port}; leaves hash table, rgb V0 V1 V2, sigma W0 W1")
    print("JAX f32 vs JAX f64      ", rel(g32, g64))
    print("port vs JAX f64         ", rel(gp, g64))
    print("port vs port (permuted) ", rel(gq, gp))


if __name__ == "__main__":
    main()
