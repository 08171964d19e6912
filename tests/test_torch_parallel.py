"""Data-parallel training of the port (arnerf_tpu_torch/parallel/dp.py,
the trainer on a mesh, `train --num_gpus`) on gloo ranks on the CPU,
against the JAX package.

Ranks run as processes (tests/test_torch_parallel_worker.py, started by
parallel.launch with torchrun's environment and a port of their own),
each with a timeout, all of one module's runs at once.

- One joined step: two ranks take fixed numpy rays and draws each
  (test_torch_train.py:81's inputs); the joined gradient must equal the
  mean of the two ranks' JAX gradients to 1e-4 of each leaf's largest
  entry (summation order), and the parameters after it JAX's optimizer
  update from the port's joined gradient to 1e-6 (Adam's eps = 1e-15 turns
  rounding noise in near-zero gradients into +-lr steps, so each Adam is
  fed the same gradient, as there).
- Replication: after two blocks on two ranks, every parameter, Adam leaf
  and grid state is bitwise equal across the ranks.
- Collective bytes of a DP-2 block against JAX's block_collective_report,
  per primitive, to the byte. Departure: the port also counts the nseg
  max (`pmax`, 4 bytes a step), which JAX's accounting does not list
  among its collectives (arnerf_tpu/parallel/accounting.py:20-21).
- The entry point: `--device cpu --num_gpus 2` trains, and the JAX eval
  path (eval.py's load_ckpt and render_test) reads its checkpoint.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_init as j_init)
from arnerf_tpu.parallel import make_mesh as j_make_mesh
from arnerf_tpu.parallel.accounting import \
    block_collective_report as j_report
from arnerf_tpu.rendering import (render_test as j_render_test,
                                  render_train as j_render_train)
from arnerf_tpu.training import losses as j_losses
from arnerf_tpu.training.ckpt import _flatten, load_ckpt as j_load
from arnerf_tpu.training.trainer import (TrainConfig as JTrainConfig,
                                         make_optimizer as j_make_opt)

from arnerf_tpu_torch.datasets.ray_utils import get_rays
from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)

import test_torch_parallel_worker as worker

REPO = Path(__file__).resolve().parent.parent
SMALL_FLAGS = ["--grid_size", "32", "--n_levels", "4",
               "--log2_hashmap_size", "12"]
B = 256


def _batch(seed):
    """Rays of random pixels of the synthetic train views, and targets
    (test_torch_train.py's _batch)."""
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=(48, 48)))
    rng = np.random.default_rng(seed)
    img = rng.integers(0, len(ds.poses), B)
    pix = rng.integers(0, 48 * 48, B)
    ro, rd = get_rays(torch.as_tensor(ds.directions[pix]),
                      torch.as_tensor(ds.poses[img]))
    return ro.numpy(), rd.numpy(), rng.random((B, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """JAX parameters, the analytic occupancy, and per rank rays, targets
    and render_train's noise draw from the rank's key."""
    j_cfg = JConfig(fused_head=True, **worker.SMALL)
    j_params = j_init(jax.random.PRNGKey(2), j_cfg)
    data = dict(_flatten(j_params, "params/"))
    data["occ"] = analytic_occupancy(0.5, 32, 1).numpy()
    ranks = []
    for r in range(2):
        ro, rd, gt = _batch(seed=r)
        key = jax.random.PRNGKey(7 + r)
        k_noise = jax.random.split(key, 3)[0]
        data.update({f"ro/{r}": ro, f"rd/{r}": rd, f"gt/{r}": gt,
                     f"noise/{r}": np.asarray(jax.random.uniform(k_noise,
                                                                 (B,)))})
        ranks.append((ro, rd, gt, key))
    path = tmp_path_factory.mktemp("inputs") / "step.npz"
    np.savez(path, **data)
    return str(path), j_cfg, j_params, ranks


@pytest.fixture(scope="module")
def runs(step_inputs, tmp_path_factory):
    step, dp2 = worker.run_ranks(
        [{"kind": "step", "n_dp": 2, "n_mp": 1, "inputs": step_inputs[0]},
         {"kind": "blocks", "n_dp": 2, "n_mp": 1, "blocks": 2}],
        tmp_path_factory.mktemp("ranks"))
    return {"step": step, "dp2": dp2}


def _leaves(out, prefix):
    return [out[f"{prefix}/{i}"] for i in range(
        sum(k.startswith(prefix + "/") for k in out))]


def test_joined_step_matches_the_mean_of_jax_gradients(runs, step_inputs):
    _, j_cfg, j_params, ranks = step_inputs
    jtc = JTrainConfig(batch_size=B, lr=1e-2, num_epochs=2,
                       steps_per_epoch=100, seg_cap=8,
                       samples_per_ray_budget=32)
    j_state = j_grid_init(j_cfg)._replace(occ_flat=jnp.asarray(
        analytic_occupancy(0.5, 32, 1).numpy()))
    grads, losses = [], []
    for ro, rd, gt, key in ranks:
        def j_loss(p):
            res = j_render_train(
                p, j_state, jnp.asarray(ro), jnp.asarray(rd), key, j_cfg,
                m_cap=B * 32, seg_cap=8, stoch=False, seg_pool=B * 8,
                selection="sort")
            ld = j_losses.nerf_loss(res, jnp.asarray(gt), jtc.loss)
            return j_losses.total_loss(ld)
        val, g = jax.value_and_grad(j_loss)(j_params)
        grads.append(g)
        losses.append(float(val))
    mean = jax.tree.leaves(jax.tree.map(lambda a, b: (a + b) / 2, *grads))
    r0, r1 = runs["step"]
    for r, out in enumerate((r0, r1)):
        np.testing.assert_allclose(out["local_loss"], losses[r], rtol=1e-5)
        np.testing.assert_allclose(out["metric/loss"], np.mean(losses),
                                   rtol=1e-5)
    t_grads = _leaves(r0, "grad")
    assert len(t_grads) == len(mean)
    for a, b in zip(t_grads, _leaves(r1, "grad")):
        np.testing.assert_array_equal(a, b)
    for tg, jg in zip(t_grads, mean):
        jg = np.asarray(jg)
        scale = max(float(np.abs(jg).max()), 1e-30)
        np.testing.assert_allclose(tg, jg, atol=1e-4 * scale, rtol=0)
    # the Adam step after the join: JAX's optimizer on the port's gradient
    tx, _ = j_make_opt(jtc)
    j_grad_tree = jax.tree.unflatten(jax.tree.structure(j_params),
                                     [jnp.asarray(g) for g in t_grads])
    updates, _ = tx.update(j_grad_tree, tx.init(j_params), j_params)
    j_new = jax.tree.leaves(jax.tree.map(lambda p, u: p + u, j_params,
                                         updates))
    for tp, jp in zip(_leaves(r0, "param"), j_new):
        np.testing.assert_allclose(tp, np.asarray(jp), rtol=1e-6, atol=1e-9)


def test_ranks_stay_bitwise_replicated(runs):
    r0, r1 = runs["dp2"]
    keys = [k for k in r0 if k.split("/")[0] in ("param", "opt", "grid")]
    assert sum(k.startswith("opt/") for k in keys) == 2 * sum(
        k.startswith("param/") for k in keys) + 2
    assert {k for k in keys if k.startswith("grid/")} == {
        "grid/density_grid", "grid/count_grid", "grid/occ_flat",
        "grid/bitfield"}
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    for k in r0:
        if k.startswith("metric"):
            assert r0[k] == r1[k] and np.isfinite(r0[k]), k
    assert r0["grid/occ_flat"].sum() > 0
    # the ranks drew different rays: a block's loss differs from a lone
    # rank's, but both ranks report the joined value
    assert r0["metric1/loss"] < r0["metric0/loss"] * 1.5


def _jax_block_report(mesh):
    from test_tp import _setup, _trainer
    cfg, tc, ds = _setup()
    tr = _trainer(cfg, tc, ds, mesh)
    keys = jax.random.split(jax.random.PRNGKey(1),
                            len(tr.mesh.devices.flatten()))
    args = (tr.params, tr.opt_state, tr.grid_state, tr.images, tr.poses,
            tr.directions, keys)
    return j_report(tr._block, args, tc.update_interval)


def test_block_collective_bytes_match_jax(runs):
    want = _jax_block_report(j_make_mesh(2))
    out = runs["dp2"][0]
    got = {k.split("/")[1]: int(v) for k, v in out.items()
           if k.startswith("collective/")}
    # departure: the nseg max, which JAX's accounting does not count
    assert got.pop("pmax") == 4 * 16
    assert got == want["per_block"]
    assert out["total_step_bytes"] == want["total_step_bytes"] + 4


def test_entry_point_trains_on_two_ranks_and_jax_loads_it(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "arnerf_tpu_torch.train", "--device", "cpu",
         "--num_gpus", "2", "--dataset_name", "synthetic", "--downsample",
         "0.25", "--num_epochs", "1", "--steps_per_epoch", "32",
         "--batch_size", "256", "--exp_name", "dp", *SMALL_FLAGS],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("test/psnr=") == 1     # rank 0 validates
    ckpt = tmp_path / "ckpts" / "synthetic" / "dp" / "epoch=0.npz"
    log = tmp_path / "logs" / "synthetic" / "dp" / "metrics.jsonl"
    assert log.exists()
    # the JAX eval.py path: its templates, load_ckpt and render_test
    j_cfg = JConfig(**worker.SMALL)
    params, grid, _, step = j_load(
        str(ckpt), params_template=j_init(jax.random.PRNGKey(0), j_cfg),
        grid_template=j_grid_init(j_cfg))
    assert step == 32 and int(np.asarray(grid.occ_flat).sum()) > 0
    ds = SyntheticDataset(split="test", downsample=0.25)
    rays_o, rays_d = get_rays(torch.as_tensor(ds.directions),
                              torch.as_tensor(ds.poses[0]))
    out = j_render_test(params, grid, jnp.asarray(rays_o.numpy()),
                        jnp.asarray(rays_d.numpy()), j_cfg,
                        exp_step_factor=0.0, T_threshold=1e-2,
                        max_samples=96, fast=True)
    rgb = np.asarray(out["rgb"])
    assert rgb.shape == (ds.img_wh[0] * ds.img_wh[1], 3)
    assert np.isfinite(rgb).all() and rgb.max() > 0
