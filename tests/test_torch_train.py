"""The port's training slice against the JAX package on the CPU: one whole
training step (render_train + nerf_loss + every gradient leaf, then one
Adam step), the trainer's checkpoints across the two packages, and the
`python -m arnerf_tpu_torch.train` entry point.

Both sides start from the same JAX-initialised parameters
(params_from_jax), grid, rays, noise, corner seed and background, in f32,
with the fused head on (Pallas interpret mode on the JAX side, the plain
version here). Tolerances: the loss to 1e-5 relative and each gradient
leaf to 1e-4 of its largest entry (summation order; the composite's
prefix sums and the table's segment sums), sample counts exactly. Adam
is compared on shared gradients, because eps = 1e-15 turns rounding noise
in near-zero gradients into +-lr steps: 1e-6 relative.
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
from arnerf_tpu.rendering import render_train as j_render_train
from arnerf_tpu.training import losses as j_losses
from arnerf_tpu.training.ckpt import (_flatten, load_ckpt as j_load,
                                      save_ckpt as j_save)
from arnerf_tpu.training.trainer import (TrainConfig as JTrainConfig,
                                         cosine_epoch_schedule as j_sched,
                                         make_optimizer as j_make_opt)

from arnerf_tpu_torch.datasets.ray_utils import get_rays
from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.training import trainer as t_trainer
from arnerf_tpu_torch.training.ckpt import params_from_jax, tree_leaves
from arnerf_tpu_torch.training.losses import NeRFLossConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)
SMALL_FLAGS = ["--grid_size", "32", "--n_levels", "4",
               "--log2_hashmap_size", "12"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(t_out, j_out, rtol):
    j = np.asarray(j_out, dtype=np.float32)
    t = t_out.detach().float().numpy()
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t, j, atol=rtol * scale, rtol=0)


def _batch(n=256, seed=0):
    """Rays of random pixels of the synthetic train views, and targets."""
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=(48, 48)))
    rng = np.random.default_rng(seed)
    img = rng.integers(0, len(ds.poses), n)
    pix = rng.integers(0, 48 * 48, n)
    ro, rd = get_rays(torch.as_tensor(ds.directions[pix]),
                      torch.as_tensor(ds.poses[img]))
    gt = rng.random((n, 3)).astype(np.float32)
    return ro.numpy(), rd.numpy(), gt


@pytest.mark.parametrize("stoch,seg_cap", [(False, 8), (True, 8),
                                           (False, 0)])
def test_training_step_matches_jax(stoch, seg_cap):
    """Loss, every gradient leaf and one Adam step of the whole slice."""
    kw = dict(scale=0.5, fused_head=True, **SMALL)
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    j_params = j_init(jax.random.PRNGKey(2), j_cfg)
    t_params = params_from_jax(_flatten(j_params, "params/"))
    for leaf in tree_leaves(t_params):
        leaf.requires_grad_(True)
    occ = analytic_occupancy(0.5, 32, 1).numpy()
    j_state = j_grid_init(j_cfg)._replace(occ_flat=jnp.asarray(occ))
    t_state = grid_state_init(t_cfg)._replace(occ_flat=_t(occ))
    ro, rd, gt = _batch()
    B = ro.shape[0]
    tc = t_trainer.TrainConfig(batch_size=B, lr=1e-2, num_epochs=2,
                               steps_per_epoch=100, seg_cap=seg_cap,
                               samples_per_ray_budget=32,
                               loss=NeRFLossConfig())
    jtc = JTrainConfig(batch_size=B, lr=1e-2, num_epochs=2,
                       steps_per_epoch=100, seg_cap=seg_cap,
                       samples_per_ray_budget=32)
    key = jax.random.PRNGKey(7)
    # render_train's own draws, replayed for the port
    k_noise, _, k_stoch = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (B,)))
    seed = int(jax.random.bits(k_stoch, dtype=jnp.uint32)) if stoch else None

    def j_loss(p):
        res = j_render_train(
            p, j_state, jnp.asarray(ro), jnp.asarray(rd), key, j_cfg,
            m_cap=B * 32, seg_cap=seg_cap, stoch=stoch,
            seg_pool=B * seg_cap if seg_cap > 0 else 0, selection="sort")
        ld = j_losses.nerf_loss(res, jnp.asarray(gt), jtc.loss)
        return j_losses.total_loss(ld), res

    (j_val, j_res), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        j_params)
    t_val, t_res = t_trainer.step_loss(
        t_params, t_state, _t(ro), _t(rd), _t(gt), noise=_t(noise),
        seed=seed, rgb_bg=None, cfg=t_cfg, tc=tc, exp_step_factor=0.0,
        seg_cap=seg_cap)
    for k in ("rm_samples", "vr_samples", "max_nseg", "total_nseg"):
        assert int(t_res[k]) == int(j_res[k]), k
    assert int(t_res["rm_samples"]) > 0
    np.testing.assert_array_equal(t_res["counts"].numpy(),
                                  np.asarray(j_res["counts"]))
    _rel_close(t_val, j_val, 1e-5)
    t_grads = torch.autograd.grad(t_val, tree_leaves(t_params))
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(t_grads)
    for tg, jg in zip(t_grads, j_leaves):
        _rel_close(tg, jg, 1e-4)

    # one Adam step at the schedule's lr, both fed the JAX gradients
    tx, _ = j_make_opt(jtc)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_new = jax.tree.leaves(jax.tree.map(lambda p, u: p + u, j_params,
                                         updates))
    opt, _ = t_trainer.make_optimizer(tc, t_params)
    opt.step(t_params, [_t(g) for g in j_leaves])
    for tp, jp in zip(tree_leaves(t_params), j_new):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("lr", [1e-2, 2e-2])
def test_cosine_schedule_matches_jax(lr):
    """Including the warmup ramp above the LR cliff (lr 2e-2)."""
    j = j_sched(lr, 3, 50, warmup_steps=40)
    t = t_trainer.cosine_epoch_schedule(lr, 3, 50, warmup_steps=40)
    for step in (0, 1, 39, 40, 49, 50, 99, 100, 149, 150, 400):
        assert t(step) == float(j(jnp.int32(step))), step


def _tiny_trainer(stoch=False, warmup=16, seed=0):
    scfg = SyntheticConfig(img_wh=(24, 24), n_train=6, n_test=1,
                           gt_samples=64)
    cfg = NGPConfig(scale=0.5, stoch_corners=stoch, **SMALL)
    tc = t_trainer.TrainConfig(batch_size=128, lr=1e-2, num_epochs=1,
                               steps_per_epoch=64, warmup_steps=warmup,
                               samples_per_ray_budget=16, seg_cap=8)
    return t_trainer.NeRFTrainer(
        cfg, tc, SyntheticDataset(split="train", config=scfg),
        SyntheticDataset(split="test", config=scfg), seed=seed)


def test_trainer_fit_and_checkpoint_roundtrip_with_jax(tmp_path):
    """Warmup and pooled blocks with the exact-corner anneal, then the
    checkpoint (params, grid, Adam state) through the JAX loader and back."""
    tr = _tiny_trainer(stoch=True)
    last = tr.fit(n_steps=64, log_every=0)
    assert np.isfinite(float(last["loss"]))
    assert tr.step == 64 and not tr.cfg.stoch_corners    # annealed (0.8)
    assert tr.opt.count == 64
    path = str(tmp_path / "port.npz")
    tr.save(path)

    j_cfg = JConfig(scale=0.5, **SMALL)
    j_params = j_init(jax.random.PRNGKey(0), j_cfg)
    jtc = JTrainConfig(batch_size=128, num_epochs=1, steps_per_epoch=64,
                       warmup_steps=16)
    tx, _ = j_make_opt(jtc)
    p, g, o, step = j_load(path, params_template=j_params,
                           grid_template=j_grid_init(j_cfg),
                           opt_state_template=tx.init(j_params))
    assert step == 64
    for a, b in zip(jax.tree.leaves(p), tree_leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    np.testing.assert_array_equal(np.asarray(g.occ_flat),
                                  tr.grid_state.occ_flat.numpy())
    o_leaves = jax.tree.leaves(o)
    assert int(o_leaves[0]) == 64 and int(o_leaves[-1]) == 64
    for a, b in zip(o_leaves[1:-1], tr.opt.mu + tr.opt.nu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    back = str(tmp_path / "jax.npz")
    j_save(back, params=p, grid_state=g, opt_state=o, step=step)
    tr2 = _tiny_trainer(seed=1)
    tr2.load(back)
    assert tr2.step == 64 and tr2.opt.count == 64
    for a, b in zip(tree_leaves(tr2.params), tree_leaves(tr.params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    for a, b in zip(tr2.opt.nu, tr.opt.nu):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    val = tr2.validate(max_images=1)
    assert np.isfinite(val["psnr"]) and "ssim" in val


def test_trainer_refuses_unported_options():
    with pytest.raises(NotImplementedError):
        t_trainer.make_optimizer(t_trainer.TrainConfig(optimize_ext=True),
                                 {})
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=(8, 8)))
    with pytest.raises(NotImplementedError, match="use_exposure"):
        t_trainer.NeRFTrainer(NGPConfig(**SMALL),
                              t_trainer.TrainConfig(use_exposure=True), ds)


def _run(args, cwd, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_entry_point_cpu_then_jax_load_and_port_eval(tmp_path):
    """`python -m arnerf_tpu_torch.train --device cpu` trains a tiny scene
    for two blocks and writes ckpts/, logs/ and results/; the JAX loader
    reads the checkpoint and the port's eval renders it."""
    proc = _run(["arnerf_tpu_torch.train", "--device", "cpu",
                 "--dataset_name", "synthetic", "--downsample", "0.25",
                 "--num_epochs", "1", "--steps_per_epoch", "32",
                 "--batch_size", "256", "--exp_name", "t", *SMALL_FLAGS],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "test/psnr=" in proc.stdout
    ckpt = tmp_path / "ckpts" / "synthetic" / "t" / "epoch=0.npz"
    assert ckpt.exists()
    assert (tmp_path / "ckpts" / "synthetic" / "t" / "epoch=0_slim.npz") \
        .exists()
    assert (tmp_path / "logs" / "synthetic" / "t" / "metrics.jsonl").exists()
    assert (tmp_path / "results" / "synthetic" / "t" / "000.png") \
        .read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert (tmp_path / "results" / "synthetic" / "t" / "000_d.png").exists()

    j_cfg = JConfig(scale=0.5, grid_size=32, n_levels=4, log2_hashmap_size=12)
    _, g, _, step = j_load(str(ckpt),
                           params_template=j_init(jax.random.PRNGKey(0),
                                                  j_cfg),
                           grid_template=j_grid_init(j_cfg))
    assert step == 32 and int(np.asarray(g.occ_flat).sum()) > 0

    proc = _run(["arnerf_tpu_torch.eval", "--device", "cpu",
                 "--dataset_name", "synthetic", "--downsample", "0.25",
                 "--ckpt_path", str(ckpt), *SMALL_FLAGS], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PSNR:" in proc.stdout


def test_train_entry_point_needs_the_card_or_device_cpu(tmp_path):
    proc = _run(["arnerf_tpu_torch.train", "--dataset_name", "synthetic",
                 "--downsample", "0.25", *SMALL_FLAGS], tmp_path,
                timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr


@pytest.mark.parametrize("flag", [["--optimize_ext"], ["--use_exposure"],
                                  ["--use_EXR"], ["--num_gpus", "2"],
                                  ["--model_parallel", "2"],
                                  ["--dataset_name", "colmap_exr"],
                                  ["--dataset_name", "rtmv"]])
def test_train_entry_point_refuses_unported_flags(flag):
    from arnerf_tpu_torch import train as t_train
    argv = ["--device", "cpu", "--dataset_name", "synthetic", *flag]
    with pytest.raises(SystemExit, match="not ported"):
        t_train.main(argv)


@pytest.mark.slow
@pytest.mark.parametrize("stoch", [False, True])
def test_port_train_converges_on_synthetic_scene(stoch):
    """tests/test_train_e2e.py's bars for the port (CPU, ~minutes)."""
    scfg = SyntheticConfig(img_wh=(64, 64), n_train=12, n_test=2,
                           gt_samples=256)
    cfg = NGPConfig(scale=0.5, grid_size=64, n_levels=8,
                    log2_hashmap_size=15, base_resolution=16,
                    stoch_corners=stoch)
    tc = t_trainer.TrainConfig(batch_size=1024, lr=1e-2, num_epochs=2,
                               steps_per_epoch=300, warmup_steps=64,
                               samples_per_ray_budget=40, max_samples=256,
                               s_cap=256)
    tr = t_trainer.NeRFTrainer(cfg, tc,
                               SyntheticDataset(split="train", config=scfg),
                               SyntheticDataset(split="test", config=scfg))
    tr.on_train_start()
    psnrs = []
    for i in range(600):
        m = tr.train_step()
        if (i + 1) % 150 == 0:
            psnrs.append(float(m["psnr"]))
    assert psnrs[-1] > 19.0, psnrs
    val = tr.validate(max_images=1, compute_ssim=True)
    assert val["psnr"] > 17.0, val
    assert val["ssim"] > 0.5, val
