"""The port's training on unbounded scenes against the JAX package on the
CPU: one whole training step at 3 and 4 occupancy cascades with exp
stepping (1/256) and the black background of colmap-class scenes, the
density-grid update with `erode` at 3 cascades, and (slow) a multi-cascade
training run with a bake of its field, the port's counterpart of
tests/test_mc_train_e2e.py. Also the train entry point's depth images:
OpenCV's turbo map, whose table the port carries.

The step feeds both packages the same JAX-initialised parameters, grid,
rays (256 pixels of the scene's views, their pixels as targets), noise
and corner seed, in f32. Tolerances as in test_torch_train.py: the loss to
1e-5 relative, each gradient leaf to 1e-4 of its largest entry, sample
counts exactly. The density-branch leaves (the hash table, the first
sigma layer) of such a step are sums with heavy cancellation under the
relative rgb loss, and their float32 value depends on the summation
order: on 96 rays at scale 2, JAX's own float32 gradients lie 4.5e-3
from its float64 gradients there, the port's 4.1e-4, and the port's move
by under 1e-6 when its rays are permuted (scripts/torch_mc_step_precision.py).
The batches here are ones where JAX's float32 stays within the tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu.models import NGPConfig as JConfig
from arnerf_tpu.models import grid_state_init as j_grid_init
from arnerf_tpu.models import ngp as j_ngp
from arnerf_tpu.models import ngp_init as j_init
from arnerf_tpu.rendering import render_train as j_render_train
from arnerf_tpu.training import losses as j_losses
from arnerf_tpu.training.ckpt import _flatten

from arnerf_tpu_torch.datasets.ray_utils import get_rays
from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.models import ngp as t_ngp
from arnerf_tpu_torch.training import trainer as t_trainer
from arnerf_tpu_torch.training.ckpt import params_from_jax, tree_leaves
from arnerf_tpu_torch.training.losses import NeRFLossConfig

torch.set_num_threads(2)

SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)
EXP_STEP = 1 / 256


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(t_out, j_out, rtol):
    j = np.asarray(j_out, dtype=np.float32)
    t = t_out.detach().float().numpy()
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t, j, atol=rtol * scale, rtol=0)


def _batch(scale, n=256, seed=0):
    """Rays of random pixels of the scene's train views (cameras outside
    the unit cube, looking in) and their pixels (black background)."""
    ds = SyntheticDataset(split="train",
                          config=SyntheticConfig(scale=scale, img_wh=(48, 48),
                                                 n_train=8, gt_samples=64))
    rng = np.random.default_rng(seed)
    img = rng.integers(0, len(ds.poses), n)
    pix = rng.integers(0, 48 * 48, n)
    ro, rd = get_rays(torch.as_tensor(ds.directions[pix]),
                      torch.as_tensor(ds.poses[img]))
    gt = np.asarray(ds.rays)[img, pix, :3].astype(np.float32)
    return ro.numpy(), rd.numpy(), gt


@pytest.mark.parametrize("scale,stoch,distortion", [
    (2.0, False, 0.0), (4.0, False, 1e-3), (4.0, True, 0.0)])
def test_multi_cascade_training_step_matches_jax(scale, stoch, distortion):
    """Loss, sample counts and every gradient leaf of one step at 3 and 4
    cascades (exp stepping, black background)."""
    kw = dict(scale=scale, fused_head=True, **SMALL)
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    assert j_cfg.cascades == t_cfg.cascades == (3 if scale == 2.0 else 4)
    j_params = j_init(jax.random.PRNGKey(2), j_cfg)
    t_params = params_from_jax(_flatten(j_params, "params/"))
    for leaf in tree_leaves(t_params):
        leaf.requires_grad_(True)
    occ = analytic_occupancy(scale, 32, j_cfg.cascades).numpy()
    j_state = j_grid_init(j_cfg)._replace(occ_flat=jnp.asarray(occ))
    t_state = grid_state_init(t_cfg)._replace(occ_flat=_t(occ))
    ro, rd, gt = _batch(scale)
    B = ro.shape[0]
    loss_cfg = dict(grid_scale=scale, lambda_distortion=distortion)
    tc = t_trainer.TrainConfig(batch_size=B, samples_per_ray_budget=32,
                               loss=NeRFLossConfig(**loss_cfg))
    j_loss_cfg = j_losses.NeRFLossConfig(**loss_cfg)
    key = jax.random.PRNGKey(11)
    k_noise, _, k_stoch = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (B,)))
    seed = int(jax.random.bits(k_stoch, dtype=jnp.uint32)) if stoch else None

    def j_loss(p):
        res = j_render_train(
            p, j_state, jnp.asarray(ro), jnp.asarray(rd), key, j_cfg,
            exp_step_factor=EXP_STEP, m_cap=B * 32, seg_cap=8, stoch=stoch,
            seg_pool=0, selection="sort")
        ld = j_losses.nerf_loss(res, jnp.asarray(gt), j_loss_cfg)
        return j_losses.total_loss(ld), res

    (j_val, j_res), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        j_params)
    t_val, t_res = t_trainer.step_loss(
        t_params, t_state, _t(ro), _t(rd), _t(gt), noise=_t(noise),
        seed=seed, rgb_bg=None, cfg=t_cfg, tc=tc, exp_step_factor=EXP_STEP,
        seg_cap=8)
    for k in ("rm_samples", "vr_samples"):
        assert int(t_res[k]) == int(j_res[k]), k
    assert int(t_res["rm_samples"]) > 10 * B
    np.testing.assert_array_equal(t_res["counts"].numpy(),
                                  np.asarray(j_res["counts"]))
    # samples in every cascade beyond the inner cube
    ts = t_res["ts"].detach()[:int(t_res["rm_samples"])]
    assert float(ts.max()) > 2.0
    _rel_close(t_val, j_val, 1e-5)
    t_grads = torch.autograd.grad(t_val, tree_leaves(t_params))
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(t_grads)
    for tg, jg in zip(t_grads, j_leaves):
        _rel_close(tg, jg, 1e-4)


@pytest.mark.parametrize("warmup", [True, False])
def test_update_density_grid_erode_at_three_cascades(warmup):
    """update_density_grid(erode=True) at 3 cascades with JAX's draws:
    the camera-count decay, the mean-density threshold over every cascade
    and the packed bitfield."""
    jc = JConfig(scale=2.0, **SMALL)
    tc = NGPConfig(scale=2.0, **SMALL)
    C, G3 = jc.cascades, 32 ** 3
    assert C == 3
    j_params = j_init(jax.random.PRNGKey(1), jc)
    t_params = params_from_jax(_flatten(j_params, "params/"))
    thr = 0.01 * 1024 / 3 ** 0.5
    rng = np.random.default_rng(5)
    dg = np.where(rng.random((C, G3)) < 0.1, -1.0,
                  rng.uniform(0, 20, (C, G3))).astype(np.float32)
    cg = rng.random((C, G3)).astype(np.float32)
    j_state = j_grid_init(jc)._replace(density_grid=jnp.asarray(dg),
                                       count_grid=jnp.asarray(cg))
    t_state = t_ngp.grid_state_init(tc)._replace(density_grid=_t(dg),
                                                 count_grid=_t(cg))
    key = jax.random.PRNGKey(3)
    j = j_ngp.update_density_grid(j_params, j_state, key, jc,
                                  density_threshold=thr, warmup=warmup,
                                  erode=True)
    # the JAX update's draws, replayed
    k_sample, k_jitter, _ = jax.random.split(key, 3)
    if warmup:
        idx, m = None, G3
    else:
        M = G3 // 4
        ku, ko = jax.random.split(k_sample)
        uniform_idx = jax.random.randint(ku, (C, M), 0, G3, jnp.int32)
        u = jax.random.uniform(ko, (C, M))
        idx = torch.cat([_t(uniform_idx).long(), t_ngp.occupied_cells(
            _t(dg), thr, _t(u))], dim=1)
        m = 2 * M
    jitter = _t(jax.random.uniform(k_jitter, (C * m, 3)))
    t = t_ngp.update_density_grid_core(t_params, t_state, tc, thr, idx,
                                       jitter, erode=True)
    np.testing.assert_allclose(t.density_grid.numpy(),
                               np.asarray(j.density_grid), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(t.occ_flat.numpy(), np.asarray(j.occ_flat))
    np.testing.assert_array_equal(t.bitfield.numpy(), np.asarray(j.bitfield))
    # erosion decays the poorly seen cells harder than the plain EMA
    plain = t_ngp.update_density_grid_core(t_params, t_state, tc, thr, idx,
                                           jitter, erode=False)
    assert float((plain.density_grid - t.density_grid).max()) > 0


def test_depth_images_use_opencvs_turbo_map():
    import cv2
    from arnerf_tpu_torch.train import depth2img
    from arnerf_tpu_torch.utils.colormap import TURBO_RGB
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = cv2.applyColorMap(ramp, cv2.COLORMAP_TURBO)[..., ::-1]
    np.testing.assert_array_equal(TURBO_RGB[ramp], want)
    depth = np.random.default_rng(0).uniform(1, 3, (12, 10)) \
        .astype(np.float32)
    d = (depth - depth.min()) / (depth.max() - depth.min())
    np.testing.assert_array_equal(
        depth2img(depth),
        cv2.applyColorMap((d * 255).astype(np.uint8),
                          cv2.COLORMAP_TURBO)[..., ::-1])


@pytest.mark.slow
def test_port_multi_cascade_training_converges_and_bakes():
    """tests/test_mc_train_e2e.py's run and bars for the port (CPU,
    minutes): scale 2, 3 cascades, black background, 640 steps; then a
    96^3 multi-cascade bake of the trained field renders close to the
    network."""
    from arnerf_tpu_torch.rendering_baked import bake_ngp, render_baked
    scfg = SyntheticConfig(scale=2.0, img_wh=(96, 96), n_train=30, n_test=2,
                           gt_samples=384)
    train_ds = SyntheticDataset(split="train", config=scfg)
    test_ds = SyntheticDataset(split="test", config=scfg)
    assert float(np.mean(train_ds.rays[0][:, :3])) < 0.5
    cfg = NGPConfig(scale=2.0)
    assert cfg.cascades == 3
    tc = t_trainer.TrainConfig(
        batch_size=2048, lr=1e-2, num_epochs=2, steps_per_epoch=320,
        warmup_steps=128, samples_per_ray_budget=32,
        loss=NeRFLossConfig(grid_scale=2.0, lambda_distortion=1e-3))
    tr = t_trainer.NeRFTrainer(cfg, tc, train_ds, test_ds)
    tr.on_train_start()
    while tr.step < 640:
        m = tr.train_block()
    assert np.isfinite(float(m["loss"])), "scale-2 training went non-finite"
    val = tr.validate(max_images=1, compute_ssim=False)
    assert val["psnr"] > 24.0, f"scale-2 val {val['psnr']:.2f} dB"

    baked = bake_ngp(tr.params, tr.grid_state, cfg, resolution=96,
                     n_dirs=12)
    assert baked.cascades == 3
    ro, rd = get_rays(torch.as_tensor(test_ds.directions),
                      torch.as_tensor(test_ds.poses[0]))
    net = tr.render_pose(test_ds.poses[0], T_threshold=1e-2, max_samples=96)
    bk = render_baked(baked, tr.grid_state, ro, rd, cfg, T_threshold=1e-2)
    mse = float(torch.mean((bk["rgb"] - net["rgb"]) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-12))
    assert psnr > 18.0, f"MC baked vs network {psnr:.2f} dB"
