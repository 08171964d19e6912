"""The port's HDR training paths against the JAX package on the CPU: the
HDR heads (tonemappers, raw HDR radiance), the loss variants, pose
refinement, one whole training step under --use_exposure, --use_EXR and
--optimize_ext, the optimizer of the pose deltas and their checkpoint, and
the train and eval entry points with the HDR flags.

Both sides start from the same JAX-initialised parameters, images, poses,
ray indices (JAX's own draws for its key), noise and grid, in f32 with the
fused head on (Pallas interpret mode on the JAX side, the plain version
here). Tolerances, as tests/test_torch_train.py states them: the loss to
1e-5 relative; each gradient leaf, the pose deltas' included, to 1e-4 of
its largest entry (summation order); sample counts exactly; an Adam step
on shared gradients to 1e-6 relative or 1e-8 absolute (a parameter near
lr that one step of lr = 1e-2 brings near zero keeps an ulp of 1e-2, 1e-9,
whichever package adds the step).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnerf_tpu.datasets.synthetic import (SyntheticConfig as JSynConfig,
                                           SyntheticDataset as JSynthetic)
from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_forward as j_forward,
                               ngp_init as j_init)
from arnerf_tpu.models.ngp import ngp_log_radiance_to_rgb as j_tonemap
from arnerf_tpu.rendering import render_train as j_render_train
from arnerf_tpu.training import NeRFTrainer as JTrainer
from arnerf_tpu.training import losses as j_losses
from arnerf_tpu.training.ckpt import _flatten, load_ckpt as j_load
from arnerf_tpu.training.trainer import (TrainConfig as JTrainConfig,
                                         make_optimizer as j_make_opt,
                                         sample_rays as j_sample_rays)

from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init, ngp_forward
from arnerf_tpu_torch.models.ngp import ngp_init, ngp_log_radiance_to_rgb
from arnerf_tpu_torch.training import trainer as t_trainer
from arnerf_tpu_torch.training.ckpt import params_from_jax, tree_leaves
from arnerf_tpu_torch.training.losses import NeRFLossConfig, rgb_loss_fn

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


def _port_params(j_params, grad=True):
    params = params_from_jax(_flatten(j_params, "params/"))
    for leaf in tree_leaves(params):
        leaf.requires_grad_(grad)
    return params


# -------------------------------------------------------- model heads ----

def test_hdr_model_paths():
    """tests/test_hdr_and_pose_opt.py::test_hdr_model_paths for the port,
    each output held to JAX's on the same parameters and points."""
    kw = dict(scale=0.5, rgb_act="None", **SMALL)
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    assert "tonemappers" in ngp_init(t_cfg)
    j_params = j_init(jax.random.PRNGKey(0), j_cfg)
    params = _port_params(j_params, grad=False)
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.4, 0.4, (16, 3)).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    expo = np.full((16, 1), 2.0, np.float32)
    _, j_ldr = j_forward(j_params, x, d, j_cfg, exposure=expo)
    _, t_ldr = ngp_forward(params, _t(x), _t(d), t_cfg, exposure=_t(expo))
    assert bool(((t_ldr >= 0) & (t_ldr <= 1)).all())
    _rel_close(t_ldr, j_ldr, 1e-6)
    _, j_hdr = j_forward(j_params, x, d, j_cfg, output_radiance=True)
    _, t_hdr = ngp_forward(params, _t(x), _t(d), t_cfg, output_radiance=True)
    assert bool((t_hdr >= 0).all())
    _rel_close(t_hdr, j_hdr, 1e-6)
    for e in (0.5, 8.0):
        z = np.zeros((4, 3), np.float32)
        ex = np.full((4, 1), e, np.float32)
        _rel_close(ngp_log_radiance_to_rgb(params, _t(z), exposure=_t(ex)),
                   j_tonemap(j_params, z, exposure=ex), 1e-6)


def test_raw_hdr_model():
    kw = dict(scale=0.5, rgb_act="None", use_raw_hdr=True, **SMALL)
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    assert "tonemappers" not in ngp_init(t_cfg)
    j_params = j_init(jax.random.PRNGKey(0), j_cfg)
    params = _port_params(j_params, grad=False)
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.4, 0.4, (64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    _, j_train = j_forward(j_params, x, d, j_cfg)     # leaky ReLU
    _, t_train = ngp_forward(params, _t(x), _t(d), t_cfg)
    _rel_close(t_train, j_train, 1e-6)
    assert bool((t_train < 0).any())
    _, t_out = ngp_forward(params, _t(x), _t(d), t_cfg, output_radiance=True)
    assert bool((t_out >= 0).all())
    np.testing.assert_array_equal(t_out.numpy(), np.maximum(
        t_train.numpy(), 0))


def test_loss_variants():
    est = np.asarray([[0.5, 0.2, 0.9], [3.0, 0.0, 1e-3]], np.float32)
    gt = np.asarray([[0.4, 0.25, 0.8], [2.5, 0.1, 0.0]], np.float32)
    for name in ("raw", "log", "tanh"):
        got = rgb_loss_fn(name, _t(est), _t(gt)).numpy()
        want = np.asarray(j_losses.rgb_loss_fn(name, jnp.asarray(est),
                                               jnp.asarray(gt)))
        assert np.isfinite(got).all()
        # float32 division and log round differently in XLA and ATen: a
        # few ulps of the ratio, 1.2e-7 after the log
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = np.log((0.2935 + est) / (0.2935 + gt)) * 0.7607
    np.testing.assert_allclose(rgb_loss_fn("log", _t(est), _t(gt)).numpy(),
                               ref, rtol=1e-6)


def test_pose_refinement_trains():
    """test_pose_refinement_trains for the port: the deltas are parameters,
    move through their own optimizer, and stay small (lr 1e-6)."""
    scfg = SyntheticConfig(img_wh=(32, 32), n_train=4, n_test=1,
                           gt_samples=64)
    ds = SyntheticDataset(split="train", config=scfg)
    cfg = NGPConfig(scale=0.5, **SMALL)
    tc = t_trainer.TrainConfig(batch_size=256, num_epochs=1,
                               steps_per_epoch=10, warmup_steps=2,
                               samples_per_ray_budget=16, max_samples=128,
                               s_cap=128, optimize_ext=True,
                               loss=NeRFLossConfig(grid_scale=0.5))
    trainer = t_trainer.NeRFTrainer(cfg, tc, ds)
    assert trainer.params["pose_deltas"]["dR"].shape == (4, 3)
    assert isinstance(trainer.opt, t_trainer.PoseAdam)
    trainer.on_train_start()
    d0 = trainer.params["pose_deltas"]["dR"].detach().clone()
    for _ in range(6):
        m = trainer.train_step()
    assert np.isfinite(float(m["loss"]))
    d1 = trainer.params["pose_deltas"]["dR"].detach()
    assert not torch.equal(d0, d1)
    assert float(d1.abs().max()) < 1e-3
    # the network's schedule is untouched by the deltas' fixed rate
    assert trainer.opt.lr == pytest.approx(t_trainer.cosine_epoch_schedule(
        1e-2, 1, 10)(6))


# -------------------------------------------------- one training step ----

CASES = {
    # HDR-NeRF: tonemapper heads, per-ray exposure, the unit anchor
    "use_exposure": dict(cfg=dict(rgb_act="None"), tc=dict(
        use_exposure=True, unit_exposure_rgb=0.73), loss="raw"),
    # raw HDR radiance with the log loss
    "use_EXR": dict(cfg=dict(rgb_act="None", use_raw_hdr=True), tc={},
                    loss="log"),
    # pose refinement (exact corners, gradients through the rays)
    "optimize_ext": dict(cfg={}, tc=dict(optimize_ext=True), loss="raw"),
}


def _scene(case, n_img=5, wh=(24, 24)):
    """Poses and directions of the synthetic views, random targets (HDR
    radiance for use_EXR, with an exposure column for use_exposure)."""
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=wh))
    rng = np.random.default_rng(11)
    hw = wh[0] * wh[1]
    scale = 4.0 if case == "use_EXR" else 1.0
    images = (rng.random((n_img, hw, 3)) * scale).astype(np.float32)
    if case == "use_exposure":
        expo = np.float32([0.125, 2.0, 32.0, 0.5, 8.0])[:n_img]
        images = np.concatenate(
            [images, np.broadcast_to(expo[:, None, None], (n_img, hw, 1))],
            -1).astype(np.float32)
    return (images, np.asarray(ds.poses[:n_img], np.float32),
            np.asarray(ds.directions, np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hdr_training_step_matches_jax(case):
    """Loss, every gradient leaf (the pose deltas' too) and one step of the
    optimizer, of the whole slice under each HDR option."""
    spec = CASES[case]
    kw = dict(scale=0.5, fused_head=True, **SMALL, **spec["cfg"])
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    images, poses, dirs = _scene(case)
    B, seg_cap = 256, 8
    common = dict(batch_size=B, lr=1e-2, num_epochs=2, steps_per_epoch=100,
                  seg_cap=seg_cap, samples_per_ray_budget=32, **spec["tc"])
    jtc = JTrainConfig(loss=j_losses.NeRFLossConfig(loss_set=spec["loss"]),
                       **common)
    tc = t_trainer.TrainConfig(loss=NeRFLossConfig(loss_set=spec["loss"]),
                               **common)
    j_params = j_init(jax.random.PRNGKey(2), j_cfg)
    if tc.optimize_ext:
        # the trainer's start. Both packages' refined poses then equal the
        # poses exactly; away from zero their f32 rotation products differ
        # by an ulp (test_refined_rays_match_jax), which can move a sample
        # across a hash-grid cell, where its position gradient jumps
        j_params["pose_deltas"] = {"dR": jnp.zeros((5, 3)),
                                   "dT": jnp.zeros((5, 3))}
    t_params = _port_params(j_params)
    occ = analytic_occupancy(0.5, 32, 1).numpy()
    j_state = j_grid_init(j_cfg)._replace(occ_flat=jnp.asarray(occ))
    t_state = grid_state_init(t_cfg)._replace(occ_flat=_t(occ))

    k_sample, k_render = jax.random.split(jax.random.PRNGKey(7))
    j_imgs, j_poses, j_dirs = map(jnp.asarray, (images, poses, dirs))

    def j_loss(p):
        # the JAX train_step_impl's loss_fn (trainer.py:269-302)
        ro, rd, gt, expo = j_sample_rays(j_imgs, j_poses, j_dirs, k_sample,
                                         jtc, p.get("pose_deltas"))
        net = {k: v for k, v in p.items() if k != "pose_deltas"}
        res = j_render_train(
            net, j_state, ro, rd, k_render, j_cfg, m_cap=B * 32,
            seg_cap=seg_cap, stoch=False, seg_pool=B * seg_cap,
            selection="sort", exposure=expo)
        ld = j_losses.nerf_loss(res, gt, jtc.loss)
        if jtc.use_exposure:
            unit = j_tonemap(net, jnp.zeros((1, 3)),
                             exposure=jnp.ones((1, 1)))
            ld["unit_exposure"] = 0.5 * (unit - jtc.unit_exposure_rgb) ** 2
        return j_losses.total_loss(ld), res

    (j_val, j_res), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        j_params)

    # JAX's ray indices and render draws, replayed for the port
    k_img, k_pix = jax.random.split(k_sample)
    img = _t(jax.random.randint(k_img, (B,), 0, len(images))).long()
    pix = _t(jax.random.randint(k_pix, (B,), 0, images.shape[1])).long()
    k_noise, _, _ = jax.random.split(k_render, 3)
    noise = _t(jax.random.uniform(k_noise, (B,)))
    ro, rd, gt, expo = t_trainer.rays_at(
        _t(images), _t(poses), _t(dirs), img, pix, tc,
        t_params.get("pose_deltas"))
    assert (expo is not None) == tc.use_exposure
    t_val, t_res = t_trainer.step_loss(
        t_params, t_state, ro, rd, gt, noise=noise, seed=None, rgb_bg=None,
        cfg=t_cfg, tc=tc, exp_step_factor=0.0, seg_cap=seg_cap,
        exposure=expo)
    for k in ("rm_samples", "vr_samples", "max_nseg", "total_nseg"):
        assert int(t_res[k]) == int(j_res[k]), k
    assert int(t_res["rm_samples"]) > 0
    _rel_close(t_val, j_val, 1e-5)
    t_grads = torch.autograd.grad(t_val, tree_leaves(t_params))
    j_leaves = jax.tree.leaves(j_grads)
    assert len(j_leaves) == len(t_grads)
    for tg, jg in zip(t_grads, j_leaves):
        assert float(np.abs(np.asarray(jg)).max()) > 0
        _rel_close(tg, jg, 1e-4)

    # one optimizer step on the JAX gradients (PoseAdam under optimize_ext)
    tx, _ = j_make_opt(jtc)
    updates, _ = tx.update(j_grads, tx.init(j_params), j_params)
    j_new = jax.tree.leaves(jax.tree.map(lambda p, u: p + u, j_params,
                                         updates))
    opt, _ = t_trainer.make_optimizer(tc, t_params)
    opt.step(t_params, [_t(g) for g in j_leaves])
    for tp, jp in zip(tree_leaves(t_params), j_new):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-8)


def test_refined_rays_match_jax():
    """rays_at with nonzero pose deltas against the JAX sample_rays on the
    same indices: origins exactly, directions to an ulp (XLA's and ATen's
    float32 3x3 products round differently)."""
    images, poses, dirs = _scene("optimize_ext")
    rng = np.random.default_rng(12)
    deltas = {k: rng.normal(0, 1e-3, (5, 3)).astype(np.float32)
              for k in ("dR", "dT")}
    tc = t_trainer.TrainConfig(batch_size=256, optimize_ext=True)
    key = jax.random.PRNGKey(5)
    j_ro, j_rd, j_gt, _ = j_sample_rays(
        jnp.asarray(images), jnp.asarray(poses), jnp.asarray(dirs), key,
        JTrainConfig(batch_size=256, optimize_ext=True),
        {k: jnp.asarray(v) for k, v in deltas.items()})
    k_img, k_pix = jax.random.split(key)
    img = _t(jax.random.randint(k_img, (256,), 0, 5)).long()
    pix = _t(jax.random.randint(k_pix, (256,), 0, images.shape[1])).long()
    ro, rd, gt, _ = t_trainer.rays_at(_t(images), _t(poses), _t(dirs), img,
                                      pix, tc, {k: _t(v) for k, v in
                                                deltas.items()})
    np.testing.assert_array_equal(ro.numpy(), np.asarray(j_ro))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(j_gt))
    np.testing.assert_allclose(rd.numpy(), np.asarray(j_rd), rtol=0,
                               atol=2.4e-7)


def test_pose_deltas_checkpoint_round_trip_with_jax(tmp_path):
    """The port's pose-refining trainer saves its deltas and both Adams'
    state as the JAX trainer lays them out: the JAX loader reads them into
    its own templates, and the port reads them back."""
    scfg = SyntheticConfig(img_wh=(16, 16), n_train=3, n_test=1,
                           gt_samples=32)
    cfg = NGPConfig(scale=0.5, **SMALL)
    tc = t_trainer.TrainConfig(batch_size=128, num_epochs=1,
                               steps_per_epoch=32, warmup_steps=16,
                               samples_per_ray_budget=16, optimize_ext=True)
    tr = t_trainer.NeRFTrainer(cfg, tc, SyntheticDataset(
        split="train", config=scfg))
    tr.fit(n_steps=32, log_every=0)
    path = str(tmp_path / "pose.npz")
    tr.save(path)

    j_cfg = JConfig(scale=0.5, **SMALL)
    jtc = JTrainConfig(batch_size=128, num_epochs=1, steps_per_epoch=32,
                       warmup_steps=16, optimize_ext=True)
    j_tr = JTrainer(j_cfg, jtc, JSynthetic(split="train", config=JSynConfig(
        img_wh=(16, 16), n_train=3, n_test=1, gt_samples=32)))
    p, _, o, step = j_load(path, params_template=j_tr.params,
                           grid_template=j_tr.grid_state,
                           opt_state_template=j_tr.opt_state)
    assert step == 32
    for a, b in zip(jax.tree.leaves(p), tree_leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    assert float(np.abs(np.asarray(p["pose_deltas"]["dR"])).max()) > 0
    j_opt = [np.asarray(x) for x in jax.tree.leaves(o)]
    t_opt = [np.asarray(x.cpu() if torch.is_tensor(x) else x)
             for x in tr.opt.state_leaves()]
    assert len(j_opt) == len(t_opt) == tr.opt.n_state_leaves
    for a, b in zip(j_opt, t_opt):
        np.testing.assert_array_equal(a, b)
    tr2 = t_trainer.NeRFTrainer(cfg, tc, SyntheticDataset(
        split="train", config=scfg), seed=1)
    tr2.load(path)
    assert tr2.opt.count == 32 and tr2.opt.pose.count == 32
    for a, b in zip(tree_leaves(tr2.params), tree_leaves(tr.params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


# ------------------------------------------------------- entry points ----

def _run(args, cwd, timeout=600):
    # two threads, as this module's own torch: the suite runs its files in
    # parallel, and a subprocess on every core starves the servers of
    # tests/test_torch_insert_server.py
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_then_eval_on_an_exr_capture_cpu(tmp_path):
    """`train --device cpu --use_EXR --loss_func log` on a tiny colmap_exr
    capture, then `eval --use_EXR` on its checkpoint, which the JAX loader
    reads into the raw-HDR model."""
    from arnerf_tpu_torch.datasets.captures import write_colmap_exr_capture
    root = str(tmp_path / "cap")
    write_colmap_exr_capture(root, n_views=9, wh=(32, 24), focal=28.0,
                             n_points=256, n_samples=64)
    flags = ["--device", "cpu", "--dataset_name", "colmap_exr",
             "--root_dir", root, "--use_EXR", *SMALL_FLAGS]
    proc = _run(["arnerf_tpu_torch.train", *flags, "--loss_func", "log",
                 "--num_epochs", "1", "--steps_per_epoch", "32",
                 "--batch_size", "256", "--exp_name", "hdr"], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "test/psnr=" in proc.stdout
    ckpt = tmp_path / "ckpts" / "colmap_exr" / "hdr" / "epoch=0.npz"
    j_cfg = JConfig(scale=0.5, rgb_act="None", use_raw_hdr=True,
                    grid_size=32, n_levels=4, log2_hashmap_size=12)
    p, _, _, step = j_load(str(ckpt), params_template=j_init(
        jax.random.PRNGKey(0), j_cfg), grid_template=j_grid_init(j_cfg))
    assert step == 32 and "tonemappers" not in p
    proc = _run(["arnerf_tpu_torch.eval", *flags, "--ckpt_path", str(ckpt)],
                tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FPS:" in proc.stdout and "(32x24)" in proc.stdout


@pytest.mark.parametrize("flags", [["--use_exposure"], ["--optimize_ext"]])
def test_train_entry_point_accepts_exposure_and_pose_flags(tmp_path,
                                                           monkeypatch,
                                                           flags):
    """--use_exposure on an HDR-NeRF synthetic capture (exposures 1/8 ..
    32, the 0.73 anchor), --optimize_ext on a myblender capture."""
    from arnerf_tpu_torch import train as t_train
    from arnerf_tpu_torch.datasets import captures
    monkeypatch.chdir(tmp_path)
    if flags == ["--use_exposure"]:
        root, _ = captures.write_hdr_nerf_capture(
            str(tmp_path), wh=(16, 16), focal=14.0, n_points=128,
            n_samples=32)
        data = ["--dataset_name", "colmap", "--root_dir", root]
    else:
        root = str(tmp_path / "myb")
        captures.write_myblender_capture(root, n_views=9, wh=(16, 12),
                                         focal=14.0, n_samples=32)
        data = ["--dataset_name", "myblender", "--root_dir", root,
                "--use_EXR"]
    res = t_train.main(["--device", "cpu", *data, *flags, *SMALL_FLAGS,
                        "--num_epochs", "1", "--steps_per_epoch", "16",
                        "--batch_size", "128", "--exp_name", "f",
                        "--no_save_test"])
    tr = res["trainer"]
    assert tr.step == 16 and np.isfinite(res["psnr"]).all()
    if flags == ["--use_exposure"]:
        assert tr.tc.use_exposure and tr.tc.unit_exposure_rgb == 0.73
        assert tr.images.shape[-1] == 4 and "tonemappers" in tr.params
    else:
        assert tr.tc.optimize_ext and tr.cfg.use_raw_hdr
        dR = tr.params["pose_deltas"]["dR"].detach()
        assert 0 < float(dR.abs().max()) < 1e-3
