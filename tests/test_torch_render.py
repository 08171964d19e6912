"""The port's test-time render slice against the JAX package on the CPU:
render_test(fast=True) end to end, checkpoints across the two packages,
and the `python -m arnerf_tpu_torch.eval` entry point.

Both sides get the same JAX-initialised weights (converted by
params_from_jax), the same occupancy grid (the analytic scene's density
thresholded at cell centres) and the same numpy rays. The JAX side takes
its own CPU path (fused head in Pallas interpret mode). Tolerance: 1e-4 on
rgb, opacity and depth; sample counts must be equal.
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
from arnerf_tpu.rendering import render_test as j_render
from arnerf_tpu.training.ckpt import (_flatten, load_ckpt as j_load,
                                      save_ckpt as j_save)

from arnerf_tpu_torch.datasets.ray_utils import get_rays
from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.rendering import render_test
from arnerf_tpu_torch.training.ckpt import (load_ckpt, params_from_jax,
                                            save_ckpt)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)
TOL = 1e-4


def _configs(scale=0.5, fused_head=True):
    kw = dict(scale=scale, fused_head=fused_head, **SMALL)
    return JConfig(**kw), NGPConfig(**kw)


def _view(scale, img=32):
    """A synthetic test view: rays as numpy arrays (float32)."""
    ds = SyntheticDataset(split="test", read_meta=False,
                          config=SyntheticConfig(scale=scale,
                                                 img_wh=(img, img)))
    ro, rd = get_rays(torch.as_tensor(ds.directions),
                      torch.as_tensor(ds.poses[1]))
    return ro.contiguous().numpy(), rd.contiguous().numpy()


def _scene(scale, fused_head=True, seed=0):
    j_cfg, t_cfg = _configs(scale, fused_head)
    j_params = j_init(jax.random.PRNGKey(seed), j_cfg)
    occ = analytic_occupancy(scale, j_cfg.grid_size, j_cfg.cascades).numpy()
    j_state = j_grid_init(j_cfg)._replace(occ_flat=jnp.asarray(occ))
    t_params = params_from_jax(_flatten(j_params, "params/"))
    t_state = grid_state_init(t_cfg)._replace(occ_flat=torch.from_numpy(occ))
    return j_cfg, j_params, j_state, t_cfg, t_params, t_state


def _render_kwargs(scale):
    return dict(exp_step_factor=1 / 256 if scale > 0.5 else 0.0,
                T_threshold=1e-2, max_samples=96, fast=True)


def _assert_same_render(t_out, j_out):
    for k in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]),
                                   atol=TOL, rtol=0)
    assert int(t_out["total_samples"]) == int(j_out["total_samples"])


@pytest.mark.parametrize("scale,fused_head", [(0.5, True), (0.5, False),
                                              (1.0, True)])
def test_render_test_fast_matches_jax(scale, fused_head):
    """The slice as a whole; scale 1.0 is a two-cascade scene with
    exponential stepping (no coarse grid)."""
    j_cfg, j_params, j_state, t_cfg, t_params, t_state = _scene(
        scale, fused_head)
    ro, rd = _view(scale)
    kw = _render_kwargs(scale)
    j_out = j_render(j_params, j_state, jnp.asarray(ro), jnp.asarray(rd),
                     j_cfg, **kw)
    t_out = render_test(t_params, t_state, torch.from_numpy(ro),
                        torch.from_numpy(rd), t_cfg, **kw)
    _assert_same_render(t_out, j_out)
    assert int(t_out["total_samples"]) > 0
    assert float(t_out["opacity"].max()) > 0.1


def test_render_test_chunked_path_matches_jax():
    """The non-fast path (one render_test_chunk loop per ray chunk)."""
    j_cfg, j_params, j_state, t_cfg, t_params, t_state = _scene(0.5)
    ro, rd = _view(0.5, img=16)
    kw = dict(T_threshold=1e-2, max_samples=96, chunk=128,
              n_candidates=128, samples_per_round=16)
    j_out = j_render(j_params, j_state, jnp.asarray(ro), jnp.asarray(rd),
                     j_cfg, **kw)
    t_out = render_test(t_params, t_state, torch.from_numpy(ro),
                        torch.from_numpy(rd), t_cfg, **kw)
    _assert_same_render(t_out, j_out)


def test_jax_checkpoint_renders_in_port(tmp_path):
    """JAX save_ckpt -> port load_ckpt renders what JAX renders, and a
    checkpoint the port writes loads back into the JAX package."""
    j_cfg, j_params, j_state, t_cfg, _, _ = _scene(0.5, seed=3)
    path = str(tmp_path / "jax.npz")
    j_save(path, params=j_params, grid_state=j_state, step=7)
    t_params, t_state, step = load_ckpt(
        path, params_template=None, grid_template=grid_state_init(t_cfg))
    assert step == 7
    ro, rd = _view(0.5)
    kw = _render_kwargs(0.5)
    j_out = j_render(j_params, j_state, jnp.asarray(ro), jnp.asarray(rd),
                     j_cfg, **kw)
    t_out = render_test(t_params, t_state, torch.from_numpy(ro),
                        torch.from_numpy(rd), t_cfg, **kw)
    _assert_same_render(t_out, j_out)

    back = str(tmp_path / "port.npz")
    save_ckpt(back, params=t_params, grid_state=t_state, step=step)
    p2, s2, _, step2 = j_load(back, params_template=j_params,
                              grid_template=j_grid_init(j_cfg))
    assert step2 == 7
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(j_params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(s2.occ_flat),
                                  np.asarray(j_state.occ_flat))


def test_params_from_jax_layout_with_tonemappers():
    j_cfg = JConfig(scale=0.5, rgb_act="None", **SMALL)
    j_params = j_init(jax.random.PRNGKey(1), j_cfg)
    t_params = params_from_jax(_flatten(j_params, "params/"))
    assert set(t_params) == {"hash_table", "sigma_mlp", "rgb_mlp",
                             "tonemappers"}
    assert len(t_params["tonemappers"]) == 3
    assert [tuple(w.shape) for w in t_params["rgb_mlp"]] == \
        [(32, 64), (64, 64), (64, 3)]
    np.testing.assert_array_equal(t_params["tonemappers"][2][1].numpy(),
                                  np.asarray(j_params["tonemappers"][2][1]))


def _jax_ckpt(tmp_path):
    """A full-width JAX checkpoint (the entry point builds the default
    NGPConfig) with the analytic scene's occupancy."""
    cfg = JConfig(scale=0.5)
    params = j_init(jax.random.PRNGKey(0), cfg)
    occ = analytic_occupancy(0.5, cfg.grid_size, cfg.cascades).numpy()
    state = j_grid_init(cfg)._replace(occ_flat=jnp.asarray(occ))
    path = str(tmp_path / "epoch=0.npz")
    j_save(path, params=params, grid_state=state)
    return path


def test_eval_entry_point_runs_on_cpu(tmp_path):
    path = _jax_ckpt(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "arnerf_tpu_torch.eval", "--device", "cpu",
         "--dataset_name", "synthetic", "--downsample", "0.25",
         "--ckpt_path", path],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FPS:" in proc.stdout and "(32x32)" in proc.stdout
    assert "PSNR:" in proc.stdout
    assert "jax" not in proc.stderr.lower()


def test_eval_refuses_cuda_without_a_card_and_unported_flags(tmp_path):
    from arnerf_tpu_torch import eval as t_eval
    args = ["--dataset_name", "synthetic", "--ckpt_path", "x.npz"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_eval.main(args)
        # the baked renderer runs on the same device rule
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ARNERF_EVAL_BAKED", "1")
            with pytest.raises(RuntimeError, match="--device cpu"):
                t_eval.main(args)
    for name in ("colmap_exr", "colmap_real_exr", "myblender", "rtmv"):
        with pytest.raises(SystemExit, match="not ported.*OpenEXR"):
            t_eval.main(["--dataset_name", name, "--device", "cpu",
                         "--ckpt_path", "x.npz", "--mesh", "out.obj"])


@pytest.mark.parametrize("fast,with_im", [(True, False), (False, False),
                                          (False, True)])
def test_render_test_backgrounds_match_jax(fast, with_im):
    """render_test's SH environment background (evaluated along each ray,
    clamped positive) in both branches; an image background wins where
    both are given (arnerf_tpu/rendering.py:600-608,641-648)."""
    j_cfg, j_params, j_state, t_cfg, t_params, t_state = _scene(0.5)
    ro, rd = _view(0.5, img=16)
    rng = np.random.default_rng(0)
    sh = rng.normal(0.2, 0.3, (9, 3)).astype(np.float32)
    im = rng.uniform(0, 1, (ro.shape[0], 3)).astype(np.float32) \
        if with_im else None
    kw = dict(T_threshold=1e-2, max_samples=96, fast=fast)
    j_out = j_render(j_params, j_state, jnp.asarray(ro), jnp.asarray(rd),
                     j_cfg, sh_bkg=jnp.asarray(sh),
                     im_bkg=None if im is None else jnp.asarray(im), **kw)
    t_out = render_test(t_params, t_state, torch.from_numpy(ro),
                        torch.from_numpy(rd), t_cfg,
                        sh_bkg=torch.from_numpy(sh),
                        im_bkg=None if im is None else torch.from_numpy(im),
                        **kw)
    _assert_same_render(t_out, j_out)
    plain = render_test(t_params, t_state, torch.from_numpy(ro),
                        torch.from_numpy(rd), t_cfg, **kw)
    assert float((t_out["rgb"] - plain["rgb"]).abs().max()) > 1e-2


def test_render_surface_rgb_matches_jax():
    from arnerf_tpu.rendering import render_surface_rgb as j_surface_rgb
    from arnerf_tpu_torch.rendering import render_surface_rgb
    j_cfg, j_params, _, t_cfg, t_params, _ = _scene(0.5, fused_head=False)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.5, 0.5, (4, 5, 3)).astype(np.float32)
    dirs = rng.normal(size=(4, 5, 3)).astype(np.float32)
    got = render_surface_rgb(t_params, torch.from_numpy(pts),
                             torch.from_numpy(dirs), t_cfg)
    assert tuple(got.shape) == (4, 5, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_surface_rgb(
        j_params, jnp.asarray(pts), jnp.asarray(dirs), j_cfg)),
        atol=TOL, rtol=0)
