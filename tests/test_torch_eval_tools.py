"""eval's --grid_vis, --cam_vis and --mesh in the port against the JAX
package, and the train and eval entry points on file datasets (CPU).

* The occupancy slices and the camera plot must be the same images as the
  repository's eval.py writes from the same full-width checkpoint. Its
  render loop is replaced by a stub returning zeros: the images under test
  do not depend on it, and the renders are held elsewhere
  (tests/test_torch_render.py).
* marching_tetrahedra must give the JAX numpy version's mesh exactly (same
  vertices, same faces, same order) on a shared float32 field, and
  extract_ngp_mesh at resolution 32 the same triangles to 1e-4 from the
  same small model.
* A tiny `train --device cpu --dataset_name nerf` run on a capture written
  by datasets/captures.py ends with a finite test/psnr, and eval on its
  checkpoint writes all three extra outputs.
"""

import importlib.util
import os
import re
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arnerf_tpu.rendering as j_rendering
from arnerf_tpu.models import NGPConfig as JConfig, ngp_init as j_init
from arnerf_tpu.training.ckpt import _flatten
from arnerf_tpu.utils import mesh as j_mesh

from arnerf_tpu_torch import eval as t_eval
from arnerf_tpu_torch import train as t_train
from arnerf_tpu_torch.datasets.captures import write_blender_capture
from arnerf_tpu_torch.datasets.synthetic import analytic_occupancy
from arnerf_tpu_torch.models import NGPConfig, grid_state_init, ngp_init
from arnerf_tpu_torch.training.ckpt import params_from_jax, save_ckpt
from arnerf_tpu_torch.utils import mesh as t_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)
SIZE_FLAGS = ["--grid_size", "32", "--n_levels", "4",
              "--log2_hashmap_size", "12"]

torch.set_num_threads(2)


def _jax_eval_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_eval_cli", os.path.join(REPO, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grid_and_camera_images_match_jax_eval(tmp_path, monkeypatch):
    scale = 2.0                      # 3 cascades: three slices side by side
    cfg = NGPConfig(scale=scale)
    occ = analytic_occupancy(0.5, cfg.grid_size, cfg.cascades)
    ckpt = str(tmp_path / "ckpt.npz")
    save_ckpt(ckpt, params=ngp_init(cfg, torch.Generator().manual_seed(0)),
              grid_state=grid_state_init(cfg)._replace(occ_flat=occ))
    args = ["--dataset_name", "synthetic", "--downsample", "0.125",
            "--scale", str(scale), "--ckpt_path", ckpt]

    def no_render(params, grid_state, rays_o, rays_d, cfg, **kw):
        n = rays_o.shape[0]
        return {"rgb": jnp.zeros((n, 3)), "opacity": jnp.zeros(n)}
    monkeypatch.setattr(j_rendering, "render_test", no_render)
    monkeypatch.setattr(sys, "argv", ["eval.py", *args, "--grid_vis",
                                      str(tmp_path / "j_grid.png"),
                                      "--cam_vis",
                                      str(tmp_path / "j_cams.png")])
    _jax_eval_cli().main()
    t_eval.main(args + ["--device", "cpu",
                        "--grid_vis", str(tmp_path / "t_grid.png"),
                        "--cam_vis", str(tmp_path / "t_cams.png")])
    for name in ("grid", "cams"):
        want = imageio.imread(tmp_path / f"j_{name}.png")
        got = imageio.imread(tmp_path / f"t_{name}.png")
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert want.shape == (320, 960, 3)
    grid = imageio.imread(tmp_path / "t_grid.png")
    assert grid.shape == (cfg.grid_size, 3 * cfg.grid_size)
    assert grid.max() == 255 and grid.min() == 0


def _noisy_field(seed=0, shape=(33, 30, 25)):
    rng = np.random.default_rng(seed)
    g = [np.linspace(-1, 1, n) for n in shape]
    X, Y, Z = np.meshgrid(*g, indexing="ij")
    return (30 * np.exp(-2 * (X ** 2 + 1.3 * Y ** 2 + Z ** 2))
            + rng.normal(0, 1, X.shape)).astype(np.float32)


@pytest.mark.parametrize("threshold", [20.0, 29.0, 1e3])
def test_marching_tetrahedra_matches_jax(threshold):
    field = _noisy_field()
    kw = dict(origin=(-1.0, -0.5, -1.0), spacing=2 / 32)
    want = j_mesh.marching_tetrahedra(field, threshold, **kw)
    got = t_mesh.marching_tetrahedra(torch.from_numpy(field), threshold,
                                     **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if threshold < 100:
        assert len(got[1]) > 100


def test_extract_ngp_mesh_matches_jax():
    jcfg = JConfig(scale=0.5, **SMALL)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(_flatten(jparams, "params/"))
    tcfg = NGPConfig(scale=0.5, **SMALL)
    # a threshold that cuts the random field: its median at 32^3 points
    xs = np.linspace(-0.5, 0.5, 32, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    from arnerf_tpu.models.ngp import ngp_density
    thr = float(np.median(np.asarray(ngp_density(jparams, jnp.asarray(pts),
                                                 jcfg))))
    wv, wf = j_mesh.extract_ngp_mesh(jparams, jcfg, resolution=32,
                                     threshold=thr)
    gv, gf = t_mesh.extract_ngp_mesh(tparams, tcfg, resolution=32,
                                     threshold=thr)
    assert len(wf) > 100
    # the same triangles in the same order; vertex indices may differ where
    # a float32 rounding moves a vertex across the 1e-6 welding grid
    assert gf.shape == wf.shape
    np.testing.assert_allclose(gv[gf], wv[wf], atol=1e-4, rtol=0)
    t_mesh.save_obj(os.devnull, gv, gf)


def test_train_and_eval_on_a_blender_capture(tmp_path, monkeypatch,
                                             capsys):
    root = str(tmp_path / "capture")
    write_blender_capture(root, n_train=8, n_test=2, wh=32, n_samples=64)
    monkeypatch.chdir(tmp_path)
    ds = str(32 / 800)
    res = t_train.main(["--device", "cpu", "--dataset_name", "nerf",
                        "--root_dir", root, "--downsample", ds,
                        "--exp_name", "tiny", "--num_epochs", "1",
                        "--steps_per_epoch", "16", "--batch_size", "256",
                        *SIZE_FLAGS])
    m = re.search(r"test/psnr=([-0-9.naninf]+)", capsys.readouterr().out)
    assert m and np.isfinite(float(m.group(1))), m
    assert len(res["psnr"]) == 2
    monkeypatch.setattr(t_eval, "MESH_RESOLUTION", 32)
    out = t_eval.main(["--device", "cpu", "--dataset_name", "nerf",
                       "--root_dir", root, "--downsample", ds,
                       "--ckpt_path", "ckpts/nerf/tiny/epoch=0.npz",
                       "--grid_vis", "grid.png", "--cam_vis", "cams.png",
                       "--mesh", "mesh.obj", *SIZE_FLAGS])
    assert np.isfinite(out["psnr"]).all()
    assert imageio.imread("grid.png").shape == (32, 32)
    assert imageio.imread("cams.png").shape == (320, 960, 3)
    with open("mesh.obj") as f:
        lines = f.read().splitlines()
    assert sum(line.startswith("f ") for line in lines) == out["mesh_faces"]


def test_nsvf_synthetic_run_ends_with_the_no_video_message(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    """The JAX CLI writes rgb/depth videos for Synthetic-NSVF when an mp4
    backend exists and otherwise prints `video export skipped`; the port
    has none, so it always takes that branch."""
    root = tmp_path / "Synthetic_NSVF" / "Toy"
    (root / "rgb").mkdir(parents=True)
    (root / "pose").mkdir()
    (root / "bbox.txt").write_text("-0.5 -0.5 -0.5 0.5 0.5 0.5 0.05\n")
    (root / "intrinsics.txt").write_text("1100 0 400 0\n0 1100 400 0\n"
                                         "0 0 1 0\n0 0 0 1\n")
    rng = np.random.default_rng(0)
    for name in ("0_000", "0_001", "2_000"):
        imageio.imsave(root / "rgb" / f"{name}.png",
                       rng.integers(0, 256, (16, 16, 3)).astype(np.uint8))
        pose = np.eye(4)
        pose[2, 3] = 1.6
        np.savetxt(root / "pose" / f"{name}.txt", pose)
    monkeypatch.chdir(tmp_path)
    t_train.main(["--device", "cpu", "--dataset_name", "nsvf",
                  "--root_dir", str(root), "--downsample", str(16 / 800),
                  "--exp_name", "toy", "--num_epochs", "1",
                  "--steps_per_epoch", "16", "--batch_size", "128",
                  *SIZE_FLAGS])
    out = capsys.readouterr().out
    assert "test/psnr=" in out and "video export skipped" in out
    assert (tmp_path / "results/nsvf/toy/000.png").exists()
