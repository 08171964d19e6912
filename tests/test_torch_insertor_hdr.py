"""The port's HDR insertion (--use_EXR) against the JAX NGPInsertor on the
CPU: the radiance surface cache, the gamma-tonemapped point cloud, the SH
probes of HDR radiance (cube-map and sphere probes, and the precompute
probes without background), the HDR frame, and the saved frame's EXR read
back with the port's reader.

The scene and model are tests/test_torch_insertor.py's (24x24 frames, 3
training poses, JAX-initialised weights, a sphere of occupancy), with the
raw-HDR heads (rgb_act None, use_raw_hdr) and the rgb net's last layer
scaled by 20 so that the radiance passes 1. Held to 1e-4 of each array's
largest magnitude (renders, probes, frames), as that file holds LDR
values to 1e-4 absolute.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arnerf_tpu.insert.main as j_main
from arnerf_tpu.models import NGPConfig as JConfig, grid_state_init as \
    j_grid_init, ngp_init as j_init
from arnerf_tpu.training.ckpt import _flatten

import arnerf_tpu_torch.insert.main as t_main
from arnerf_tpu_torch.image_io import read_exr
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.training.ckpt import params_from_jax

from test_torch_insertor import (SMALL, _object_inputs, make_hparams,
                                 sphere_occupancy)

torch.set_num_threads(2)

TOL = 1e-4
HDR = dict(rgb_act="None", use_raw_hdr=True)


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()),
                               rtol=0)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX insertor, port insertor) with --use_EXR on the same scene."""
    import arnerf_tpu.datasets as j_dsets
    import arnerf_tpu_torch.datasets as t_dsets
    from arnerf_tpu.datasets.synthetic import SyntheticConfig as JSyn
    from arnerf_tpu_torch.datasets.synthetic import SyntheticConfig as TSyn
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("insert_hdr"))
    j_orig = j_dsets.dataset_dict["synthetic"]
    t_orig = t_dsets.dataset_dict["synthetic"]
    mp.setitem(j_dsets.dataset_dict, "synthetic", lambda **kw: j_orig(
        config=JSyn(img_wh=(24, 24), n_train=3, n_test=1, gt_samples=16),
        **kw))
    mp.setitem(t_dsets.dataset_dict, "synthetic", lambda **kw: t_orig(
        config=TSyn(img_wh=(24, 24), n_train=3, n_test=1, gt_samples=16),
        **kw))
    try:
        j_ins = j_main.NGPInsertor(make_hparams("h_jax", use_EXR=True))
        t_ins = t_main.NGPInsertor(make_hparams("h_port", use_EXR=True))
        assert t_ins.cfg.use_raw_hdr and t_ins.cfg.rgb_act == "None"
        j_ins.cfg = JConfig(scale=0.5, **SMALL, **HDR)
        params = j_init(jax.random.PRNGKey(0), j_ins.cfg)
        params["rgb_mlp"][-1] = params["rgb_mlp"][-1] * 20.0
        j_ins.params = params
        occ = sphere_occupancy(j_ins.cfg.grid_size)
        j_ins.grid_state = j_grid_init(j_ins.cfg)._replace(
            occ_flat=jnp.asarray(occ))
        t_ins.cfg = NGPConfig(scale=0.5, fused_head=True, **SMALL, **HDR)
        t_ins.params = params_from_jax(_flatten(params, "params/"))
        t_ins.grid_state = grid_state_init(t_ins.cfg)._replace(
            occ_flat=torch.from_numpy(occ))
        yield j_ins, t_ins
    finally:
        mp.undo()
        os.chdir(cwd)


def test_radiance_surface_cache_and_point_cloud_match_jax(pair):
    j_ins, t_ins = pair
    j_ins.generate_point_cloud()
    t_ins.generate_point_cloud()
    close(t_ins.rgbs, j_ins.rgbs)
    close(t_ins.spts, j_ins.spts)
    assert float(t_ins.rgbs.min()) >= 0 and float(t_ins.rgbs.max()) > 1.0

    def ply_colours(path):
        with open(path) as f:
            lines = f.read().split("end_header\n")[1].splitlines()
        return np.array([[int(v) for v in ln.split()[3:]] for ln in lines])

    got = ply_colours(os.path.join(t_ins.gen_path, "pc.ply"))
    want = ply_colours(os.path.join(j_ins.gen_path, "pc.ply"))
    # gamma-tonemapped radiance quantised to uint8: equal but where a value
    # sits on a quantisation step
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 1e-2


def test_hdr_probes_match_jax(pair, monkeypatch):
    j_ins, t_ins = pair
    pt = [0.05, -0.1, 0.02]
    for ins in pair:
        ins.global_sh = ins.global_sh * 0 + 0.3
    sh_j = j_ins.generate_probe(jnp.asarray(pt), sh_probe=True)
    sh_t = t_ins.generate_probe(pt, sh_probe=True)
    close(sh_t, sh_j)
    close(t_ins.cubemap_rgb, j_ins.cubemap_rgb)
    assert float(t_ins.cubemap_rgb.max()) > 1.0

    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    u = rng.random((2, 3, 2048)).astype(np.float32)
    from arnerf_tpu_torch.insert.sh_math import sphere_dirs
    dirs = sphere_dirs(torch.as_tensor(1.0 - 2.0 * u[0]),
                       torch.as_tensor(u[1])).numpy()
    monkeypatch.setattr(j_main, "get_sphere_rays",
                        lambda key, n, m: jnp.asarray(dirs))
    close(t_ins.generate_sh_probes(pts, ray_dirs=dirs),
          j_ins.generate_sh_probes(jnp.asarray(pts)))
    for got, want in zip(
            t_ins.generate_sh_probes_for_precompute(pts, ray_dirs=dirs),
            j_ins.generate_sh_probes_for_precompute(jnp.asarray(pts))):
        close(got, want)


def test_hdr_frame_and_saved_exr(pair):
    """render_insert_object (SH light, no shadow) on both, then the
    server's save path: the port's PNG and EXR, the EXR read back equal to
    the HDR frame after HALF rounding."""
    j_ins, t_ins = pair
    for ins in pair:
        ins.last_rgb = ins.last_depth = None
        ins.global_sh = ins.global_sh * 0 + 0.25
    pt = [0.0, 0.05, 0.0]
    light = np.asarray(j_ins.generate_probe(jnp.asarray(pt), sh_probe=True))
    t_ins.generate_probe(pt, sh_probe=True)
    normals, depths = _object_inputs(seed=5)
    pose = j_ins.dataset.poses[2]
    kw = dict(model_bbox=[[6, 5], [14, 13]], model_bbox_last=None,
              model_radius=0.3, gen_shadow=0)
    out_j = j_ins.render_insert_object(
        jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose),
        jnp.asarray(light), 0.6, 0.4, None, True, False, False, **kw)
    out_t = t_ins.render_insert_object(normals, depths, pose, light, 0.6,
                                       0.4, None, True, False, False, **kw)
    for got, want in zip(out_t, out_j):
        close(got, want)
    hdr = np.asarray(out_t[1])
    assert float(hdr.max()) > 1.0

    t_ins.last_rgb = t_ins.last_depth = None
    srv = t_main.NGPServer.__new__(t_main.NGPServer)
    srv.insertor, srv.save_idx = t_ins, 0
    srv.normal, srv.depth, srv.cam_pose = normals, depths, pose
    srv.sh, srv.sg, srv.use_sg_base = light, None, False
    srv.metal, srv.rough, srv.albedo = 0.6, 0.4, None
    srv.sg_use_self_shadow = False
    srv.save_results(struct.pack("i", 1) + b"hdr", **kw)
    results = os.path.join(t_ins.gen_path, "results")
    assert {"0_hdr.png", "0_hdr.exr", "0_info.npz"} <= set(
        os.listdir(results))
    back = read_exr(os.path.join(results, "0_hdr.exr"))
    np.testing.assert_array_equal(
        back, hdr.astype(np.float16).astype(np.float32))
    assert np.isfinite(back).all() and float(back.max()) > 1.0


def test_hdr_flags_build_the_hdr_models(tmp_path, monkeypatch):
    """--use_EXR and --use_exposure build the JAX insertor's configs
    (insert/main.py:63-66): raw HDR, or the tonemapper heads."""
    monkeypatch.chdir(tmp_path)
    for flag, raw in (("use_EXR", True), ("use_exposure", False)):
        ins = t_main.NGPInsertor(make_hparams(flag, **{flag: True}))
        assert ins.cfg.rgb_act == "None" and ins.cfg.use_raw_hdr == raw
        assert ("tonemappers" in ins.params) == (not raw)
        assert ins.radiance == raw
        rgb, depth, _, _ = ins.render_pose(ins.dataset.poses[0])
        assert np.isfinite(rgb).all() and rgb.shape[2] == 3

