"""The port's AR insertor against the JAX package's on the CPU.

Both insertors are built on the same tiny synthetic scene (24x24 frames, 3
training poses) with the same small model: JAX-initialised weights carried
across by params_from_jax and the same sphere occupancy. The port runs its
field through the fused head's plain version (the card runs the kernel
there); the JAX side through XLA matmuls, as its insertor does. Random draws
are fed to both: sphere-probe directions, EnvOptim's initial SGs. Every
comparison is held to 1e-4 absolute (renders, normals, probes, shaded
frames), except the SG fit, which is held to 1e-4 relative to each SG
parameter's largest magnitude (Adam's division by sqrt(nu) amplifies the
float32 differences of its gradients).
"""

import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import arnerf_tpu.datasets as j_dsets
import arnerf_tpu.insert.main as j_main
from arnerf_tpu.datasets.synthetic import SyntheticConfig as JSynthConfig
from arnerf_tpu.insert import sg_shadow as j_sg_shadow
from arnerf_tpu.models import NGPConfig as JConfig, grid_state_init as \
    j_grid_init, ngp_init as j_init
from arnerf_tpu.training.ckpt import _flatten

import arnerf_tpu_torch.datasets as t_dsets
import arnerf_tpu_torch.insert.main as t_main
from arnerf_tpu_torch.datasets.synthetic import SyntheticConfig
from arnerf_tpu_torch.insert import sg_shadow as t_sg_shadow
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.training.ckpt import params_from_jax

torch.set_num_threads(2)

SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)
TOL = 1e-4
FH_PRETAB = os.path.join(os.path.dirname(j_sg_shadow.__file__), "data",
                         "fh_pretab.npy")


def make_hparams(exp_name, **over):
    """tests/test_insertor.py's fields, plus the port's device and size
    flags."""
    hp = types.SimpleNamespace(
        root_dir="", dataset_name="synthetic", split="train", downsample=1.0,
        scale=0.5, use_exposure=False, use_EXR=False,
        distortion_loss_w=0, depth_loss_w=0, loss_func="raw",
        batch_size=1024, ray_sampling_strategy="all_images", num_epochs=1,
        num_gpus=1, lr=1e-2, optimize_ext=False, random_bg=False,
        val_batch_size=2 ** 20, eval_lpips=False, val_only=False,
        no_save_test=True, exp_name=exp_name, ckpt_path=None,
        weight_path=None, low_resolution=1.0, max_pc_pts_num=int(1e4),
        no_global_SH=False, train_SH_HDR_mapping=False,
        gen_probe_HDR_mapping=False, render_HDR_mapping=False,
        device="cpu", compute_dtype="auto", grid_size=32, n_levels=4,
        log2_hashmap_size=12)
    for k, v in over.items():
        setattr(hp, k, v)
    return hp


def sphere_occupancy(G):
    g = (np.arange(G) + 0.5) / G * 2 - 1
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) < 0.6).astype(np.uint8) \
        .reshape(-1)


def build_pair(monkeypatch, img=24, n_train=3, fused_head=True, **over):
    """(JAX insertor, port insertor) on the same scene, model and
    occupancy; `over` sets flags of both. Call from inside the directory
    the outputs may go to."""
    j_orig = j_dsets.dataset_dict["synthetic"]
    t_orig = t_dsets.dataset_dict["synthetic"]
    monkeypatch.setitem(j_dsets.dataset_dict, "synthetic", lambda **kw: j_orig(
        config=JSynthConfig(img_wh=(img, img), n_train=n_train, n_test=1,
                            gt_samples=16), **kw))
    monkeypatch.setitem(t_dsets.dataset_dict, "synthetic", lambda **kw: t_orig(
        config=SyntheticConfig(img_wh=(img, img), n_train=n_train, n_test=1,
                               gt_samples=16), **kw))
    # two of the JAX insertor's eager helpers, each compiled whole: one
    # compile instead of one per primitive. (Not the SG core: XLA's fused
    # roundings move its ill-conditioned lobes by up to 3e-4.)
    for name, static in (("cubemap2env_map", (1, 2, 3)),
                         ("sh_render_core", (6, 7, 8, 10))):
        monkeypatch.setattr(j_main, name, jax.jit(
            getattr(j_main, name), static_argnums=static))
    j_ins = j_main.NGPInsertor(make_hparams("t_jax", **over))
    t_ins = t_main.NGPInsertor(make_hparams("t_port", **over))
    j_ins.cfg = JConfig(scale=0.5, **SMALL)
    j_ins.params = j_init(jax.random.PRNGKey(0), j_ins.cfg)
    occ = sphere_occupancy(j_ins.cfg.grid_size)
    j_ins.grid_state = j_grid_init(j_ins.cfg)._replace(
        occ_flat=jnp.asarray(occ))
    t_ins.cfg = NGPConfig(scale=0.5, fused_head=fused_head, **SMALL)
    t_ins.params = params_from_jax(_flatten(j_ins.params, "params/"))
    t_ins.grid_state = grid_state_init(t_ins.cfg)._replace(
        occ_flat=torch.from_numpy(occ))
    return j_ins, t_ins


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("insert_pair"))
    mp.setattr(t_sg_shadow, "get_fh_table", lambda: np.load(FH_PRETAB))
    try:
        yield build_pair(mp)
    finally:
        mp.undo()
        os.chdir(cwd)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def _t(x):
    return torch.as_tensor(np.array(x))


def test_render_pose_matches_jax(pair):
    j_ins, t_ins = pair
    pose = j_ins.dataset.poses[1]
    rgb_j, depth_j, _, _ = j_ins.render_pose(pose)
    rgb_t, depth_t, _, _ = t_ins.render_pose(pose)
    assert rgb_t.shape == (24, 24, 3) and depth_t.shape == (24, 24)
    close(rgb_t, rgb_j)
    close(depth_t, depth_j)
    assert float(np.max(depth_t)) > 0.1


def test_generate_surface_normals_match_jax(pair):
    """Colours and surface points against the JAX cache; the normals
    against JAX's render_surface_normal at the port's own surface points.
    (The two caches' points differ by ~2e-7, the compositing's rounding;
    a normal is the gradient of a trilinear field with cells of 1/255, so
    at low-gradient points that shift alone moves it by up to ~1e-3.)"""
    from arnerf_tpu.rendering import render_surface_normal as j_normal
    j_ins, t_ins = pair
    j_ins.generate_surface(save=False)
    t_ins.generate_surface(save=False)
    for name in ("rgbs", "spts", "normals"):
        assert getattr(t_ins, name).shape == (3, 24, 24, 3)
    close(t_ins.rgbs, j_ins.rgbs)
    close(t_ins.spts, j_ins.spts)
    close(t_ins.normals, j_normal(j_ins.params, jnp.asarray(t_ins.spts),
                                  j_ins.cfg))
    nn = np.linalg.norm(t_ins.normals.reshape(-1, 3), axis=1)
    assert np.sum(nn > 0.99) > 100


def test_render_surface_normal_leaves_the_table_gradient_alone(pair,
                                                              monkeypatch):
    """The normals differentiate with respect to the positions only: the
    table gradient's segment sum never runs, even when the parameters
    require grad (as a trainer's do)."""
    from arnerf_tpu_torch.ops import hashgrid
    from arnerf_tpu_torch.rendering import render_surface_normal
    _, t_ins = pair
    calls = []
    monkeypatch.setattr(hashgrid, "segment_sum",
                        lambda *a, **k: calls.append(1))
    params = {k: ([w.clone().requires_grad_() for w in v]
                  if isinstance(v, list) else v.clone().requires_grad_())
              for k, v in t_ins.params.items()}
    pts = torch.rand((64, 3)) - 0.5
    n = render_surface_normal(params, pts, t_ins.cfg)
    assert n.shape == (64, 3) and not calls
    assert all(p.grad is None for p in [params["hash_table"]])


def test_probes_match_jax(pair):
    j_ins, t_ins = pair
    pt = [0.05, -0.1, 0.02]
    for ins in pair:
        ins.global_sh = ins.global_sh * 0 + 0.3
    sh_j = j_ins.generate_probe(jnp.asarray(pt), sh_probe=True)
    sh_t = t_ins.generate_probe(pt, sh_probe=True)
    assert tuple(sh_t.shape) == (1, 9, 3)
    close(sh_t, sh_j)
    close(t_ins.cubemap_rgb, j_ins.cubemap_rgb)
    env_j = j_ins.generate_probe(jnp.asarray(pt), return_envmap=True)
    env_t = t_ins.generate_probe(pt, return_envmap=True)
    assert env_t.shape == (128, 128, 3)
    close(env_t, env_j)

    # SG probe: five EnvOptim steps from the same initial SGs
    for ins in pair:
        ins.env_opt.n_iter = 5
    init = np.asarray(j_ins.env_opt.init_sgs)
    t_ins.env_opt.init_sgs = t_ins.env_opt.lgt_sgs = _t(init)
    j_ins.env_opt.lgt_sgs = j_ins.env_opt.init_sgs
    sg_j = np.asarray(j_ins.generate_probe(jnp.asarray(pt), sh_probe=False))
    sg_t = t_ins.generate_probe(pt, sh_probe=False).numpy()
    scale = np.abs(sg_j).max(axis=0)
    assert np.all(np.abs(sg_t - sg_j) <= TOL * scale), \
        np.max(np.abs(sg_t - sg_j) / scale)


def test_sphere_probes_match_jax(pair, monkeypatch):
    j_ins, t_ins = pair
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    u = rng.random((2, 3, 2048)).astype(np.float32)
    from arnerf_tpu_torch.insert.sh_math import sphere_dirs
    dirs = sphere_dirs(_t(1.0 - 2.0 * u[0]), _t(u[1])).numpy()
    monkeypatch.setattr(j_main, "get_sphere_rays",
                        lambda key, n, m: jnp.asarray(dirs))
    for ins in pair:
        ins.global_sh = ins.global_sh * 0 + 0.2
    got = t_ins.generate_sh_probes(pts, ray_dirs=dirs)
    want = j_ins.generate_sh_probes(jnp.asarray(pts))
    assert tuple(got.shape) == (3, 9, 3)
    close(got, want)
    rgb_t, opc_t = t_ins.generate_sh_probes_for_precompute(pts, ray_dirs=dirs)
    rgb_j, opc_j = j_ins.generate_sh_probes_for_precompute(jnp.asarray(pts))
    assert tuple(opc_t.shape) == (3, 9, 1)
    close(rgb_t, rgb_j)
    close(opc_t, opc_j)


def _object_inputs(seed=1, h=8, w=8):
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(h, w, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    depths = rng.uniform(0.8, 1.6, (h, w)).astype(np.float32)
    depths[0, :3] = 0.0                     # pixels off the object
    return normals, depths


def _light_sgs(seed=3, n=6):
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return np.concatenate([axes, rng.uniform(2, 30, (n, 1)),
                           rng.uniform(0.1, 1.5, (n, 3))], -1) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def pca_path(tmp_path_factory):
    rng = np.random.default_rng(3)
    path = tmp_path_factory.mktemp("ssdf") / "pca.npz"
    np.savez(path,
             coeff=rng.normal(0, 0.02, (20 * 20 * 20, 128)).astype(np.float32),
             component=rng.normal(0, 0.05, (128, 74, 148)).astype(np.float32),
             mean=np.full((1, 74, 148), 0.3, np.float32))
    return str(path)


@pytest.fixture(scope="module")
def sf_path(tmp_path_factory):
    rng = np.random.default_rng(4)
    path = tmp_path_factory.mktemp("sf") / "sf.npz"
    vol = 3.0 + rng.normal(0, 0.3, (9, 30, 30, 30))
    np.savez(path, sf=vol.astype(np.float32))
    return str(path)


ROT = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]],
               np.float32)


@pytest.mark.parametrize("use_sg,self_shadow", [(False, False), (True, False),
                                                (True, True)])
def test_render_object_matches_jax(pair, pca_path, use_sg, self_shadow):
    j_ins, t_ins = pair
    for ins in pair:
        ins.set_sg_shadow(pca_path)
    normals, depths = _object_inputs()
    pose = j_ins.dataset.poses[0]
    bbox = [[4, 6], [12, 14]]
    if use_sg:
        light = _light_sgs()
    else:
        light = np.random.default_rng(2).normal(0.3, 0.2, (1, 9, 3)) \
            .astype(np.float32)
    kw = dict(model_radius=0.3, model_pos=np.array([0.05, 0.0, 0.1],
                                                   np.float32),
              model_rot_inv=ROT)
    res_j, dep_j = j_ins.render_object(
        bbox, jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(light),
        jnp.asarray(pose), 0.7, 0.35, None, use_sg, self_shadow,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    res_t, dep_t = t_ins.render_object(bbox, normals, depths, light, pose,
                                       0.7, 0.35, None, use_sg, self_shadow,
                                       **kw)
    assert tuple(res_t.shape) == (24, 24, 3)
    close(res_t, res_j)
    close(dep_t, dep_j)
    assert float(res_t.abs().sum()) > 0


def test_off_object_pixels_with_zero_normals_stay_black(pair, pca_path):
    """The viewer's raster is zero off the object, normals included. A zero
    normal's SG shade is NaN; the JAX package multiplies the shade by the
    depth mask and keeps the NaN there (NaN * 0), the port selects 0, as
    the reference, which shades only the masked pixels. On the object the
    two agree."""
    j_ins, t_ins = pair
    normals, depths = _object_inputs(seed=5)
    normals[depths == 0] = 0.0
    bbox = [[4, 6], [12, 14]]
    light = _light_sgs()
    pose = j_ins.dataset.poses[0]
    res_j, _ = j_ins.render_object(bbox, jnp.asarray(normals),
                                   jnp.asarray(depths), jnp.asarray(light),
                                   jnp.asarray(pose), 0.7, 0.35, None, True,
                                   False)
    res_t, _ = t_ins.render_object(bbox, normals, depths, light, pose, 0.7,
                                   0.35, None, True, False)
    res_j = np.asarray(res_j)[4:12, 6:14]
    res_t = res_t.numpy()[4:12, 6:14]
    off = depths == 0
    assert np.isnan(res_j[off]).all()
    assert (res_t[off] == 0).all()
    close(res_t[~off], res_j[~off])


@pytest.mark.parametrize("gen_shadow,use_sg", [(0, False), (1, False),
                                               (1, True), (2, True)])
def test_render_insert_object_matches_jax(pair, pca_path, sf_path,
                                          gen_shadow, use_sg):
    """The whole AR frame: object shade, dirty-rect recomposite at the
    mesh's depth, shadows (1: the shadow field for SH light, the SG-SSDF
    for SG light; 2: the rasterized shadow map), over two frames so the
    second re-renders only the union of the two bboxes."""
    j_ins, t_ins = pair
    for ins in pair:
        ins.set_sg_shadow(pca_path)
        ins.set_sf(sf_path)
        ins.last_rgb = ins.last_depth = None
        ins.global_sh = ins.global_sh * 0 + 0.25
    pt = [0.0, 0.05, 0.0]
    j_ins.generate_probe(jnp.asarray(pt), sh_probe=True)  # cubemap_rgb
    t_ins.generate_probe(pt, sh_probe=True)
    light = _light_sgs(7) if use_sg else \
        np.asarray(j_ins.generate_probe(jnp.asarray(pt), sh_probe=True))
    rng = np.random.default_rng(11)
    tex = 16
    vp = np.array([[1.2, 0, 0, 0.1], [0, 1.2, 0, -0.05],
                   [0, 0, -1.0, 0.4], [0, 0, -1.0, 1.6]], np.float32)
    s_im = rng.uniform(0.3, 0.9, (tex, tex, 1)).astype(np.float32)
    pose = j_ins.dataset.poses[2]
    frames = []
    for bbox, last in (([[6, 5], [14, 13]], None),
                       ([[7, 8], [15, 16]], [[6, 5], [14, 13]])):
        normals, depths = _object_inputs(seed=bbox[0][1])
        kw = dict(model_bbox=bbox, model_bbox_last=last, model_radius=0.3,
                  model_pos=np.array([0.0, 0.05, 0.0], np.float32),
                  model_rot_inv=ROT, gen_shadow=gen_shadow, s_texSize=tex,
                  s_VP=vp, s_im=s_im)
        out_j = j_ins.render_insert_object(
            jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose),
            jnp.asarray(light), 0.6, 0.4, None, True, use_sg, use_sg,
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()})
        out_t = t_ins.render_insert_object(
            normals, depths, pose, light, 0.6, 0.4, None, True, use_sg,
            use_sg, **kw)
        for got, want in zip(out_t, out_j):
            close(got, want)
        close(t_ins.last_depth, j_ins.last_depth)
        frames.append(out_t[0])
    assert frames[0].shape == (24, 24, 3)
    assert np.isfinite(frames[1]).all()
    assert not np.array_equal(frames[0], frames[1])


def test_unported_options_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            t_main.NGPInsertor(make_hparams("x", device="cuda"))


def test_insertor_on_a_colmap_capture_matches_jax(tmp_path, monkeypatch):
    """NGPInsertor on a tiny COLMAP-format capture (datasets/captures.py):
    K, W, H and the dataset's blender_trans / blender_scale equal the JAX
    insertor's, first reading the dataset (read_meta=True), then, with a
    surface cache on disk, on the read_meta=False path, where neither
    package reads the images or the pose normalisation."""
    import arnerf_tpu.native as j_native
    from arnerf_tpu_torch.datasets.captures import write_colmap_capture
    monkeypatch.setattr(j_native, "_get_lib", lambda: None)
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "capture")
    write_colmap_capture(root, n_views=9, wh=(24, 16), focal=20.0,
                         n_points=200, n_samples=32)
    flags = dict(dataset_name="colmap", root_dir=root, downsample=0.5,
                 scale=16.0, low_resolution=1.0)
    for read_meta in (True, False):
        if not read_meta:
            for exp in ("c_jax", "c_port"):
                os.makedirs(f"insert/generate/{exp}", exist_ok=True)
                np.save(f"insert/generate/{exp}/surface.npy", np.zeros(1))
        j_ins = j_main.NGPInsertor(make_hparams("c_jax", **flags))
        t_ins = t_main.NGPInsertor(make_hparams("c_port", **flags))
        np.testing.assert_allclose(t_ins.K, j_ins.K, atol=1e-6, rtol=0)
        assert (t_ins.W, t_ins.H) == (j_ins.W, j_ins.H) == (12, 8)
        for k in ("blender_trans", "blender_scale"):
            want = getattr(j_ins.dataset, k, None)
            got = getattr(t_ins.dataset, k, None)
            assert (got is None) == (want is None) == (not read_meta)
            if read_meta:
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert len(t_ins.dataset.rays) == len(j_ins.dataset.rays) \
            == (7 if read_meta else 0)
