"""The port's insert modules (arnerf_tpu_torch/insert/) against the JAX
package's (arnerf_tpu/insert/) on the CPU, function by function, on seeded
numpy inputs.

Tolerances: 1e-5 absolute for closed-form math (SH, SG products, PBR
cores, grid samples, shadow factors) on O(1) values; 1e-4 for the SG
irradiance and the SG core built on it (a difference of two hemisphere
integrals ~30x the result, whose exps XLA and PyTorch round differently,
relative to the largest irradiance; absolute on the shaded colour); 1e-4
relative to each quantity's
largest magnitude for the optimizers (5 EnvOptim steps, 3 global-SH trainer
steps), whose Adam updates divide float32 gradient differences by
sqrt(nu); exact equality where both sides run the same numpy (RANSAC, the F
table, file round trips). Reinhard: 1e-5 against OpenCV (the JAX package's
operator) on the pixels OpenCV gives a finite value; its NaN at the image's
smallest value is the one departure, pinned by name.
"""

import hashlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu.insert import envfit as j_env
from arnerf_tpu.insert import global_light as j_gl
from arnerf_tpu.insert import insert_models as j_im
from arnerf_tpu.insert import render_utils as j_ru
from arnerf_tpu.insert import sg_shadow as j_sgs
from arnerf_tpu.insert import sh_math as j_sh
from arnerf_tpu.insert import shadow_fields as j_sf
from arnerf_tpu.insert import tonemapping as j_tm

from arnerf_tpu_torch.insert import envfit as t_env
from arnerf_tpu_torch.insert import global_light as t_gl
from arnerf_tpu_torch.insert import insert_models as t_im
from arnerf_tpu_torch.insert import main as t_main
from arnerf_tpu_torch.insert import render_utils as t_ru
from arnerf_tpu_torch.insert import sg_shadow as t_sgs
from arnerf_tpu_torch.insert import sh_math as t_sh
from arnerf_tpu_torch.insert import shadow_fields as t_sf
from arnerf_tpu_torch.insert import tonemapping as t_tm

torch.set_num_threads(2)
TOL = 1e-5
J_DATA = os.path.join(os.path.dirname(j_sh.__file__), "data")


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def rel_close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) <= tol * scale, \
        float(np.abs(a - b).max()) / scale


def _t(x):
    return torch.as_tensor(np.array(x))


def jit(fn, *static):
    """A JAX function compiled whole: one compile instead of one per
    primitive, which is most of these tests' time on the CPU."""
    return jax.jit(fn, static_argnums=static)


def _unit(rng, *shape):
    v = rng.normal(size=(*shape, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _sgs(rng, n, lam=(2.0, 30.0)):
    return np.concatenate([_unit(rng, n), rng.uniform(*lam, (n, 1)),
                           rng.uniform(0.1, 1.5, (n, 3))], -1) \
        .astype(np.float32)


# -- tonemapping, SH math ---------------------------------------------------

@pytest.mark.parametrize("name", ["tonemapping_simple_log",
                                  "tonemapping_simple_gamma",
                                  "tonemapping_simple_linear",
                                  "tonemapping_simple"])
def test_tonemapping(name):
    im = np.random.default_rng(0).uniform(0, 3, (5, 7, 3)).astype(np.float32)
    close(getattr(t_tm, name)(_t(im)), getattr(j_tm, name)(jnp.asarray(im)))


def _hdr(kind):
    rng = np.random.default_rng(0)
    if kind == "uniform":
        return rng.uniform(0, 4, (37, 53, 3)).astype(np.float32)
    sigma = {"lognormal1": 1.0, "lognormal3": 3.0}[kind]
    return np.exp(rng.normal(0, sigma, (96, 128, 3))).astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "lognormal1", "lognormal3"])
def test_reinhard_matches_opencv(kind):
    """tonemapping_complex_reinhard (torch, no cv2) against the JAX
    package's, which is OpenCV's createTonemapReinhard(2.2, 1, 0.5, 0):
    1e-5 on every pixel OpenCV gives a finite value, and the port gives a
    finite value everywhere."""
    im = _hdr(kind)
    want = j_tm.tonemapping_complex_reinhard(im)
    got = t_tm.tonemapping_complex_reinhard(_t(im)).numpy()
    fin = np.isfinite(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all() and fin.mean() > 0.999
    close(got[fin], want[fin])


def test_reinhard_constant_image_is_nan_as_in_opencv():
    """A constant image: max - min is 0, so the key is 0/0, NaN everywhere
    in both."""
    im = np.full((6, 9, 3), 0.7, np.float32)
    assert np.isnan(j_tm.tonemapping_complex_reinhard(im)).all()
    assert torch.isnan(t_tm.tonemapping_complex_reinhard(_t(im))).all()


def test_reinhard_departure_finite_at_the_minimum():
    """The departure, pinned: OpenCV's float32 scale-and-shift can map the
    image's smallest value a hair below 0, and its gamma then gives NaN
    there; the port maps it to exactly 0, and 0 ** (1 / 2.2) is 0."""
    im = _hdr("uniform")
    want = j_tm.tonemapping_complex_reinhard(im)
    got = t_tm.tonemapping_complex_reinhard(_t(im)).numpy()
    nan = np.isnan(want)
    assert nan.any(), "the fixture no longer shows OpenCV's NaN"
    assert (im[nan] == im.min()).all()
    assert (got[nan] == 0.0).all()


def _helper_inputs(name):
    rng = np.random.default_rng(9)
    if name == "geometry_schlick_ggx":
        return (rng.uniform(0.01, 1, (64, 1)), rng.uniform(0, 1, (64, 1)))
    if name == "tex2d":
        s = rng.uniform(-1.3, 1.3, (97, 2))
        s[:4] = [[-1, -1], [1, 1], [-1, 1], [0, 0]]
        return rng.uniform(0, 1, (5, 7, 3)), s
    if name == "tex3d":
        s = rng.uniform(-1.3, 1.3, (97, 3))
        s[:3] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0]]
        return rng.uniform(0, 1, (4, 5, 6, 2)), s
    if name == "normalize_eps":
        v = rng.normal(size=(33, 3))
        v[0] = 0.0
        return (v,)
    return (rng.normal(size=(2, 6, 7, 3)),)      # pts2normal


@pytest.mark.parametrize("name", ["geometry_schlick_ggx", "tex2d", "tex3d",
                                  "normalize_eps", "pts2normal",
                                  "enlarge_range"])
def test_insert_helpers_match_jax(name):
    """The six small insert helpers on seeded inputs (the samplers' in and
    out of [-1, 1], on the edges; a zero vector for normalize_eps): 1e-5;
    enlarge_range's integer box exactly, clipped at the screen on each
    side and inside it."""
    if name == "enlarge_range":
        from types import SimpleNamespace
        from arnerf_tpu.insert.main import NGPInsertor as JIns
        screen = SimpleNamespace(H=24, W=32)
        for bbox, scale in (([[2, 3], [10, 12]], 0.5),
                            ([[0, 0], [24, 32]], 0.25),
                            ([[8, 9], [12, 13]], 0.3)):
            got = t_main.NGPInsertor.enlarge_range(screen, bbox, scale)
            assert got == JIns.enlarge_range(screen, bbox, scale)
        return
    mod_t, mod_j = ((t_ru, j_ru) if name in ("geometry_schlick_ggx", "tex2d",
                                             "tex3d") else (t_sh, j_sh))
    args = [a.astype(np.float32) for a in _helper_inputs(name)]
    got = getattr(mod_t, name)(*map(_t, args))
    want = getattr(mod_j, name)(*map(jnp.asarray, args))
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_sh_basis_cubemap_and_coefficients():
    rng = np.random.default_rng(1)
    d = _unit(rng, 50)
    close(t_sh.sh9_basis(_t(d)), j_sh.sh9_basis(jnp.asarray(d)))
    close(t_sh.get_cubemap_rays(2, 8), j_sh.get_cubemap_rays(2, 8))
    close(t_sh.get_cubemap_rays(1, 8, keep_raw_dim=True),
          j_sh.get_cubemap_rays(1, 8, keep_raw_dim=True))
    rays = _unit(rng, 2, 300)
    rgb = rng.uniform(0, 1, (2, 300, 3)).astype(np.float32)
    coeff_t = t_sh.get_sh_coeff(_t(rays), _t(rgb))
    close(coeff_t, j_sh.get_sh_coeff(jnp.asarray(rays), jnp.asarray(rgb)))
    for shec in (coeff_t[0], coeff_t[0][None].expand(50, 9, 3)):
        for clamp in (False, True):
            close(t_sh.get_sh_val(shec, _t(d), clamp),
                  j_sh.get_sh_val(jnp.asarray(shec.numpy()), jnp.asarray(d),
                                  clamp))
    close(t_sh.sh_product0(coeff_t, coeff_t + 0.1),
          j_sh.sh_product0(jnp.asarray(coeff_t.numpy()),
                           jnp.asarray(coeff_t.numpy() + 0.1)))
    close(t_sh.get_sh_main_direction(coeff_t),
          j_sh.get_sh_main_direction(jnp.asarray(coeff_t.numpy())))
    close(t_sh.sh2envmap(coeff_t[0], 16, 32),
          j_sh.sh2envmap(jnp.asarray(coeff_t[0].numpy()), 16, 32))
    close(t_sh.sh2envmap(coeff_t[1], 8, 16, True),
          j_sh.sh2envmap(jnp.asarray(coeff_t[1].numpy()), 8, 16, True))


def test_sh_rotation_and_sphere_rays():
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    rot = q.astype(np.float32)
    dirs = _unit(rng, 400)
    rgb = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    close(t_sh.rotate_sh_by_recalc(_t(dirs), _t(rgb), _t(rot)),
          j_sh.rotate_sh_by_recalc(jnp.asarray(dirs), jnp.asarray(rgb),
                                   jnp.asarray(rot)))
    g = torch.Generator().manual_seed(0)
    sph = t_sh.get_sphere_rays(g, 3, 500)
    assert tuple(sph.shape) == (3, 500, 3)
    close(torch.linalg.norm(sph, dim=-1), np.ones((3, 500)))
    # uniform on the sphere: the mean direction is near zero
    assert float(sph.reshape(-1, 3).mean(0).abs().max()) < 0.1


def test_sh_triple_product():
    rng = np.random.default_rng(3)
    close(t_sh._compute_triple_product_table(),
          j_sh._compute_triple_product_table(), 1e-6)
    a = rng.normal(size=(4, 9, 3)).astype(np.float32)
    b = rng.normal(size=(4, 9, 1)).astype(np.float32)
    close(t_sh.sh9_product_93(_t(a), _t(b).expand(4, 9, 3)),
          j_sh.sh9_product_93(jnp.asarray(a),
                              jnp.broadcast_to(jnp.asarray(b), (4, 9, 3))))
    close(t_sh.sh9_product(_t(a[..., 0]), _t(b[..., 0])),
          j_sh.sh9_product(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0])))


def test_ply_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (20, 3)).astype(np.float32)
    t_sh.write2ply(rgbs, pts, str(tmp_path / "t.ply"))
    j_sh.write2ply(rgbs, pts, str(tmp_path / "j.ply"))
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    p_t, c_t = t_sh.read_ply(str(tmp_path / "j.ply"))
    p_j, c_j = j_sh.read_ply(str(tmp_path / "t.ply"))
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(c_t, c_j)


# -- PBR render cores -------------------------------------------------------

def test_irradiance_and_cubemaps():
    rng = np.random.default_rng(5)
    n = _unit(rng, 40)
    shec = rng.normal(size=(40, 9, 3)).astype(np.float32)
    for neg in (False, True):
        close(t_ru.sh9_irradiance(_t(n), _t(shec), neg),
              j_ru.sh9_irradiance(jnp.asarray(n), jnp.asarray(shec), neg))
    rays = _unit(rng, 40, 64)
    rgbs = rng.uniform(0, 1, (40, 64, 3)).astype(np.float32)
    close(t_ru.irradiance_numerical(_t(rgbs), _t(rays), _t(n)),
          j_ru.irradiance_numerical(jnp.asarray(rgbs), jnp.asarray(rays),
                                    jnp.asarray(n)))
    cube = rng.uniform(0, 1, (6 * 8 * 8, 3)).astype(np.float32)
    d = _unit(rng, 200)
    rough = rng.uniform(0, 1.2, (200, 1)).astype(np.float32)
    sample = jit(j_ru.cubemap_sample, 2, 4)
    for r, blur in ((None, True), (None, False), (rough, True)):
        close(t_ru.cubemap_sample(_t(cube), _t(d), 8,
                                  None if r is None else _t(r), blur),
              sample(jnp.asarray(cube), jnp.asarray(d), 8,
                     None if r is None else jnp.asarray(r), blur))
    close(t_ru.cubemap2env_map(_t(cube), 8, 16, 32),
          jit(j_ru.cubemap2env_map, 1, 2, 3)(jnp.asarray(cube), 8, 16, 32))
    img = rng.uniform(0, 1, (7, 9, 1)).astype(np.float32)
    j_blur = jit(lambda x: j_ru._gaussian_blur_3x3(j_ru._gaussian_blur_3x3(
        j_ru._gaussian_blur_3x3(j_ru._gaussian_blur_3x3(x)))))
    close(t_main._blur_hw1(_t(img), 9), j_blur(jnp.asarray(img)))


def _brdf_pair():
    """The neural BRDF as each package loads it from its own copy of
    model_brdf3.npz."""
    blob_j = np.load(os.path.join(J_DATA, "model_brdf3.npz"))
    blob_t = np.load(t_main.BRDF_PATH)
    assert sorted(blob_j.files) == sorted(blob_t.files)
    params_j = {"layers": [{"w": jnp.asarray(blob_j[f"w_{i}"]),
                            "b": jnp.asarray(blob_j[f"b_{i}"])}
                           for i in range(3)], "skips": ()}
    params_t = {"layers": [{"w": _t(blob_t[f"w_{i}"]),
                            "b": _t(blob_t[f"b_{i}"])} for i in range(3)],
                "skips": ()}
    return params_j, params_t


def test_neural_brdf_asset_is_the_same():
    digest = [hashlib.sha256(open(p, "rb").read()).hexdigest() for p in
              (os.path.join(J_DATA, "model_brdf3.npz"), t_main.BRDF_PATH)]
    assert digest[0] == digest[1]
    params_j, params_t = _brdf_pair()
    x = np.random.default_rng(6).normal(size=(30, 43)).astype(np.float32)
    out = t_im.mlp_skip_apply(params_t, _t(x))
    assert tuple(out.shape) == (30, 18)
    close(out, j_im.mlp_skip_apply(params_j, jnp.asarray(x)))


@pytest.mark.parametrize("refl,only_spec,clamp01", [
    (False, False, True), (True, False, True), (True, True, False)])
def test_sh_render_core(refl, only_spec, clamp01):
    rng = np.random.default_rng(7)
    n = 64
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    rough = rng.uniform(0.05, 1, (n, 1)).astype(np.float32)
    normal = _unit(rng, n)
    vdirs = _unit(rng, n)
    sh9 = rng.normal(0.3, 0.2, (n, 9, 3)).astype(np.float32)
    probe = rng.uniform(0, 1, (6 * 32 * 32, 3)).astype(np.float32)
    params_j, params_t = _brdf_pair()
    emb_j, _ = j_im.get_embedder(3)
    emb_t, _ = t_im.get_embedder(3)
    got = t_ru.sh_render_core(
        _t(albedo), _t(metal), _t(rough), _t(normal), _t(vdirs), _t(sh9),
        emb_t, lambda x: t_im.mlp_skip_apply(params_t, x), clamp01,
        _t(probe) if refl else None, only_spec)
    want = jit(lambda *a: j_ru.sh_render_core(
        *a[:6], emb_j, lambda x: j_im.mlp_skip_apply(params_j, x), clamp01,
        *a[6:], only_spec))(
        jnp.asarray(albedo), jnp.asarray(metal), jnp.asarray(rough),
        jnp.asarray(normal), jnp.asarray(vdirs), jnp.asarray(sh9),
        jnp.asarray(probe) if refl else None)
    close(got, want)
    assert float(got.abs().max()) > 0


@pytest.mark.parametrize("per_point", [False, True])
def test_sg_math_and_render_core(per_point):
    rng = np.random.default_rng(8)
    n, lx = 48, 5
    a, b = _sgs(rng, 20), _sgs(rng, 20)
    close(t_ru.sg_product(_t(a), _t(b)),
          jit(j_ru.sg_product)(jnp.asarray(a), jnp.asarray(b)))
    nrm = _unit(rng, 20)
    close(t_ru.sg_hemisphere_integral(_t(a), _t(nrm)),
          jit(j_ru.sg_hemisphere_integral)(jnp.asarray(a), jnp.asarray(nrm)))
    lights = _sgs(rng, lx)
    if per_point:
        lights = np.broadcast_to(lights, (n, lx, 7)).copy()
        lights[..., -3:] *= rng.uniform(0.2, 1, (n, lx, 1))
    normal = _unit(rng, n)
    vdirs = _unit(rng, n)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    metal = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    rough = rng.uniform(0.2, 1, (n, 1)).astype(np.float32)
    sg_l = lights if per_point else np.broadcast_to(lights, (n, lx, 7))
    rel_close(t_ru.sg_irradiance(_t(sg_l), _t(normal)),
              jit(j_ru.sg_irradiance)(jnp.asarray(sg_l), jnp.asarray(normal)))
    got = t_ru.sg_render_core(_t(albedo), _t(metal), _t(rough), _t(normal),
                              _t(vdirs), _t(lights), True, per_point)
    want = jit(j_ru.sg_render_core, 6, 7)(
        jnp.asarray(albedo), jnp.asarray(metal), jnp.asarray(rough),
        jnp.asarray(normal), jnp.asarray(vdirs), jnp.asarray(lights), True,
        per_point)
    close(got, want, 1e-4)
    assert float(got.abs().max()) > 0


# -- spherical Gaussian fitting ----------------------------------------------

def test_sg_parse_and_envmap():
    rng = np.random.default_rng(9)
    raw = rng.normal(size=(8, 7)).astype(np.float32)
    close(t_env.trans_raw_sg(_t(raw)), j_env.trans_raw_sg(jnp.asarray(raw)))
    close(t_env.envmap_dirs(6, 12, True), j_env.envmap_dirs(6, 12, True))
    close(t_env.sg2envmap(_t(raw), 16, 32),
          j_env.sg2envmap(jnp.asarray(raw), 16, 32))


def test_env_optim_five_steps_match_jax():
    """EnvOptim's fit (Adam 0.1 on 32 SGs) for 5 steps from the same
    initial SGs (JAX's draw) on the same env map."""
    rng = np.random.default_rng(10)
    im = rng.uniform(0, 1, (16, 32, 3)).astype(np.float32)
    init = np.asarray(j_env.EnvOptim().init_sgs)
    want, losses_j = j_env._fit_sgs(jnp.asarray(init), jnp.asarray(im), 5,
                                    16, 32)
    got, losses_t = t_env.fit_sgs(_t(init), _t(im), 5)
    rel_close(got, want)
    rel_close(torch.stack(losses_t), losses_j)
    opt = t_env.EnvOptim(n_iter=5)
    opt.init_sgs = opt.lgt_sgs = _t(init)
    rel_close(opt.eval(_t(im)), want)
    # warm start: the next fit starts from the last one
    rel_close(opt.eval(_t(im)), j_env._fit_sgs(want, jnp.asarray(im), 5, 16,
                                               32)[0])
    # the port's own draw: standard normals with lambda scaled by 100
    assert float(t_env.EnvOptim().init_sgs[:, 3].abs().mean()) > 20


# -- global-SH inverse rendering --------------------------------------------

def test_embedder_and_skip_mlp():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    e_t, d_t = t_im.get_embedder(4)
    e_j, d_j = j_im.get_embedder(4)
    assert d_t == d_j == 27
    close(e_t(_t(x)), e_j(jnp.asarray(x)))
    params_j = j_im.mlp_skip_init(jax.random.PRNGKey(0), 27, 3, D=3, W=16,
                                  skips=(1,))
    params_t = {"layers": [{k: _t(np.asarray(v)) for k, v in layer.items()}
                           for layer in params_j["layers"]],
                "skips": (1,)}
    mine = t_im.mlp_skip_init(torch.Generator().manual_seed(0), 27, 3, D=3,
                              W=16, skips=(1,))
    assert [tuple(lay["w"].shape) for lay in mine["layers"]] == \
        [tuple(lay["w"].shape) for lay in params_j["layers"]]
    feats = rng.normal(size=(10, 27)).astype(np.float32)
    close(t_im.mlp_skip_apply(params_t, _t(feats)),
          j_im.mlp_skip_apply(params_j, jnp.asarray(feats)))
    sh = t_im.init_global_sh(torch.Generator().manual_seed(0))
    assert tuple(sh.shape) == (9, 3) and bool((sh[0] >= 0).all())


def _prec_data(rng, n=256):
    normal = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (n, 1))
    pts = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    gt = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    # a bright ambient probe keeps the irradiance positive, so that the HDR
    # mapping's fractional power stays real
    rgb_shs = rng.normal(0.0, 0.05, (n, 9, 3)).astype(np.float32)
    rgb_shs[:, 0] = 2.0
    opc_shs = rng.normal(0.0, 0.05, (n, 9, 1)).astype(np.float32)
    return pts, normal, gt, rgb_shs, opc_shs


@pytest.mark.parametrize("hdr", [False, True])
def test_global_sh_trainer_three_steps_match_jax(hdr):
    """make_prec_train_step's scale_by_adam + count-based step decay
    against the port's PrecTrainer: the same initial parameters (JAX's),
    batches and smoothness jitter (JAX's draws from each step's key)."""
    j_sh._triple_table()   # JAX builds it eagerly, not inside its jit
    rng = np.random.default_rng(12)
    pts, normal, gt, rgb_shs, opc_shs = _prec_data(rng)
    embed_j, in_ch = j_im.get_embedder(4)
    embed_t, _ = t_im.get_embedder(4)
    params_j = {"mlp": j_im.mlp_skip_init(jax.random.PRNGKey(1), in_ch, 3,
                                          D=2, W=64),
                "global_sh": j_im.init_global_sh(jax.random.PRNGKey(2))}
    kw = dict(hdr_mapping=hdr, mat_smooth_range=1e-2, mat_smooth_weight=0.2,
              lrate=1e-2, lrate_decay=2)     # decays after the 2nd update
    tx, step = j_im.make_prec_train_step(embed_j, **kw)
    opt_state = tx.init(params_j)
    trainer = t_im.PrecTrainer(
        {"mlp": {"layers": [{k: _t(np.asarray(v)) for k, v in lay.items()}
                            for lay in params_j["mlp"]["layers"]],
                 "skips": ()},
         "global_sh": _t(np.asarray(params_j["global_sh"]))}, embed_t, **kw)
    data = {"pts": pts, "gt": gt, "normal": normal, "rgb_shs": rgb_shs,
            "opc_shs": opc_shs}
    key = jax.random.PRNGKey(3)
    for i in range(3):
        key, k = jax.random.split(key)
        sl = slice(i * 80, i * 80 + 80)
        batch = {n: v[sl] for n, v in data.items()}
        params_j, opt_state, loss_j = step(
            params_j, opt_state, {n: jnp.asarray(v) for n, v in batch.items()},
            k, white_strong=i < 2)
        jitter = np.asarray(jax.random.uniform(k, batch["pts"].shape))
        loss_t = trainer.step({n: _t(v) for n, v in batch.items()},
                              _t(jitter), white_strong=i < 2)
        rel_close(loss_t, loss_j)
    rel_close(trainer.params["global_sh"], params_j["global_sh"])
    # each layer relative to its largest parameter: the biases start at 0,
    # so alone they are Adam steps, where m / sqrt(nu) of a near-zero
    # gradient amplifies float32 differences
    for lay_t, lay_j in zip(trainer.params["mlp"]["layers"],
                            params_j["mlp"]["layers"]):
        rel_close(torch.cat([lay_t["w"].reshape(-1), lay_t["b"]]),
                  np.concatenate([np.ravel(lay_j["w"]), lay_j["b"]]))


def test_mat_sh_checkpoints_load_across_packages(tmp_path):
    """A mat_sh_*.npz written by JAX loads in the port, and one written by
    the port resumes the JAX trainer (iters = its epoch: nothing left to
    train, so the JAX trainer returns what it loaded)."""
    params_j = {"mlp": j_im.mlp_skip_init(jax.random.PRNGKey(4), 27, 3, D=2,
                                          W=64),
                "global_sh": j_im.init_global_sh(jax.random.PRNGKey(5))}
    j_im.save_mat_sh_ckpt(str(tmp_path), params_j, 7)
    loaded, epoch = t_im.load_mat_sh_ckpt(str(tmp_path / "mat_sh_000007.npz"))
    assert epoch == 7 and loaded["mlp"]["skips"] == ()
    np.testing.assert_array_equal(loaded["global_sh"].numpy(),
                                  np.asarray(params_j["global_sh"]))
    for lay_t, lay_j in zip(loaded["mlp"]["layers"],
                            params_j["mlp"]["layers"]):
        np.testing.assert_array_equal(lay_t["w"].numpy(),
                                      np.asarray(lay_j["w"]))

    port_dir = tmp_path / "port"
    port_dir.mkdir()
    loaded["global_sh"] = loaded["global_sh"] + 1.0
    t_im.save_mat_sh_ckpt(str(port_dir), loaded, 199)
    pts, normal, gt, _, _ = _prec_data(np.random.default_rng(13), 16)
    gsh = j_im.train_global_env_prec(pts, normal, gt, None, None,
                                     str(port_dir), iters=199)
    np.testing.assert_array_equal(gsh, loaded["global_sh"].numpy())
    again, epoch = t_im.load_mat_sh_ckpt(str(port_dir / "mat_sh_000198.npz"))
    assert epoch == 198
    np.testing.assert_array_equal(again["mlp"]["layers"][1]["w"].numpy(),
                                  loaded["mlp"]["layers"][1]["w"].numpy())


def test_train_global_env_prec_runs_and_resumes(tmp_path):
    pts, normal, gt, rgb_shs, opc_shs = _prec_data(np.random.default_rng(14))
    gsh = t_im.train_global_env_prec(pts, normal, gt, rgb_shs, opc_shs,
                                     str(tmp_path), iters=4, batch=100,
                                     ckpt_save=2, lrate=1e-3)
    assert gsh.shape == (9, 3) and np.isfinite(gsh).all()
    assert sorted(os.listdir(tmp_path)) == ["mat_sh_000002.npz",
                                            "mat_sh_000003.npz"]
    # the newest checkpoint holds epoch 3; iters=3 leaves nothing to train
    again = t_im.train_global_env_prec(pts, normal, gt, rgb_shs, opc_shs,
                                       str(tmp_path), iters=3)
    np.testing.assert_array_equal(again, gsh)
    legacy = t_im.train_global_env(pts, normal, gt, str(tmp_path), iters=2,
                                   batch=128)
    assert legacy.shape == (9, 3) and np.isfinite(legacy).all()


# -- shadow fields ------------------------------------------------------------

@pytest.mark.parametrize("align", [True, False])
def test_grid_samples_in_and_out_of_range(align):
    rng = np.random.default_rng(15)
    vol = rng.normal(size=(4, 5, 6, 7)).astype(np.float32)
    img = rng.normal(size=(3, 6, 9)).astype(np.float32)
    inside = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    outside = rng.uniform(-3, 3, (100, 3)).astype(np.float32)
    pts = np.concatenate([inside, outside, np.float32([[1, 1, 1],
                                                       [-1, -1, -1]])])
    close(t_sf.grid_sample_3d(_t(vol), _t(pts), align),
          j_sf.grid_sample_3d(jnp.asarray(vol), jnp.asarray(pts), align))
    close(t_sf.grid_sample_2d(_t(img), _t(pts[:, :2]), align),
          j_sf.grid_sample_2d(jnp.asarray(img), jnp.asarray(pts[:, :2]),
                              align))


@pytest.mark.parametrize("rot", [False, True])
def test_soft_shadow_map(rot, tmp_path):
    rng = np.random.default_rng(16)
    sf_t, sf_j = t_sf.SimplifySF(grid=12), j_sf.SimplifySF(grid=12)
    close(sf_t.sf_vol, sf_j.sf_vol)
    light = rng.normal(0.0, 0.05, (1, 9, 3)).astype(np.float32)
    light[:, 0] = 2.0           # mostly ambient
    pos = np.float32([0.1, -0.2, 0.05])
    pts = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    r = q.astype(np.float32) if rot else None
    for sft, sfj in ((sf_t, sf_j), (t_sf.ComplexSF(_sf_file(tmp_path)),
                                    j_sf.ComplexSF(_sf_file(tmp_path)))):
        got = t_sf.soft_shadow_map(sft, _t(pos), 0.7, _t(light), _t(pts),
                                   None if r is None else _t(r))
        want = j_sf.soft_shadow_map(sfj, jnp.asarray(pos), 0.7,
                                    jnp.asarray(light), jnp.asarray(pts),
                                    None if r is None else jnp.asarray(r))
        close(got, want)
        assert float(got.min()) < float(got.max()) <= 1.0


def _sf_file(tmp_path):
    path = tmp_path / "vol.txt"
    if not path.exists():
        vol = np.random.default_rng(17).normal(2.0, 0.5, (30 * 30 * 30, 9))
        np.savetxt(path, vol, fmt="%.5f")
    return str(path)


def test_shadow_field_volume_files(tmp_path):
    txt = _sf_file(tmp_path)
    t_sf.transform_sf_txt(txt, str(tmp_path / "t.npz"))
    j_sf.transform_sf_txt(txt, str(tmp_path / "j.npz"))
    vol = np.load(tmp_path / "j.npz")["sf"]
    assert vol.shape == (9, 30, 30, 30)
    np.testing.assert_array_equal(np.load(tmp_path / "t.npz")["sf"], vol)
    torch.save(torch.from_numpy(vol[None]), tmp_path / "v.tar")
    for path in (txt, str(tmp_path / "j.npz"), str(tmp_path / "v.tar")):
        np.testing.assert_array_equal(t_sf.load_sf_volume(path), vol)


# -- SG-SSDF shadows ---------------------------------------------------------

def test_fh_table_small_grid():
    got = t_sgs.compute_fh_table(theta_num=32, lbd_num=256, zeta_num=16)
    want = j_sgs.compute_fh_table(theta_num=32, lbd_num=256, zeta_num=16)
    assert got.shape == (256, 32)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pca_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pca")
    rng = np.random.default_rng(18)
    arrays = dict(
        coeff=rng.normal(0, 0.02, (20 * 20 * 20, 16)).astype(np.float32),
        component=rng.normal(0, 0.05, (16, 12, 24)).astype(np.float32),
        mean=np.full((1, 12, 24), 0.3, np.float32))
    np.savez(tmp / "pca.npz", **arrays)
    torch.save({k: torch.from_numpy(v) for k, v in arrays.items()},
               tmp / "pca.tar")
    return str(tmp / "pca.npz"), str(tmp / "pca.tar")


@pytest.mark.parametrize("rot", [False, True])
def test_sg_shadow_matches_jax(pca_files, rot, monkeypatch):
    npz, tar = pca_files
    for a, b in zip(t_sgs.load_pca_volume(npz), t_sgs.load_pca_volume(tar)):
        np.testing.assert_array_equal(a, b)
    tab = np.load(os.path.join(J_DATA, "fh_pretab.npy"))
    for mod in (j_sgs, t_sgs):
        monkeypatch.setattr(mod, "get_fh_table", lambda: tab)
    s_j = j_sgs.SGShadow(npz, 20, 16, 2)
    s_t = t_sgs.SGShadow(tar, 20, 16, 2)
    rng = np.random.default_rng(19)
    lights = _sgs(rng, 6, (1.0, 80.0))
    pts = rng.uniform(-1.5, 1.5, (50, 3)).astype(np.float32)
    pos = np.float32([0.1, 0.0, -0.1])
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    r = q.astype(np.float32) if rot else None
    args_t = (0.4, _t(pts), _t(pos), _t(lights), None if r is None else _t(r))
    args_j = (0.4, jnp.asarray(pts), jnp.asarray(pos), jnp.asarray(lights),
              None if r is None else jnp.asarray(r))
    # each JAX method compiled whole; it stores the light-dependent PCA
    # basis on the object inside its own trace before using it
    close(s_t.calc_shadow_factor(*args_t),
          jit(s_j.calc_shadow_factor, 0)(*args_j))
    decayed = s_t.calc_self_shadow_light_decay(*args_t)
    assert tuple(decayed.shape) == (50, 6, 7)
    close(decayed, jit(s_j.calc_self_shadow_light_decay, 0)(*args_j))


# -- planes ------------------------------------------------------------------

def _plane_scene(rng, n=3000):
    floor = np.concatenate([rng.uniform(-1, 1, (n, 1)),
                            rng.normal(0.3, 0.003, (n, 1)),
                            rng.uniform(-1, 1, (n, 1))], 1)
    wall = np.concatenate([rng.normal(-0.6, 0.003, (n // 2, 1)),
                           rng.uniform(-1, 0.3, (n // 2, 1)),
                           rng.uniform(-1, 1, (n // 2, 1))], 1)
    clutter = rng.uniform(-1, 1, (n // 3, 3))
    pts = np.concatenate([floor, wall, clutter]).astype(np.float32)
    normals = np.concatenate([np.tile([0.0, -1.0, 0.0], (n, 1)),
                              np.tile([1.0, 0.0, 0.0], (n // 2, 1)),
                              _unit(rng, n // 3)]).astype(np.float32)
    rgbs = rng.uniform(0, 1, pts.shape).astype(np.float32)
    return pts, normals, rgbs


def test_ransac_plane_is_bit_identical():
    pts, _, _ = _plane_scene(np.random.default_rng(20))
    eq_t, in_t = t_gl.ransac_plane(pts, 0.02, rng=np.random.default_rng(1))
    eq_j, in_j = j_gl.ransac_plane(pts, 0.02, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(eq_t, eq_j)
    np.testing.assert_array_equal(in_t, in_j)
    assert len(in_t) >= 3000


def test_global_light_estimator_matches_jax(tmp_path):
    pts, normals, rgbs = _plane_scene(np.random.default_rng(21))
    out = {}
    for name, mod in (("t", t_gl), ("j", j_gl)):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "surface.npy", {"rgbs": rgbs, "spts": pts,
                                    "normals": normals})
        gle = mod.GlobalLightEstimator(str(d), pts_use=5000)
        gle.detect_planar_patch(min_pts_in_plane=800)
        gle.save_results()
        out[name] = gle
        again = mod.GlobalLightEstimator(str(d))
        assert again.calc_complete
        np.testing.assert_array_equal(again.t_pts, gle.t_pts)
    for k in ("t_pts", "t_rgbs", "t_normal"):
        np.testing.assert_array_equal(getattr(out["t"], k),
                                      getattr(out["j"], k))
    # two planes found, normals oriented along the surface normals
    assert len(np.unique(out["t"].t_normal.round(3), axis=0)) == 2
