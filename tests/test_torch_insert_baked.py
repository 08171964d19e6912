"""AR serving on the baked field (ARNERF_INSERT_BAKED=1): the port's insertor
against the JAX package's on the CPU.

Both insertors are tests/test_torch_insertor.py's pair (24x24 synthetic
frames, a small JAX-initialised model, the same sphere occupancy) built
with ARNERF_INSERT_BAKED=1 and baking at ARNERF_INSERT_BAKE_RES=32. The
bakes are compared first; every render after that runs on the JAX bake,
copied into the port's BakedField, so that each case holds one program
of the port against JAX's on the same tables. Both insertors start each
case from the same threefry key, and end it with the same key.

Tolerances: 1e-5 absolute on the probes' rays, the rects, the frames and
the frame buffers, and 1e-5 of the largest entry on the bake's rows (its
codes and bounds exactly). Two cases are looser, each for a rounding of
JAX's measured in its docstring: SH coefficients summed over 2,048 rays,
and the colours of SG frames (1e-4).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import arnerf_tpu.insert.main as j_main
from arnerf_tpu import rendering_baked as jrb

from arnerf_tpu_torch.insert import sg_shadow as t_sg_shadow
from arnerf_tpu_torch.ops import threefry
from tests.test_torch_baked import _assert_same_bake, _fields, _masks, \
    _to_port
from tests.test_torch_insertor import (FH_PRETAB, ROT, _light_sgs,
                                       _object_inputs, build_pair)

torch.set_num_threads(2)

TOL = 1e-5
BAKE_RES = 32


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


def same_keys(pair, seed):
    j_ins, t_ins = pair
    j_ins.key = jax.random.PRNGKey(seed)
    t_ins.key = threefry.prng_key(seed)


def assert_same_key(pair):
    j_ins, t_ins = pair
    np.testing.assert_array_equal(np.asarray(t_ins.key),
                                  np.asarray(j_ins.key))


def _j(v):
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """An SSDF PCA volume and a shadow-field volume, seeded."""
    tmp = tmp_path_factory.mktemp("baked_assets")
    rng = np.random.default_rng(3)
    np.savez(tmp / "pca.npz",
             coeff=rng.normal(0, 0.02, (20 * 20 * 20, 128)).astype(np.float32),
             component=rng.normal(0, 0.05, (128, 74, 148)).astype(np.float32),
             mean=np.full((1, 74, 148), 0.3, np.float32))
    vol = 3.0 + np.random.default_rng(4).normal(0, 0.3, (9, 30, 30, 30))
    np.savez(tmp / "sf.npz", sf=vol.astype(np.float32))
    return str(tmp / "pca.npz"), str(tmp / "sf.npz")


@pytest.fixture(scope="module")
def baked(tmp_path_factory, assets):
    """(JAX insertor, port insertor, JAX bake, the port's own bake); the
    port insertor renders from a copy of the JAX bake."""
    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("insert_baked"))
    mp.setattr(t_sg_shadow, "get_fh_table", lambda: np.load(FH_PRETAB))
    mp.setenv("ARNERF_INSERT_BAKED", "1")
    mp.setenv("ARNERF_INSERT_BAKE_RES", str(BAKE_RES))
    try:
        scene = pytest.MonkeyPatch()       # the small scene, while building
        j_ins, t_ins = build_pair(scene)
        scene.undo()
        assert j_ins.use_baked and t_ins.use_baked
        for ins in (j_ins, t_ins):
            ins.set_sg_shadow(assets[0])
            ins.set_sf(assets[1])
            ins.global_sh = ins.global_sh * 0 + 0.3
        jb = j_ins._get_baked()
        tb = t_ins._get_baked()
        t_ins._baked = _to_port(jb)
        yield j_ins, t_ins, jb, tb
    finally:
        mp.undo()
        os.chdir(cwd)


@pytest.fixture
def pair(baked):
    j_ins, t_ins = baked[:2]
    for ins in (j_ins, t_ins):
        ins.last_rgb = ins.last_depth = None
    yield j_ins, t_ins
    for ins in (j_ins, t_ins):
        ins.hparams.render_HDR_mapping = False


def test_get_baked_matches_jax(baked):
    """bake_ngp at ARNERF_INSERT_BAKE_RES with 16 directions, exact
    corners on the CPU in both packages."""
    jb, tb = baked[2:]
    assert tb.resolution == jb.resolution == BAKE_RES
    assert int(tb.rows_q.shape[0]) > 1
    _assert_same_bake(tb, jb)


def test_fast_sh_probe_matches_jax(pair):
    """The serving SH probe: one uniform baked render of the cubemap
    directions, the background blend and the SH9 projection."""
    j_ins, t_ins = pair
    same_keys(pair, 3)
    j_ins._probe_fused = None
    pt = [0.05, -0.1, 0.02]
    sh_j = j_ins.generate_probe(jnp.asarray(pt), sh_probe=True)
    sh_t = t_ins.generate_probe(pt, sh_probe=True)
    assert tuple(sh_t.shape) == (1, 9, 3)
    assert float(sh_t.abs().sum()) > 0
    close(sh_t, sh_j)
    close(t_ins.cubemap_rgb, j_ins.cubemap_rgb)
    assert_same_key(pair)


def test_probe_render_matches_jax(pair, monkeypatch):
    """The probes that go through render_baked: the envmap probe of
    generate_probe, _probe_render's rays, and generate_sh_probes and
    generate_sh_probes_for_precompute with the same sphere directions.
    Their SH coefficients are float32 sums over 2,048 rays a probe: JAX's
    (XLA's reduction order) lie 2.7e-5 from the float64 sum of the same
    rays where the port's lie 4.8e-7, so they are held to 1e-4; the rays
    themselves to 1e-5."""
    j_ins, t_ins = pair
    same_keys(pair, 4)
    pt = [0.0, 0.05, -0.05]
    env_j = j_ins.generate_probe(jnp.asarray(pt), return_envmap=True)
    env_t = t_ins.generate_probe(pt, return_envmap=True)
    close(env_t, env_j)
    close(t_ins.cubemap_rgb, j_ins.cubemap_rgb)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    u = rng.random((2, 3, 2048)).astype(np.float32)
    from arnerf_tpu_torch.insert.sh_math import sphere_dirs
    dirs = sphere_dirs(torch.as_tensor(1.0 - 2.0 * u[0]),
                       torch.as_tensor(u[1])).numpy()
    ro = np.broadcast_to(pts[:, None], dirs.shape).reshape(-1, 3)
    got = t_ins._probe_render(torch.as_tensor(ro), torch.as_tensor(dirs)
                              .reshape(-1, 3), blend_bkg=False,
                              need_opacity=True)
    want = j_ins._probe_render(jnp.asarray(ro), jnp.asarray(dirs)
                               .reshape(-1, 3), blend_bkg=False,
                               need_opacity=True)
    for k in ("rgb", "opacity", "depth"):
        close(got[k], want[k])
    assert float(got["opacity"].max()) > 0.5
    monkeypatch.setattr(j_main, "get_sphere_rays",
                        lambda key, n, m: jnp.asarray(dirs))
    got = t_ins.generate_sh_probes(pts, ray_dirs=dirs)
    want = j_ins.generate_sh_probes(jnp.asarray(pts))
    assert tuple(got.shape) == (3, 9, 3)
    close(got, want, 1e-4)
    rgb_t, opc_t = t_ins.generate_sh_probes_for_precompute(pts, ray_dirs=dirs)
    rgb_j, opc_j = j_ins.generate_sh_probes_for_precompute(jnp.asarray(pts))
    close(rgb_t, rgb_j, 1e-4)
    close(opc_t, opc_j, 1e-4)
    assert_same_key(pair)


def _rect_rays(ins, pose, rows, cols):
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    d = ins.directions[rows, cols].reshape(-1, 3)
    return get_rays(d, torch.as_tensor(np.asarray(pose)))


def test_render_scene_baked_matches_jax(pair):
    """The general path's rect: padded to 1024 rays, far bound clamped at
    a mesh depth (0 where there is no mesh), the object blended in."""
    j_ins, t_ins = pair
    same_keys(pair, 5)
    pose = j_ins.dataset.poses[1]
    ro, rd = _rect_rays(t_ins, pose, slice(3, 17), slice(5, 16))
    n = ro.shape[0]
    rng = np.random.default_rng(6)
    im_bkg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    mesh_depth = rng.uniform(0.6, 1.6, n).astype(np.float32)
    mesh_depth[::3] = 0.0
    rgb_j, dep_j = j_ins._render_scene_baked(
        jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), jnp.asarray(im_bkg),
        jnp.asarray(mesh_depth))
    rgb_t, dep_t = t_ins._render_scene_baked(ro, rd, torch.as_tensor(im_bkg),
                                             torch.as_tensor(mesh_depth))
    assert tuple(rgb_t.shape) == (n, 3)
    close(rgb_t, rgb_j)
    close(dep_t, dep_j)
    assert float(dep_t.max()) > 0.1
    assert_same_key(pair)


TEX = 16
VP = np.array([[1.2, 0, 0, 0.1], [0, 1.2, 0, -0.05],
               [0, 0, -1.0, 0.4], [0, 0, -1.0, 1.6]], np.float32)
# (use SG light, self shadow, gen_shadow, rotation, HDR mapping, bbox,
#  the last frame's bbox)
FRAMES = {
    "sh_shadow_field": (False, False, 1, False, False, [[6, 5], [14, 13]],
                        None),
    "sh_shadow_field_rot": (False, False, 1, True, False, [[6, 5], [14, 13]],
                            [[7, 6], [15, 14]]),
    "sh_shadow_map": (False, False, 2, True, False, [[4, 8], [12, 16]],
                      [[5, 8], [13, 16]]),
    "sg_self_shadow_ssdf": (True, True, 1, True, False, [[6, 5], [14, 13]],
                            [[6, 4], [14, 12]]),
    "sg_no_shadow": (True, False, 0, False, False, [[8, 8], [16, 16]],
                     [[8, 9], [16, 17]]),
    "hdr_mapping": (False, False, 1, False, True, [[6, 5], [14, 13]],
                    [[5, 5], [13, 13]]),
    # the rect widens to 10x10 at the frame's corner: a 16x16 window
    # clamped to rows and columns 8-23
    "wide_rect_at_corner": (False, False, 1, True, False,
                            [[14, 15], [22, 23]], [[12, 13], [20, 21]]),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_fused_frame_matches_jax(pair, case):
    """_try_render_insert_fused on both insertors: the frame, last_rgb and
    last_depth from frame buffers that already hold a frame; the port's
    pixels outside the update rect keep their values bit for bit. The
    colours of SG frames are held to 1e-4: JAX compiles the SG shade into
    its frame program, and XLA's fusion moves that shade by up to 2.0e-5
    from JAX's own eager one (which the port's meets to 2.5e-6; the 24x24
    frames of the two SG cases)."""
    use_sg, self_shadow, gen_shadow, rot, hdr, bbox, last = FRAMES[case]
    j_ins, t_ins = pair
    same_keys(pair, 6)
    pt = [0.0, 0.05, 0.0]
    j_ins.generate_probe(jnp.asarray(pt), sh_probe=True)    # cubemap_rgb
    sh = t_ins.generate_probe(pt, sh_probe=True)
    light = _light_sgs(7) if use_sg else sh.numpy()
    rng = np.random.default_rng(11)
    prev_rgb = rng.uniform(0, 1, (24, 24, 3)).astype(np.float32)
    prev_dep = rng.uniform(0.5, 2, (24, 24, 1)).astype(np.float32)
    j_ins.last_rgb, j_ins.last_depth = (jnp.asarray(prev_rgb),
                                        jnp.asarray(prev_dep))
    t_ins.last_rgb, t_ins.last_depth = (torch.tensor(prev_rgb),
                                        torch.tensor(prev_dep))
    for ins in pair:
        ins.hparams.render_HDR_mapping = hdr
    j_ins._frame_fused = None          # JAX caches without the HDR flag
    normals, depths = _object_inputs(seed=bbox[0][1])
    kw = dict(model_bbox=bbox, model_bbox_last=last, model_radius=0.3,
              model_pos=np.array([0.0, 0.05, 0.0], np.float32),
              model_rot_inv=ROT if rot else None, gen_shadow=gen_shadow,
              s_texSize=TEX, s_VP=VP,
              s_im=rng.uniform(0.3, 0.9, (TEX, TEX, 1)).astype(np.float32))
    pose = j_ins.dataset.poses[2]
    args = (0.6, 0.4, None, use_sg, self_shadow)
    out_j = j_ins._try_render_insert_fused(
        jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose),
        jnp.asarray(light), *args, {k: _j(v) for k, v in kw.items()})
    out_t = t_ins._try_render_insert_fused(normals, depths, pose, light,
                                           *args, kw)
    assert out_j is not None and out_t is not None
    assert out_t.shape == (24, 24, 3) and np.isfinite(out_t).all()
    tol = 1e-4 if use_sg else TOL
    close(out_t, out_j, tol)
    close(t_ins.last_rgb, j_ins.last_rgb, tol)
    close(t_ins.last_depth, j_ins.last_depth)
    (r0, c0), (r1, c1) = t_ins.get_update_range(bbox, last)
    outside = np.ones((24, 24), bool)
    outside[r0:r1, c0:c1] = False
    assert np.array_equal(t_ins.last_rgb.numpy()[outside],
                          prev_rgb[outside])
    assert np.array_equal(t_ins.last_depth.numpy()[outside],
                          prev_dep[outside])
    assert not np.array_equal(t_ins.last_rgb.numpy()[~outside],
                              prev_rgb[~outside])
    assert_same_key(pair)


def test_fused_sg_frame_stays_finite_where_jax_pads_nan(pair):
    """Departure from the JAX package: JAX shades the object's box padded
    to 8x8 here, and its pad pixels (zero normals, depth 0) shade to NaN
    under SG light, which the mask's product keeps; with no last bbox the
    rect is the whole frame, so the NaN reaches the frame. The port shades
    the box itself and selects 0 off the object (its render_object):
    its frame is finite, and equal to JAX's on every other pixel."""
    j_ins, t_ins = pair
    same_keys(pair, 9)
    bbox = [[6, 5], [12, 11]]
    normals, depths = _object_inputs(seed=3, h=6, w=6)
    kw = dict(model_bbox=bbox, model_bbox_last=None, model_radius=0.3,
              model_pos=np.array([0.0, 0.05, 0.0], np.float32),
              model_rot_inv=None, gen_shadow=0)
    pose = j_ins.dataset.poses[2]
    light = _light_sgs(7)
    out_j = j_ins._try_render_insert_fused(
        jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose),
        jnp.asarray(light), 0.6, 0.4, None, True, False,
        {k: _j(v) for k, v in kw.items()})
    out_t = t_ins._try_render_insert_fused(normals, depths, pose, light, 0.6,
                                           0.4, None, True, False, kw)
    pad = np.zeros((24, 24), bool)
    pad[6:14, 5:13] = True
    pad[6:12, 5:11] = False
    assert np.array_equal(np.isnan(out_j).any(-1), pad)
    assert np.isfinite(out_t).all()
    close(out_t[~pad], out_j[~pad], 1e-4)
    assert_same_key(pair)


ROUTES = {
    "fused": dict(),                  # the base case: a fused frame
    "not_baked": dict(use_baked=False),
    "use_EXR": dict(use_EXR=True),
    "albedo": dict(albedo=np.ones((1, 3), np.float32)),
    "metal_map": dict(metal=np.full((8, 8), 0.5, np.float32)),
    "rough_map": dict(rough=np.full((8, 8), 0.5, np.float32)),
    "no_bbox": dict(model_bbox=None),
    "empty_bbox": dict(model_bbox=[[6, 5], [6, 13]]),
    "bbox_taller_than_frame": dict(model_bbox=[[0, 5], [25, 13]]),
    "shadow_without_position": dict(model_pos=None),
    "self_shadow_without_radius": dict(use_sg=True, gen_shadow=0,
                                       model_radius=None),
    "shadow_field_not_loaded": dict(sf=None),
    "rotated_shadow_field_without_cubemap": dict(model_rot_inv=ROT,
                                                 cubemap_rgb=None),
    "shadow_map_without_vp": dict(gen_shadow=2, s_VP=None),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_general_path_routing_matches_jax(pair, case):
    """Every configuration for which JAX's _try_render_insert_fused sends
    the frame to the general path (returns None) does so in the port; the
    base case, which each other case changes in one input, is a fused
    frame in both."""
    j_ins, t_ins = pair
    over = dict(ROUTES[case])
    normals, depths = _object_inputs()
    kw = dict(model_bbox=[[6, 5], [14, 13]], model_bbox_last=None,
              model_radius=0.3, model_pos=np.zeros(3, np.float32),
              model_rot_inv=None, gen_shadow=1, s_texSize=TEX, s_VP=VP,
              s_im=np.full((TEX, TEX, 1), 0.5, np.float32))
    args = dict(metal=0.6, rough=0.4, albedo=None, use_sg=False)
    for k in list(over):
        if k in kw:
            kw[k] = over.pop(k)
        elif k in args:
            args[k] = over.pop(k)
    saved = []
    for k, v in over.items():         # insertor state: use_baked, sf, ...
        for ins in pair:
            obj = ins.hparams if k == "use_EXR" else ins
            saved.append((obj, k, getattr(obj, k)))
            setattr(obj, k, v)
    try:
        pose = j_ins.dataset.poses[0]
        out_j = j_ins._try_render_insert_fused(
            jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose),
            jnp.zeros((1, 9, 3)), args["metal"], args["rough"],
            args["albedo"], args["use_sg"], True,
            {k: _j(v) for k, v in kw.items()})
        out_t = t_ins._try_render_insert_fused(
            normals, depths, pose, np.zeros((1, 9, 3), np.float32),
            args["metal"], args["rough"], args["albedo"], args["use_sg"],
            True, kw)
    finally:
        for obj, k, v in saved:
            setattr(obj, k, v)
    if case == "fused":
        assert out_j is not None and out_t is not None
    else:
        assert out_j is None and out_t is None


def test_key_sequence_and_general_frame_match_jax(pair, monkeypatch):
    """A sequence of calls leaves both insertors with the same key: a
    sphere-sampled probe direction set (JAX draws it from the key, the port
    from its generator, and both split the key), sphere probes, a fast SH
    probe, a fused frame and a saved frame (full_return: the general path,
    its rect on the baked field), whose outputs match JAX's."""
    j_ins, t_ins = pair
    same_keys(pair, 8)
    dirs_j, dirs_t = j_ins.sh_ray_dirs, t_ins.sh_ray_dirs
    for ins in pair:
        ins.sh_ray_dirs = None
    pt = [0.02, 0.0, 0.04]
    j_ins.generate_probe(jnp.asarray(pt), use_sphere_rays_sample=True)
    t_ins.generate_probe(pt, use_sphere_rays_sample=True)
    assert tuple(t_ins.sh_ray_dirs.shape) == (1, 2048, 3)
    assert_same_key(pair)
    j_ins.sh_ray_dirs, t_ins.sh_ray_dirs = dirs_j, dirs_t
    j_ins._probe_fused = None     # JAX's closes over the directions
    dirs = np.asarray(get_sphere_dirs(2, 64))
    monkeypatch.setattr(j_main, "get_sphere_rays",
                        lambda key, n, m: jnp.asarray(dirs))
    pts = np.array([[0.1, 0.0, 0.0], [0.0, -0.1, 0.1]], np.float32)
    close(t_ins.generate_sh_probes(pts, ray_dirs=dirs),
          j_ins.generate_sh_probes(jnp.asarray(pts)))
    sh_j = j_ins.generate_probe(jnp.asarray(pt), sh_probe=True)
    sh_t = t_ins.generate_probe(pt, sh_probe=True)
    normals, depths = _object_inputs(seed=2)
    kw = dict(model_bbox=[[6, 5], [14, 13]], model_bbox_last=[[5, 5],
                                                              [13, 13]],
              model_radius=0.3, model_pos=np.zeros(3, np.float32),
              model_rot_inv=ROT, gen_shadow=1)
    pose = j_ins.dataset.poses[0]
    j_kw = {k: _j(v) for k, v in kw.items()}
    out_j = j_ins.render_insert_object(
        jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose), sh_j,
        0.6, 0.4, None, False, False, False, **j_kw)
    out_t = t_ins.render_insert_object(normals, depths, pose, sh_t, 0.6, 0.4,
                                       None, False, False, False, **kw)
    close(out_t, out_j)
    kw["model_bbox_last"] = j_kw["model_bbox_last"] = None
    full_j = j_ins.render_insert_object(
        jnp.asarray(normals), jnp.asarray(depths), jnp.asarray(pose), sh_j,
        0.6, 0.4, None, True, False, False, **j_kw)
    full_t = t_ins.render_insert_object(normals, depths, pose, sh_t, 0.6,
                                        0.4, None, True, False, False, **kw)
    for got, want in zip(full_t, full_j):
        close(got, want)
    close(t_ins.last_depth, j_ins.last_depth)
    assert_same_key(pair)


def get_sphere_dirs(n, m):
    rng = np.random.default_rng(9)
    d = rng.normal(size=(n, m, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_multi_cascade_rect_matches_jax_mc_renderer(pair):
    """Departure from the JAX package: on a multi-cascade bake the port's
    rect renders through render_baked_mc_uniform, each sample read from
    its own cascade, where JAX's rect reads cascade 0 over the whole scene
    box. Held against JAX's render_baked_mc_uniform on the same padded
    rays, key and mesh-depth clamp, with the same background blend."""
    j_ins, t_ins = pair
    j_field = _fields(2.0)[0]
    masks = _masks(2.0)
    jb = jrb.bake_field_mc(j_field, 2.0, len(masks), occ_masks=masks,
                           resolution=BAKE_RES, n_dirs=8, chunk=1 << 12)
    assert jb.cascades > 1
    own = t_ins._baked
    t_ins._baked = _to_port(jb)
    try:
        t_ins.key = threefry.prng_key(12)
        ro, rd = _rect_rays(t_ins, j_ins.dataset.poses[0], slice(2, 22),
                            slice(4, 20))
        n = ro.shape[0]
        rng = np.random.default_rng(13)
        im_bkg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        mesh_depth = rng.uniform(0.8, 3.0, n).astype(np.float32)
        mesh_depth[::4] = 0.0
        rgb_t, dep_t = t_ins._render_scene_baked(
            ro, rd, torch.as_tensor(im_bkg), torch.as_tensor(mesh_depth))
    finally:
        t_ins._baked = own
    pad = 1024 - n
    _, k = jax.random.split(jax.random.PRNGKey(12))
    cat = np.concatenate
    res = jrb.render_baked_mc_uniform(
        jb.rows, jb.aabb_lo, jb.aabb_hi,
        jnp.asarray(cat([ro.numpy(), np.full((pad, 3), 1e6, np.float32)])),
        jnp.asarray(cat([rd.numpy(), np.ones((pad, 3), np.float32)])), k,
        B=BAKE_RES, scale=2.0, cascades=jb.cascades, T_threshold=1e-2,
        samples_per_round=16,
        t_far=jnp.asarray(cat([mesh_depth, np.zeros(pad, np.float32)])),
        sigma=jb.sigma, color_window=8, row_index=jb.row_index,
        rows_q=jb.rows_q, mip_dist=jb.mip_dist)
    rgb_j = res["rgb"][:n] + im_bkg * (1.0 - res["opacity"][:n, None])
    close(rgb_t, rgb_j)
    close(dep_t, res["depth"][:n])
    assert float(res["opacity"][:n].max()) > 0.5


def test_hdr_scene_keeps_the_network_path(tmp_path, monkeypatch, capsys):
    """ARNERF_INSERT_BAKED=1 on an HDR scene (--use_exposure: no sigmoid
    colours to bake) leaves the baked field off in both packages, the port
    says so, and its frames take the general path."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARNERF_INSERT_BAKED", "1")
    j_ins, t_ins = build_pair(monkeypatch, use_exposure=True)
    assert not j_ins.use_baked and not t_ins.use_baked
    assert "keeps the network path" in capsys.readouterr().out
    normals, depths = _object_inputs()
    assert t_ins._try_render_insert_fused(
        normals, depths, t_ins.dataset.poses[0], np.zeros((1, 9, 3)), 0.6,
        0.4, None, False, False,
        dict(model_bbox=[[6, 5], [14, 13]], gen_shadow=0)) is None
