"""The port's ops (arnerf_tpu_torch/ops) against their JAX counterparts on
the CPU: the same numpy inputs go through both packages.

The JAX side runs under jit, as in production: XLA then contracts
a*b + c into one fused multiply-add, which the port reproduces.

Tolerances: 1e-6 absolute for the leaf ops (float32, same operations);
the fused head's plain version is held to rtol 1e-5 / atol 1e-6 in float32
and 1e-2 in bf16, as tests/test_fused_head.py holds the Pallas kernel;
the marcher's sample counts and the coarse occupancy must match exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu.ops import stepping as j_step
from arnerf_tpu.ops.composite import composite_test_step as j_composite
from arnerf_tpu.ops.fused_head import fused_field_head as j_head
from arnerf_tpu.ops.hashgrid import (HashGridConfig as JHashCfg,
                                     _encode_fwd_impl as j_encode,
                                     _indices_weights as j_indices,
                                     ngp_growth_factor)
from arnerf_tpu.ops.intersection import ray_aabb_intersect_single as j_aabb
from arnerf_tpu.ops.marching import (build_coarse_occupancy as j_coarse,
                                     march_rays_test as j_march,
                                     occupancy_lookup as j_occ)
from arnerf_tpu.ops.sh import sh_encode as j_sh
from arnerf_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp

from arnerf_tpu_torch.ops import stepping as t_step
from arnerf_tpu_torch.ops import fused_head as t_fused
from arnerf_tpu_torch.ops import marching as t_marching
from arnerf_tpu_torch.ops.composite import composite_test_step
from arnerf_tpu_torch.ops.hashgrid import (HashGridConfig, hashgrid_encode,
                                           _indices_weights)
from arnerf_tpu_torch.ops.intersection import ray_aabb_intersect_single
from arnerf_tpu_torch.ops.marching import (build_coarse_occupancy,
                                           coarse_dilation_radius,
                                           march_rays_test, occupancy_lookup)
from arnerf_tpu_torch.ops.sh import sh_encode
from arnerf_tpu_torch.ops.trunc_exp import trunc_exp
from arnerf_tpu_torch.datasets.synthetic import analytic_occupancy

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t_out, j_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# stepping / intersection / SH / trunc_exp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exp_step_factor", [0.0, 1 / 256])
def test_lattice_and_calc_dt(exp_step_factor):
    rng = np.random.default_rng(0)
    t1 = rng.uniform(0.01, 3.0, (64,)).astype(np.float32)
    k = np.arange(300, dtype=np.int32)
    kw = dict(exp_step_factor=exp_step_factor, max_samples=1024,
              grid_size=128, scale=2.0)
    j = jax.jit(lambda a, b: j_step.lattice_t(a, b, **kw))(
        jnp.asarray(t1)[:, None], jnp.asarray(k)[None])
    t = t_step.lattice_t(_t(t1)[:, None], _t(k)[None], **kw)
    _close(t, j, atol=ATOL, rtol=1e-6)
    _close(t_step.calc_dt(t, **kw), j_step.calc_dt(j, **kw))
    assert t_step.num_lattice_steps(0.01, 3.0, **kw) == \
        j_step.num_lattice_steps(0.01, 3.0, **kw)


def test_mip_levels():
    rng = np.random.default_rng(1)
    # magnitudes spread over the cascades, plus exact powers of two
    xyz = (rng.normal(size=(512, 3)) * rng.uniform(0.05, 6, (512, 1)))
    xyz[:8] = [[0.5, 0, 0], [1, 0, 0], [2, 0, 0], [4, 0, 0],
               [0.25, -0.5, 0], [0, 0, 0], [-1, 1, 0], [3.99, 0, 0]]
    xyz = xyz.astype(np.float32)
    dt = rng.uniform(1e-4, 0.2, (512,)).astype(np.float32)
    dt[:4] = [1 / 128, 2 / 128, 4 / 128, 0.0]
    for cascades in (1, 3, 5):
        np.testing.assert_array_equal(
            t_step.mip_from_pos(_t(xyz), cascades).numpy(),
            np.asarray(j_step.mip_from_pos(jnp.asarray(xyz), cascades)))
        np.testing.assert_array_equal(
            t_step.mip_from_dt(_t(dt), 128, cascades).numpy(),
            np.asarray(j_step.mip_from_dt(jnp.asarray(dt), 128, cascades)))


def test_ray_aabb_intersect_single():
    rng = np.random.default_rng(2)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [1, 1e-3, 0]]
    o[:4] = [[-1, 0, 0], [0.2, -3, 0.1], [0, 0, 0], [-1, 0.49, 0]]
    j = j_aabb(jnp.asarray(o), jnp.asarray(d), jnp.zeros(3), jnp.full(3, 0.5))
    t = ray_aabb_intersect_single(_t(o), _t(d), torch.zeros(3),
                                  torch.full((3,), 0.5))
    _close(t, j)
    assert (t[:, 0] < 0).any() and (t[:, 0] >= 0).any()


def _many_shapes(kind):
    """256 rays against 12 boxes or spheres: the first 4 overlap the
    origin, where the first 48 rays start (inside several at once: t1 = 0
    ties), 48 more start outside everything and point away (misses)."""
    rng = np.random.default_rng(5)
    c = rng.uniform(-1.5, 1.5, (12, 3)).astype(np.float32)
    c[:4] = rng.uniform(-0.1, 0.1, (4, 3))
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    o[:48] = rng.uniform(-0.05, 0.05, (48, 3))
    o[48:96] = 4.0 * np.sign(rng.normal(size=(48, 3)))
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[48:96] = np.abs(d[48:96]) * np.sign(o[48:96])
    if kind == "aabb":
        size = rng.uniform(0.2, 0.6, (12, 3)).astype(np.float32)
    else:
        size = rng.uniform(0.2, 0.6, 12).astype(np.float32)
    return o, d, c, size


@pytest.mark.parametrize("max_hits", [1, 3, 16])
@pytest.mark.parametrize("kind", ["aabb", "sphere"])
def test_ray_aabb_and_sphere_intersect(kind, max_hits):
    """ray_aabb_intersect / ray_sphere_intersect (N x V, the first
    max_hits by t1, -1 padded): counts and indices exact (the stable sort
    keeps index order among the t1 = 0 ties of rays starting inside several
    shapes), t to 1e-6; max_hits below and above the hit counts."""
    from arnerf_tpu.ops import intersection as J
    from arnerf_tpu_torch.ops import intersection as T
    name = f"ray_{'aabb' if kind == 'aabb' else 'sphere'}_intersect"
    o, d, c, size = _many_shapes(kind)
    j = getattr(J, name)(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                         jnp.asarray(size), max_hits)
    t = getattr(T, name)(_t(o), _t(d), _t(c), _t(size), max_hits)
    cnt, hits_t, idx = (np.asarray(x) for x in j)
    assert t[0].dtype == t[2].dtype == torch.int32
    np.testing.assert_array_equal(t[0].numpy(), cnt)
    np.testing.assert_array_equal(t[2].numpy(), idx)
    _close(t[1], hits_t)
    assert (cnt[96:] == 0).any() and (cnt[48:96] == 0).all()
    assert (cnt > max_hits).any() == (max_hits < 16)
    assert ((hits_t[:48, :, 0] == 0).sum(axis=1) > 1).any() \
        == (max_hits > 1)


def test_sh_encode():
    rng = np.random.default_rng(3)
    d = rng.normal(size=(333, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(sh_encode(_t(d)), j_sh(jnp.asarray(d)))


def test_trunc_exp_forward_and_clamped_backward():
    x = np.linspace(-20, 20, 101).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    y = trunc_exp(xt)
    y.sum().backward()
    _close(y.detach(), j_trunc_exp(jnp.asarray(x)), rtol=1e-6)
    g_j = jax.grad(lambda v: jnp.sum(j_trunc_exp(v)))(jnp.asarray(x))
    _close(xt.grad, g_j, rtol=1e-6)
    assert float(xt.grad[-1]) == pytest.approx(float(np.exp(np.float32(15))),
                                               rel=1e-6)


# ---------------------------------------------------------------------------
# hash grid
# ---------------------------------------------------------------------------

def _hash_cfgs(n_levels, log2_t, base, scale=0.5):
    kw = dict(n_levels=n_levels, n_features=2, log2_hashmap_size=log2_t,
              base_resolution=base,
              per_level_scale=ngp_growth_factor(scale, n_levels, base))
    return HashGridConfig(**kw), JHashCfg(**kw)


def test_hashgrid_config_full_width_matches():
    t_cfg, j_cfg = _hash_cfgs(16, 19, 16)
    assert t_cfg.offsets == j_cfg.offsets
    assert t_cfg.level_sizes == j_cfg.level_sizes
    assert t_cfg.total_entries == j_cfg.total_entries == 5_710_022
    assert t_cfg.hashed == j_cfg.hashed
    assert [l for l, h in enumerate(t_cfg.hashed) if h] == list(range(6, 16))


def _encode_points(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    # points on level-cell boundaries (x*s + 0.5 integral) ...
    for l, s in enumerate(cfg.scales[:6]):
        x[l, :] = np.float32((np.floor(0.3 * s) + 0.5) / s)
    # ... and outside [0, 1] (clamped)
    x[8:16] = rng.uniform(-0.5, 1.5, (8, 3)).astype(np.float32)
    x[16] = [0.0, 1.0, 0.0]
    x[17] = [1.0, 1.0, 1.0]
    return x


def test_hashgrid_indices_full_width_match():
    """Exact table rows, with the uint32 wrap of the spatial hash."""
    t_cfg, j_cfg = _hash_cfgs(16, 19, 16)
    x = _encode_points(t_cfg, 512, 4)
    j_flat, j_cw, j_inside = jax.jit(lambda v: j_indices(v, j_cfg))(
        jnp.asarray(x))
    t_flat, t_cw, t_inside = _indices_weights(_t(x), t_cfg)
    np.testing.assert_array_equal(t_flat.numpy(), np.asarray(j_flat))
    np.testing.assert_array_equal(t_inside.numpy(), np.asarray(j_inside))
    for a, b in zip(t_cw, j_cw):
        _close(a, b)


# (levels, log2 T, N_min, scale): a small grid, and the full width at the
# synthetic (0.5) and the unbounded (16) configurations' growth factors
@pytest.mark.parametrize("levels", [(4, 12, 4, 0.5), (16, 19, 16, 0.5),
                                    (16, 19, 16, 16.0)])
def test_hashgrid_encode_matches(levels):
    t_cfg, j_cfg = _hash_cfgs(*levels)
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (t_cfg.total_entries, 2)).astype(np.float32)
    x = _encode_points(t_cfg, 1024, 6)
    j = jax.jit(lambda a, b: j_encode(a, b, j_cfg))(jnp.asarray(table),
                                                    jnp.asarray(x))
    t = hashgrid_encode(_t(table), _t(x), t_cfg)
    assert t.shape == (1024, t_cfg.out_dim)
    _close(t, j)


def test_hashgrid_cpu_encode_takes_plain_version_uncounted():
    from arnerf_tpu_torch.ops import hashgrid as t_hg
    t_cfg, _ = _hash_cfgs(4, 12, 4)
    table = torch.rand((t_cfg.total_entries, 2),
                       generator=torch.Generator().manual_seed(0))
    x = _t(_encode_points(t_cfg, 64, 7))
    t_hg.reset_launches()
    out = hashgrid_encode(table, x, t_cfg)
    assert torch.equal(out, t_hg._encode_fwd_impl(table, x, t_cfg))
    assert t_hg.launches == 0


@pytest.mark.parametrize("scale", [0.5, 16.0])
def test_hashgrid_kernel_levels(scale):
    """The kernel's level constants: each scale the float32 value the plain
    version computes with, resolutions, offsets, hashed bits, T - 1."""
    from arnerf_tpu_torch.ops import hashgrid as t_hg
    t_cfg, _ = _hash_cfgs(16, 19, 16, scale)
    lv = t_hg._kernel_levels(t_cfg)
    scales, res, hashed, offsets = t_hg._level_tensors(t_cfg, "cpu")
    L = t_cfg.n_levels
    assert lv.n_levels == L and lv.table_mask == (1 << 19) - 1
    np.testing.assert_array_equal(np.array(lv.scale[:L], np.float32),
                                  scales.numpy())
    assert list(lv.res[:L]) == res.tolist()
    assert list(lv.offset[:L]) == offsets.tolist()
    assert [bool(lv.hashed >> l & 1) for l in range(L)] == hashed.tolist()
    assert lv.hashed >> L == 0
    assert t_hg._kernel_levels(t_cfg) is lv      # built once a config


def test_hashgrid_encode_refuses_other_devices():
    t_cfg, _ = _hash_cfgs(4, 12, 4)
    table = torch.zeros((t_cfg.total_entries, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hashgrid_encode(table, torch.zeros((8, 3), device="meta"), t_cfg)


# ---------------------------------------------------------------------------
# fused field head: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _head_weights(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, s).astype(np.float32) * np.sqrt(6.0 / s[0])
            for s in t_fused.HEAD_SHAPES]


def _head_inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32)).astype(np.float32) * 0.5,
            rng.normal(size=(n, 16)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("n", [8, 2048, 2051])
def test_fused_head_plain_matches_pallas_f32(n):
    w = _head_weights()
    feats, sh = _head_inputs(n)
    h_j, rgb_j = j_head(jnp.asarray(feats), jnp.asarray(sh),
                        tuple(jnp.asarray(a) for a in w), jnp.float32, True)
    h_t, rgb_t = t_fused.fused_field_head(_t(feats), _t(sh),
                                          tuple(_t(a) for a in w),
                                          torch.float32)
    _close(h_t, h_j, rtol=1e-5)
    _close(rgb_t, rgb_j, rtol=1e-5)


def test_fused_head_plain_matches_pallas_bf16():
    w = _head_weights(2)
    feats, sh = _head_inputs(64, 3)
    h_j, rgb_j = j_head(jnp.asarray(feats), jnp.asarray(sh),
                        tuple(jnp.asarray(a) for a in w), jnp.bfloat16, True)
    h_t, rgb_t = t_fused.fused_field_head(_t(feats), _t(sh),
                                          tuple(_t(a) for a in w),
                                          torch.bfloat16)
    assert h_t.dtype == rgb_t.dtype == torch.float32
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j, np.float32),
                               rtol=1e-2, atol=1e-2)


def test_fused_head_cpu_takes_plain_version_uncounted():
    w = tuple(_t(a) for a in _head_weights())
    feats, sh = (_t(a) for a in _head_inputs(16))
    t_fused.reset_launches()
    h, rgb = t_fused.fused_field_head(feats, sh, w, torch.float32)
    h_p, rgb_p = t_fused._head_torch(feats, sh, w, torch.float32)
    assert torch.equal(h, h_p) and torch.equal(rgb, rgb_p)
    assert t_fused.launches == 0


def test_fused_head_refuses_other_devices():
    w = tuple(_t(a).to("meta") for a in _head_weights())
    feats, sh = (_t(a).to("meta") for a in _head_inputs(16))
    with pytest.raises(ValueError, match="unsupported device"):
        t_fused.fused_field_head(feats, sh, w, torch.float32)


# ---------------------------------------------------------------------------
# occupancy, marching, compositing
# ---------------------------------------------------------------------------

def _occupancy(scale, G):
    cascades = max(1 + int(np.ceil(np.log2(2 * scale))), 1)
    return analytic_occupancy(scale, G, cascades).numpy(), cascades


@pytest.mark.parametrize("dilate", [1, 2, 3])
def test_build_coarse_occupancy_exact(dilate):
    rng = np.random.default_rng(7)
    occ = (rng.uniform(size=32 ** 3) > 0.995).astype(np.uint8)
    j = j_coarse(jnp.asarray(occ), 1, 32, dilate=dilate)
    t = build_coarse_occupancy(_t(occ), 1, 32, dilate=dilate)
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_occupancy_lookup_multi_cascade_exact():
    occ, cascades = _occupancy(2.0, 32)
    rng = np.random.default_rng(8)
    pos = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.3, (4096,)).astype(np.float32)
    kw = dict(scale=2.0, cascades=cascades, grid_size=32)
    j = j_occ(jnp.asarray(occ), jnp.asarray(pos), jnp.asarray(dt), **kw)
    t = occupancy_lookup(_t(occ), _t(pos), _t(dt), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.any() and not t.all()


def _rays(n, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 1.3 * scale)
    tgt = rng.uniform(-0.6 * scale, 0.6 * scale, (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("mode", ["single", "coarse", "coarse_truncated",
                                  "multi_cascade"])
def test_march_rays_test_matches(mode):
    scale = 2.0 if mode == "multi_cascade" else 0.5
    G = 32
    occ, cascades = _occupancy(scale, G)
    o, d = _rays(256, 9, scale)
    hits = np.asarray(j_aabb(jnp.asarray(o), jnp.asarray(d), jnp.zeros(3),
                             jnp.full(3, scale)))
    t2 = hits[:, 1]
    t_cur = np.where(hits[:, 0] >= 0, hits[:, 0] + 0.01, t2 + 1.0)
    t_cur = t_cur.astype(np.float32)
    kw = dict(scale=scale, cascades=cascades,
              exp_step_factor=1 / 256 if cascades > 1 else 0.0,
              grid_size=G, max_samples=96, n_candidates=128, n_samples=16,
              dt_scale=float(cascades))
    j_coarse_occ = t_coarse_occ = None
    if mode.startswith("coarse"):
        r = coarse_dilation_radius(scale=scale, exp_step_factor=0.0,
                                   grid_size=G, max_samples=96,
                                   dt_scale=float(cascades))
        j_coarse_occ = j_coarse(jnp.asarray(occ), cascades, G, dilate=r)
        t_coarse_occ = build_coarse_occupancy(_t(occ), cascades, G, dilate=r)
    if mode == "coarse_truncated":
        kw["seg_cap"] = 2
    j = j_march(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_cur),
                jnp.asarray(t2), jnp.asarray(occ), occ_coarse=j_coarse_occ,
                **kw)
    t_marching.reset_launches()
    t = march_rays_test(_t(o), _t(d), _t(t_cur), _t(t2), _t(occ),
                        occ_coarse=t_coarse_occ, **kw)
    assert t_marching.launches == 0      # CPU tensors: the plain version
    xyzs, deltas, ts, n_eff, t_next = t
    np.testing.assert_array_equal(n_eff.numpy(), np.asarray(j[3]))
    assert int(n_eff.sum()) > 0
    for a, b in ((ts, j[2]), (deltas, j[1]), (t_next, j[4]), (xyzs, j[0])):
        _close(a, b, rtol=1e-6)
    if mode == "coarse_truncated":
        assert (n_eff < 16).any()


def _march_inputs():
    """Port-side inputs of a two-level march_rays_test call on the CPU."""
    occ, cascades = _occupancy(0.5, 32)
    o, d = _rays(128, 11)
    hits = ray_aabb_intersect_single(_t(o), _t(d), torch.zeros(3),
                                     torch.full((3,), 0.5))
    t2 = hits[:, 1]
    t_cur = torch.where(hits[:, 0] >= 0, hits[:, 0] + 0.01, t2 + 1.0)
    coarse = build_coarse_occupancy(_t(occ), cascades, 32, dilate=2)
    kw = dict(scale=0.5, cascades=cascades, exp_step_factor=0.0,
              grid_size=32, max_samples=96, n_candidates=128, n_samples=16,
              dt_scale=1.0, occ_coarse=coarse)
    return (_t(o), _t(d), t_cur, t2, _t(occ)), kw


def test_march_rays_test_refuses_other_devices():
    args, kw = _march_inputs()
    kw["occ_coarse"] = kw["occ_coarse"].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        march_rays_test(*(a.to("meta") for a in args), **kw)


# (scale, exp_step_factor, grid_size, max_samples, step_scale): the view,
# eval, mip-NeRF 360's six cascades (dt_scale = cascades), and a dt_min
# above dt_max, where the lattice steps by dt_max
_KERNEL_STEPS = [(0.5, 0.0, 128, 96, 1.0), (0.5, 0.0, 128, 1024, 1.0),
                 (16.0, 1 / 256, 128, 1024, 6.0), (0.5, 0.0, 128, 8, 0.25),
                 (0.25, 1 / 256, 64, 1024, 3.0)]


@pytest.mark.parametrize("steps", _KERNEL_STEPS)
def test_march_kernel_constants(steps):
    """The float32 constants csrc/marching.cu takes are the plain
    version's: the lattice's step and calc_dt's clamp read back from
    stepping.lattice_t and stepping.calc_dt, and every one the float32
    rounding of stepping's Python number (for a number that divides a
    tensor on the card, the float32 reciprocal of that rounding)."""
    scale, f, G, ms, step_scale = steps
    c = t_marching.kernel_constants(scale=scale, exp_step_factor=f,
                                  grid_size=G, max_samples=ms,
                                  step_scale=step_scale)
    f32 = np.float32
    dt_min = t_step.SQRT3 / ms
    dt_max = t_step.SQRT3 * 2 * step_scale / G
    dt_lat = min(dt_min, dt_max)
    kw = dict(exp_step_factor=f, max_samples=ms, grid_size=G,
              scale=step_scale)
    zero = torch.zeros(1)
    assert c["lat_dt_min"] == f32(dt_lat) \
        == float(t_step.lattice_t(zero, torch.ones(1), **kw))
    assert min(c["dt_min"], c["dt_max"]) == float(t_step.calc_dt(zero, **kw))
    if f > 0:
        assert c["dt_max"] == float(t_step.calc_dt(torch.full((1,), 1e30),
                                                   **kw))
    assert c["dt_min"] == f32(dt_min) and c["dt_max"] == f32(dt_max)
    assert c["lat_dt_max"] == f32(dt_max) and c["step_factor"] == f32(f)
    assert c["scale"] == f32(scale)
    assert c["inv_coarse_bound"] == f32(1) / f32(min(0.5, scale))
    if f > 0:
        assert c["lat_a"] == f32(dt_lat / f)
        assert c["lat_b"] == f32(dt_max / f)
        assert c["lat_inv_dt_min"] == f32(1) / f32(dt_lat)
        assert c["lat_log1pf"] == f32(np.log1p(f))
        assert c["lat_inv_log1pf"] == f32(1) / f32(np.log1p(f))
    else:
        assert c["lat_a"] == c["lat_b"] == c["lat_log1pf"] == 0.0


def _bad_march_inputs(case):
    """One argument of a good two-level call (test_march_kernel_input_checks)
    spoilt as `case` says."""
    (o, d, t_cur, t2, occ), kw = _march_inputs()
    args = dict(rays_o=o, rays_d=d, t_cur=t_cur, t2=t2, occ_flat=occ,
                occ_coarse=kw["occ_coarse"])
    checks = dict(cascades=kw["cascades"], grid_size=kw["grid_size"],
                  n_candidates=512, n_samples=32, seg_cap=32)
    spoil = {
        "good": lambda: None,
        "rays_o": lambda: args.update(rays_o=o[:, :2]),
        "rays_d": lambda: args.update(rays_d=d.double()),
        "t_cur": lambda: args.update(t_cur=t_cur[:, None]),
        "t2": lambda: args.update(t2=t2[:-1]),
        "occ_flat": lambda: args.update(occ_flat=occ.float()),
        "occ_coarse": lambda: args.update(occ_coarse=occ[:8]),
        "1 to 2": lambda: checks.update(n_samples=0),
    }
    spoil[case]()
    return args, checks


@pytest.mark.parametrize("case", ["good", "rays_o", "rays_d", "t_cur", "t2",
                                  "occ_flat", "occ_coarse", "1 to 2"])
def test_march_kernel_input_checks(case):
    """The kernel wrapper's checks, on CPU tensors: each spoilt argument
    raises, naming it; the good call and bool grids pass, and the coarse
    grid is not read on more than one cascade."""
    args, checks = _bad_march_inputs(case)
    if case == "good":
        t_marching.check_kernel_inputs(*args.values(), **checks)
        args["occ_flat"] = args["occ_flat"].bool()
        t_marching.check_kernel_inputs(*args.values(), **checks)
        args["occ_coarse"] = args["occ_coarse"][:8]
        t_marching.check_kernel_inputs(
            *args.values(), **{**checks, "cascades": 2,
                               "grid_size": checks["grid_size"] // 2})
        return
    with pytest.raises(ValueError, match=case):
        t_marching.check_kernel_inputs(*args.values(), **checks)


def test_composite_test_step_matches():
    rng = np.random.default_rng(10)
    N, S = 128, 24
    sig = rng.uniform(0, 60, (N, S)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (N, S, 3)).astype(np.float32)
    deltas = rng.uniform(0.001, 0.02, (N, S)).astype(np.float32)
    ts = np.cumsum(deltas, axis=1).astype(np.float32)
    n_eff = rng.integers(0, S + 1, (N,)).astype(np.int32)
    opacity = rng.uniform(0, 0.9, (N,)).astype(np.float32)
    depth = rng.uniform(0, 1, (N,)).astype(np.float32)
    rgb = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    args = (sig, rgbs, deltas, ts, n_eff, opacity, depth, rgb)
    j = j_composite(*(jnp.asarray(a) for a in args), 1e-2)
    t = composite_test_step(*(_t(a) for a in args), 1e-2)
    for a, b in zip(t[:3], j[:3]):
        _close(a, b)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))
    assert not t[3].all() and t[3].any()
