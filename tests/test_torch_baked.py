"""The port's baked renderer (arnerf_tpu_torch/rendering_baked.py) against
the JAX package's on the CPU.

Bake: the analytic oracle (the same JAX field called by both bakes) and a
tiny JAX-initialised NGP at B = 32, single- and multi-cascade, exact and
stochastic corners. Floats (rows, sigma, the colour scales) to 1e-5 of the
largest entry; codes (mip, distance field, sigma bricks, int8 colours, row
index) and the bounds exactly.

Render: one JAX bake of the oracle, copied into the port's BakedField, is
rendered by both packages from the same threefry key at 32x32: bricks,
uniform split, trilinear, the t_far clamp, display mode and the
multi-cascade path (its distance prelude), with and without 2x2 blocks; and the
per-bucket renderers directly at sizes where the rays are compacted
between phases. RGB, opacity and depth to 1e-4, the rounds of every
bucket and the prelude's alive counts exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu import rendering_baked as jrb
from arnerf_tpu.datasets.synthetic import analytic_rgb, analytic_sigma
from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_init as j_init)
from arnerf_tpu.ops import morton as j_morton
from arnerf_tpu.ops import rng as j_rng
from arnerf_tpu.training.ckpt import _flatten, save_ckpt as j_save

from arnerf_tpu_torch import rendering_baked as trb
from arnerf_tpu_torch.datasets.ray_utils import get_rays
from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.ops import morton, rng, threefry
from arnerf_tpu_torch.training.ckpt import params_from_jax

torch.set_num_threads(2)

B = 32
G = 32
TOL = 1e-4
SMALL = dict(grid_size=G, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)


def _fields(scale):
    """The analytic oracle as the JAX bake calls it, and the same JAX
    function behind the port's torch interface."""
    def j_field(x, d):
        return analytic_sigma(x, scale), analytic_rgb(x, scale)

    def t_field(x, d):
        xj = jnp.asarray(x.numpy())
        return (torch.from_numpy(np.array(analytic_sigma(xj, scale))),
                torch.from_numpy(np.array(analytic_rgb(xj, scale))))
    return j_field, t_field


def _masks(scale):
    C = JConfig(scale=scale).cascades
    occ = analytic_occupancy(scale, G, C).numpy().reshape(C, G, G, G)
    return [jrb._resample_dilate(occ[c] > 0, B, G) for c in range(C)]


def _rel(t, j, tol=1e-5):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=tol * max(float(np.abs(j).max()), 1e-30))


def _assert_same_bake(tb, jb):
    _rel(tb.rows, jb.rows)
    _rel(tb.sigma, jb.sigma)
    for k in ("aabb_lo", "aabb_hi", "mip", "mip_dist", "sigma_bricks",
              "row_index"):
        jv = getattr(jb, k)
        if jv is None:
            assert getattr(tb, k) is None, k
            continue
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(jv), err_msg=k)
    jq, tq = np.asarray(jb.rows_q), tb.rows_q.numpy()
    np.testing.assert_array_equal(tq[:, :28], jq[:, :28])
    _rel(torch.from_numpy(tq[:, 28:].copy().view(np.float32)),
         jq[:, 28:].copy().view(np.float32))


def _to_port(jb):
    """A JAX BakedField as the port's."""
    kw = {k: None if getattr(jb, k) is None
          else torch.from_numpy(np.array(getattr(jb, k)))
          for k in ("rows", "aabb_lo", "aabb_hi", "mip", "sigma", "row_index",
                    "rows_q", "sigma_bricks", "mip_dist")}
    return trb.BakedField(resolution=jb.resolution, scale=jb.scale,
                          cascades=jb.cascades, **kw)


@pytest.fixture(scope="module")
def oracle_bakes():
    """scale -> (JAX bake, port bake) of the oracle."""
    out = {}
    for scale in (0.5, 2.0):
        j_field, t_field = _fields(scale)
        masks = _masks(scale)
        kw = dict(resolution=B, n_dirs=8, chunk=1 << 12)
        if len(masks) == 1:
            jb = jrb.bake_field(j_field, scale, occ_mask=masks[0], **kw)
            tb = trb.bake_field(t_field, scale, occ_mask=masks[0], **kw)
        else:
            jb = jrb.bake_field_mc(j_field, scale, len(masks),
                                   occ_masks=masks, **kw)
            tb = trb.bake_field_mc(t_field, scale, len(masks),
                                   occ_masks=masks, **kw)
        out[scale] = (jb, tb)
    return out


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_bake_field_of_the_oracle_matches_jax(oracle_bakes, scale):
    """bake_field (one cascade) and bake_field_mc (3 cascades)."""
    jb, tb = oracle_bakes[scale]
    assert tb.cascades == jb.cascades == (1 if scale == 0.5 else 3)
    assert int((tb.rows_q[:, :27] != 0).sum()) > 0
    assert float(tb.sigma.max()) > 10.0
    _assert_same_bake(tb, jb)


@pytest.mark.parametrize("scale,stoch,fused_head", [
    (0.5, False, True), (0.5, True, False), (2.0, False, False),
    (2.0, True, False)])
def test_bake_ngp_matches_jax(scale, stoch, fused_head):
    """A tiny NGP baked with exact and stochastic corners, the field's
    fused head on and off (Pallas interpret mode on the JAX side)."""
    kw = dict(scale=scale, fused_head=fused_head, **SMALL)
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    j_params = j_init(jax.random.PRNGKey(2), j_cfg)
    t_params = params_from_jax(_flatten(j_params, "params/"))
    occ = analytic_occupancy(scale, G, j_cfg.cascades).numpy()
    j_state = j_grid_init(j_cfg)._replace(occ_flat=jnp.asarray(occ))
    t_state = grid_state_init(t_cfg)._replace(occ_flat=torch.from_numpy(occ))
    jb = jrb.bake_ngp(j_params, j_state, j_cfg, resolution=B, n_dirs=8,
                      stoch=stoch)
    tb = trb.bake_ngp(t_params, t_state, t_cfg, resolution=B, n_dirs=8,
                      stoch=stoch)
    _assert_same_bake(tb, jb)


def test_bake_ngp_stoch_auto_is_exact_on_the_cpu():
    kw = dict(scale=0.5, **SMALL)
    j_cfg, t_cfg = JConfig(**kw), NGPConfig(**kw)
    j_params = j_init(jax.random.PRNGKey(4), j_cfg)
    t_params = params_from_jax(_flatten(j_params, "params/"))
    occ = analytic_occupancy(0.5, G, 1).numpy()
    t_state = grid_state_init(t_cfg)._replace(occ_flat=torch.from_numpy(occ))
    auto = trb.bake_ngp(t_params, t_state, t_cfg, resolution=16, n_dirs=4)
    exact = trb.bake_ngp(t_params, t_state, t_cfg, resolution=16, n_dirs=4,
                         stoch=False)
    np.testing.assert_array_equal(auto.rows.numpy(), exact.rows.numpy())


def _view(scale, img=32):
    ds = SyntheticDataset(split="test", read_meta=False,
                          config=SyntheticConfig(scale=scale,
                                                 img_wh=(img, img)))
    ro, rd = get_rays(torch.as_tensor(ds.directions),
                      torch.as_tensor(ds.poses[1]))
    return ro.contiguous(), rd.contiguous()


def _assert_same_render(to, jo, keys=("rgb", "opacity", "depth")):
    for k in keys:
        np.testing.assert_allclose(to[k].numpy().astype(np.float32),
                                   np.asarray(jo[k]).astype(np.float32),
                                   atol=TOL, rtol=0, err_msg=k)


_MESH_DEPTH = np.where(np.arange(32 * 32) % 3 == 0, 1.1, 0.0) \
    .astype(np.float32)

RENDER_CASES = {
    "bricks": dict(),
    "bricks_block4": dict(img_wh=(32, 32)),
    "bricks_t_far": dict(mesh_depth_map=_MESH_DEPTH, img_wh=(32, 32)),
    "uniform_split": dict(bricks=False),
    "uniform_split_block4": dict(bricks=False, img_wh=(32, 32)),
    "uniform_t_far": dict(bricks=False, mesh_depth_map=_MESH_DEPTH),
    "uniform_no_window": dict(color_window=0),
    "trilinear": dict(interp="trilinear"),
    "trilinear_block4": dict(interp="trilinear", img_wh=(32, 32)),
    "display": dict(display=True, img_wh=(32, 32)),
    "mc": dict(scale=2.0),
    "mc_block4_t_far": dict(scale=2.0, img_wh=(32, 32),
                            mesh_depth_map=_MESH_DEPTH * 4),
    "mc_no_window": dict(scale=2.0, color_window=0),
    "mc_display": dict(scale=2.0, display=True, img_wh=(32, 32)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_baked_matches_jax(oracle_bakes, case):
    kw = dict(RENDER_CASES[case])
    scale = kw.pop("scale", 0.5)
    jb, _ = oracle_bakes[scale]
    tb = _to_port(jb)
    ro, rd = _view(scale)
    j_stats, t_stats = {}, {}
    jo = jrb.render_baked(jb, None, jnp.asarray(ro.numpy()),
                          jnp.asarray(rd.numpy()), None,
                          key=jax.random.PRNGKey(3), stats=j_stats, **kw)
    to = trb.render_baked(tb, None, ro, rd, None,
                          key=threefry.prng_key(3), stats=t_stats, **kw)
    _assert_same_render(to, jo, ("rgb_u8", "opacity", "depth")
                        if kw.get("display") else ("rgb", "opacity",
                                                   "depth"))
    assert t_stats["rounds"] == j_stats["rounds"]
    assert t_stats["n_prelude_alive"] == j_stats["n_prelude_alive"]
    assert t_stats["n_aabb_hit"] == j_stats["n_aabb_hit"]
    assert max(t_stats["rounds"]) > 1
    assert float(to["opacity"].max()) > 0.9


def _many_rays(scale, n=8192, seed=0):
    """n rays near the 32x32 view's, so the renderers compact between
    phases at small phase floors."""
    ro, rd = _view(scale)
    rng_np = np.random.default_rng(seed)
    k = n // ro.shape[0]
    ro = ro.repeat_interleave(k, 0) + torch.from_numpy(
        rng_np.normal(0, 0.01, (n, 3)).astype(np.float32))
    return ro, rd.repeat_interleave(k, 0)


@pytest.mark.parametrize("renderer", ["uniform", "uniform_trilinear",
                                      "bricks", "mc"])
def test_compacted_phases_match_jax(oracle_bakes, renderer):
    """The alive-first compactions and the jitter counters of later phases
    (phase_floor 256 for 8192 rays: five phases)."""
    scale = 2.0 if renderer == "mc" else 0.5
    jb, _ = oracle_bakes[scale]
    tb = _to_port(jb)
    ro, rd = _many_rays(scale)
    jro, jrd = jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy())
    common = dict(B=B, scale=scale)
    if renderer == "mc":
        kw = dict(cascades=3, color_window=8)
        jo = jrb.render_baked_mc_uniform(
            jb.rows, jb.aabb_lo, jb.aabb_hi, jro, jrd, jax.random.PRNGKey(1),
            sigma=jb.sigma, row_index=jb.row_index, rows_q=jb.rows_q,
            mip_dist=jb.mip_dist, **common, **kw)
        to = trb.render_baked_mc_uniform(
            tb.rows, tb.aabb_lo, tb.aabb_hi, ro, rd, threefry.prng_key(1),
            sigma=tb.sigma, row_index=tb.row_index, rows_q=tb.rows_q,
            mip_dist=tb.mip_dist, **common, **kw)
    elif renderer == "bricks":
        dt, K = jrb.brick_render_args(jb)
        assert (dt, K) == trb.brick_render_args(tb)
        kw = dict(dt=dt, K=K, phase_floor=256)
        jo = jrb.render_baked_bricks(
            jb.sigma_bricks, jb.rows, jb.row_index, jb.rows_q, jb.mip,
            jb.aabb_lo, jb.aabb_hi, jro, jrd, jax.random.PRNGKey(1),
            **common, **kw)
        to = trb.render_baked_bricks(
            tb.sigma_bricks, tb.rows, tb.row_index, tb.rows_q, tb.mip,
            tb.aabb_lo, tb.aabb_hi, ro, rd, threefry.prng_key(1),
            **common, **kw)
    else:
        kw = dict(phase_floor=256, samples_per_round=16,
                  interp="trilinear" if renderer == "uniform_trilinear"
                  else "stochastic")
        jo = jrb.render_baked_uniform(
            jb.rows, jb.aabb_lo, jb.aabb_hi, jro, jrd, jax.random.PRNGKey(1),
            mip=jb.mip, sigma=jb.sigma, row_index=jb.row_index,
            rows_q=jb.rows_q, **common, **kw)
        to = trb.render_baked_uniform(
            tb.rows, tb.aabb_lo, tb.aabb_hi, ro, rd, threefry.prng_key(1),
            mip=tb.mip, sigma=tb.sigma, row_index=tb.row_index,
            rows_q=tb.rows_q, **common, **kw)
    _assert_same_render(to, jo)
    assert to["rounds"] == int(jo["rounds"])
    assert to["n_prelude_alive"] == int(jo["n_prelude_alive"])
    if "phase_sizes" in to:
        assert len(to["phase_sizes"]) > 2
        assert to["phase_sizes"] == [int(v) for v in jo["phase_sizes"]]
        assert to["phase_rounds"] == [int(v) for v in jo["phase_rounds"]]
        assert to["phase_alive"] == [int(v) for v in jo["phase_alive"]]


def test_sigma_codes_and_tables_match_jax():
    rng_np = np.random.default_rng(0)
    sig = np.concatenate([[0.0, -1.0, 1e-4, 1e4], rng_np.uniform(
        0, 2000, 4092)]).astype(np.float32)
    np.testing.assert_array_equal(
        trb.sigma_encode(torch.from_numpy(sig)).numpy(),
        np.asarray(jrb.sigma_encode(jnp.asarray(sig))))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_allclose(
        trb.sigma_decode(torch.from_numpy(codes)).numpy(),
        np.asarray(jrb.sigma_decode(jnp.asarray(codes))), rtol=1e-6)
    s = np.where(rng_np.random(20 ** 3) < 0.02, 1.0, 0.0).astype(np.float32)
    mip = trb.build_sigma_mip(torch.from_numpy(s), 20)
    np.testing.assert_array_equal(mip.numpy(),
                                  np.asarray(jrb.build_sigma_mip(s, 20)))
    np.testing.assert_array_equal(
        trb.build_mip_dist(mip, 3).numpy(),
        np.asarray(jrb.build_mip_dist(np.asarray(mip.numpy()), 3)))
    np.testing.assert_array_equal(
        trb.build_sigma_bricks(torch.from_numpy(s), 20).numpy(),
        np.asarray(jrb.build_sigma_bricks(s, 20)))
    np.testing.assert_array_equal(trb.fibonacci_sphere(7),
                                  jrb.fibonacci_sphere(7))
    assert trb.cascade_half_extents(4, 3.0) == \
        jrb.cascade_half_extents(4, 3.0)
    for g, b in ((32, 48), (32, 16), (16, 32)):
        occ = rng_np.random((g, g, g)) < 0.05
        np.testing.assert_array_equal(trb._resample_dilate(occ, b, g),
                                      jrb._resample_dilate(occ, b, g))


def test_hash_uniform3_and_morton_bit_exact():
    idx = np.arange(0, 1 << 20, 37, dtype=np.uint32)
    for seed in (0, 7, 0xFFFFFFFF):
        t = rng.hash_uniform3(torch.from_numpy(idx.astype(np.int64)), seed,
                              stream=1)
        j = j_rng.hash_uniform3(jnp.asarray(idx), jnp.uint32(seed), stream=1)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c = np.random.default_rng(1).integers(0, 1024, (500, 3)).astype(np.int32)
    code = morton.morton3d(torch.from_numpy(c))
    np.testing.assert_array_equal(code.numpy(),
                                  np.asarray(j_morton.morton3d(c)))
    np.testing.assert_array_equal(morton.morton3d_invert(code).numpy(), c)


def test_eval_entry_point_bakes_and_renders_on_cpu(tmp_path, monkeypatch,
                                                   capsys):
    """ARNERF_EVAL_BAKED=1 through the eval entry point (`main`, as
    `python -m arnerf_tpu_torch.eval` runs it) with --device cpu on a tiny
    checkpoint: bake time, then the FPS/PSNR line. The bake runs at 32^3
    here; its default 256^3 takes minutes on the CPU."""
    from arnerf_tpu_torch import eval as t_eval
    cfg = JConfig(scale=0.5, grid_size=G, n_levels=4, log2_hashmap_size=12)
    params = j_init(jax.random.PRNGKey(0), cfg)
    occ = analytic_occupancy(0.5, G, 1).numpy()
    path = str(tmp_path / "epoch=0.npz")
    j_save(path, params=params,
           grid_state=j_grid_init(cfg)._replace(occ_flat=jnp.asarray(occ)))
    monkeypatch.setenv("ARNERF_EVAL_BAKED", "1")
    bake = trb.bake_ngp
    sizes = []

    def small_bake(*a, **k):
        sizes.append(k.get("resolution", 256))
        return bake(*a, **{**k, "resolution": B})
    monkeypatch.setattr(trb, "bake_ngp", small_bake)
    res = t_eval.main(["--device", "cpu", "--dataset_name", "synthetic",
                       "--downsample", "0.25", "--ckpt_path", path,
                       "--grid_size", "32", "--n_levels", "4",
                       "--log2_hashmap_size", "12"])
    out = capsys.readouterr().out
    assert sizes == [256]              # eval asks for JAX's default
    assert "baked field in" in out
    assert "FPS:" in out and "(32x32)" in out and "PSNR:" in out
    assert res["baked"] and res["bake_voxels"] > 0
    assert all(r for r in res["rounds_per_bucket"])
    assert np.isfinite(res["psnr"]).all()
