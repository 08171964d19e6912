"""The training half of the port's ops against the JAX package on the CPU:
the same numpy inputs (and the same random draws) go through both.

Tolerances, and why:
- the counter RNG and the stochastic corner picks: bit for bit;
- segment sums: 1e-6 absolute in f32 (index_add_ sums in another order
  than XLA's scatter or the one-hot matmul), exact sums of bf16 values
  where every sum is exact;
- hash-grid and fused-head gradients: 1e-5 relative to the largest entry
  in f32 (sum order); 2e-2 in bf16, where both sides round cotangents to
  bf16 at their own points;
- marchers: sample counts, layouts, ray indices and validity exactly;
  positions, t and deltas to 1e-6. The port selects samples by sorting;
  it is held to both of the JAX package's selections ("search" and
  "sort"), which give the same sample sets;
- compositing and losses: 1e-5 relative, values and gradients (5e-5
  for the distortion loss, a difference of products of prefix sums).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu.models import ngp as j_ngp
from arnerf_tpu.ops import hashgrid as j_hg
from arnerf_tpu.ops import marching as j_march
from arnerf_tpu.ops import rng as j_rng
from arnerf_tpu.ops import segments as j_seg
from arnerf_tpu.ops.composite import composite_train as j_composite
from arnerf_tpu.ops.distortion import distortion_loss as j_distortion
from arnerf_tpu.ops.fused_head import fused_field_head as j_head
from arnerf_tpu.ops.packbits import packbits as j_packbits
from arnerf_tpu.training import losses as j_losses

from arnerf_tpu_torch.datasets.synthetic import analytic_occupancy
from arnerf_tpu_torch.models import ngp as t_ngp
from arnerf_tpu_torch.ops import fused_head as t_fused
from arnerf_tpu_torch.ops import hashgrid as t_hg
from arnerf_tpu_torch.ops import marching as t_march
from arnerf_tpu_torch.ops import rng as t_rng
from arnerf_tpu_torch.ops import segments as t_seg
from arnerf_tpu_torch.ops.composite import composite_train
from arnerf_tpu_torch.ops.distortion import distortion_loss
from arnerf_tpu_torch.ops.packbits import packbits, unpackbits
from arnerf_tpu_torch.rendering import default_candidates, scene_hits
from arnerf_tpu_torch.training import losses as t_losses
from arnerf_tpu_torch.training.ckpt import params_from_jax

torch.set_num_threads(2)

SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(t_out, j_out, rtol):
    j = np.asarray(j_out, dtype=np.float32)
    t = t_out.detach().float().numpy()
    scale = max(float(np.abs(j).max()), 1e-30)
    np.testing.assert_allclose(t, j, atol=rtol * scale, rtol=0)


# --------------------------------------------------------------------------
# counter RNG, packbits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345, 0xFFFFFFFF])
def test_hash_uniform_bit_exact(seed):
    idx = np.concatenate([np.arange(4096, dtype=np.uint32),
                          np.array([2**31, 2**32 - 1], np.uint32)])
    for stream in (0, 1, 3):
        j = np.asarray(j_rng.hash_uniform(jnp.asarray(idx), np.uint32(seed),
                                          stream=stream))
        t = t_rng.hash_uniform(_t(idx.astype(np.int64)), seed,
                               stream=stream).numpy()
        np.testing.assert_array_equal(t, j)
    h = np.asarray(j_rng.hash_u32(jnp.asarray(idx)))
    np.testing.assert_array_equal(
        t_rng.hash_u32(_t(idx.astype(np.int64))).numpy(), h.astype(np.int64))


def test_packbits_matches_and_roundtrips():
    g = np.random.default_rng(0).normal(size=(2, 4096)).astype(np.float32)
    j = np.asarray(j_packbits(jnp.asarray(g), 0.3))
    t = packbits(_t(g), 0.3)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(unpackbits(t).numpy(),
                                  (g > 0.3).astype(np.uint8))


# --------------------------------------------------------------------------
# segment sums (the _hist_kernel function)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("F", [1, 2, 16])
def test_segment_sum_pack_matches_mxu_hist(F):
    """pack=True is _hist_kernel's quantisation: bf16 values, f32 sums;
    -1 rows are dropped."""
    rng = np.random.default_rng(F)
    M, rows = 5000, 700
    idx = rng.integers(0, rows, M).astype(np.int32)
    idx[rng.random(M) < 0.1] = -1
    vals = rng.normal(size=(M, F)).astype(np.float32)
    j = np.asarray(j_seg.mxu_segment_sum(
        jnp.asarray(idx), tuple(jnp.asarray(vals[:, f]) for f in range(F)),
        rows, interpret=True))
    t_seg.reset_launches()
    t = t_seg.segment_sum(_t(idx), _t(vals), rows, pack=True)
    assert t_seg.launches == {"pack": 0, "exact": 0}   # the plain version
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-6)


def test_segment_sum_pack_rounds_to_bf16_exactly():
    """Values whose bf16 sums are exact in f32: the rounding, not the sum
    order, decides the result, so it must match bit for bit."""
    rng = np.random.default_rng(3)
    M, rows = 3000, 50
    idx = rng.integers(-1, rows, M).astype(np.int32)
    vals = (rng.integers(-64, 64, (M, 2)) / 8.0
            + rng.integers(0, 2, (M, 2)) * 2.0 ** -9).astype(np.float32)
    j = np.asarray(j_seg.mxu_segment_sum(
        jnp.asarray(idx), (jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1])),
        rows, interpret=True))
    t = t_seg.segment_sum(_t(idx), _t(vals), rows, pack=True)
    np.testing.assert_array_equal(t.numpy(), j)


def test_dense_segment_sum_exact_matches_scatter():
    rng = np.random.default_rng(1)
    M, rows = 20000, 300
    idx = rng.integers(0, rows, M).astype(np.int32)
    vals = rng.normal(size=(M, 2)).astype(np.float32)
    j = np.asarray(j_seg.dense_segment_sum(jnp.asarray(idx),
                                           jnp.asarray(vals), rows,
                                           method="scatter"))
    t = t_seg.dense_segment_sum(_t(idx), _t(vals), rows)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("pack", [False, True])
def test_dense_segment_sum_batched_matches_jax(pack):
    """Level-local rows, concatenated table. pack=False against the JAX
    sort pipeline in exact mode; with pack=True the CPU path is exact like
    the JAX package's CPU path (method="auto" is a scatter there)."""
    rng = np.random.default_rng(2)
    sizes = (64, 300, 4096)
    M = 3000
    idx = np.stack([rng.integers(0, s, M) for s in sizes]).astype(np.int32)
    cols = [rng.normal(size=(len(sizes), M)).astype(np.float32)
            for _ in range(2)]
    j = np.asarray(j_seg.dense_segment_sum_batched(
        jnp.asarray(idx), tuple(jnp.asarray(c) for c in cols), sizes,
        method="auto" if pack else "sort", pack=pack))
    t = t_seg.dense_segment_sum_batched(_t(idx), [_t(c) for c in cols],
                                        sizes, pack=pack)
    assert t.shape == (sum(sizes), 2)
    # the sort path's cumsum carries ~1e-6 x the running total
    np.testing.assert_allclose(t.numpy(), j, atol=2e-4, rtol=0)


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("groups", [1, 16, 128])
def test_segment_sum_grouped_idx(groups, pack):
    """idx (N, G), N samples of G updates each (the hash-grid backward's
    layout), is the same function as the 1-D call on the flattened rows,
    bit for bit, and matches the JAX package: _hist_kernel in interpret
    mode with pack (-1 rows dropped), the exact scatter without (whose
    rows must lie in the table)."""
    rng = np.random.default_rng(20 + groups)
    N, rows = 40, 500
    idx = rng.integers(0, rows, (N, groups)).astype(np.int32)
    if pack:
        idx[rng.random((N, groups)) < 0.1] = -1
    vals = rng.normal(size=(N * groups, 2)).astype(np.float32)
    t = t_seg.segment_sum(_t(idx), _t(vals), rows, pack=pack)
    flat = t_seg.segment_sum(_t(idx.reshape(-1)), _t(vals), rows, pack=pack)
    assert torch.equal(t, flat)
    if pack:
        j = j_seg.mxu_segment_sum(
            jnp.asarray(idx.reshape(-1)),
            (jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1])), rows,
            interpret=True)
    else:
        j = j_seg.dense_segment_sum(jnp.asarray(idx.reshape(-1)),
                                    jnp.asarray(vals), rows, method="scatter")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                               rtol=1e-6)


def test_dense_segment_max_matches():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 200, 3000).astype(np.int32)
    vals = rng.random(3000).astype(np.float32)
    j = np.asarray(j_seg.dense_segment_max(jnp.asarray(idx),
                                           jnp.asarray(vals), 256,
                                           method="sort"))
    t = t_seg.dense_segment_max(_t(idx), _t(vals), 256)
    np.testing.assert_array_equal(t.numpy(), j)


def test_segment_sum_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        t_seg.segment_sum(torch.zeros(4, dtype=torch.int32, device="meta"),
                          torch.zeros((4, 2), device="meta"), 8)


# --------------------------------------------------------------------------
# hash grid: stochastic corners and both gradients
# --------------------------------------------------------------------------

def _hash_cfgs(levels=4, log2=12, base=4):
    kw = dict(n_levels=levels, log2_hashmap_size=log2, base_resolution=base,
              per_level_scale=j_hg.ngp_growth_factor(0.5, levels, base))
    return j_hg.HashGridConfig(**kw), t_hg.HashGridConfig(**kw)


def _hash_inputs(cfg, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (cfg.total_entries, 2)).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    g = rng.normal(size=(n, cfg.out_dim)).astype(np.float32)
    return table, x, g


@pytest.mark.parametrize("levels,log2", [(4, 12), (16, 19)])
def test_stoch_indices_bit_exact(levels, log2):
    jc, tc = _hash_cfgs(levels, log2, 16 if levels == 16 else 4)
    _, x, _ = _hash_inputs(jc, n=4000)
    for seed in (7, 0xDEADBEEF):
        j = np.asarray(jax.jit(j_hg._stoch_indices, static_argnums=2)(
            jnp.asarray(x), np.uint32(seed), jc))
        t = t_hg._stoch_indices(_t(x), seed, tc)
        np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


def test_exact_encode_gradients_match():
    jc, tc = _hash_cfgs()
    table, x, g = _hash_inputs(jc)
    _, vjp = jax.vjp(lambda a, b: j_hg.hashgrid_encode(a, b, jc),
                     jnp.asarray(table), jnp.asarray(x))
    j_dt, j_dx = vjp(jnp.asarray(g))
    tt = _t(table).requires_grad_()
    tx = _t(x).requires_grad_()
    out = t_hg.hashgrid_encode(tt, tx, tc)
    out.backward(_t(g))
    _rel_close(tt.grad, j_dt, 1e-5)
    _rel_close(tx.grad, j_dx, 1e-5)


def test_stoch_encode_forward_and_gradient_match():
    jc, tc = _hash_cfgs()
    table, x, g = _hash_inputs(jc, seed=5)
    seed = 987654321
    out_j, vjp = jax.vjp(
        lambda a: j_hg.hashgrid_encode(a, jnp.asarray(x), jc,
                                       seed=np.uint32(seed)),
        jnp.asarray(table))
    (j_dt,) = vjp(jnp.asarray(g))
    tt = _t(table).requires_grad_()
    tx = _t(x).requires_grad_()
    out = t_hg.hashgrid_encode(tt, tx, tc, seed=seed)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    out.backward(_t(g))
    _rel_close(tt.grad, j_dt, 1e-5)
    assert float(tx.grad.abs().max()) == 0.0   # piecewise constant in x


@pytest.mark.parametrize("stoch", [False, True])
def test_encode_backwards_pass_grouped_updates(stoch, monkeypatch):
    """Both hash-grid backwards hand segment_sum their updates as (N, G)
    samples of G = L*8 corner updates (exact) or L level updates
    (stochastic), sample-major, and the table gradient still matches the
    JAX package's."""
    jc, tc = _hash_cfgs()
    table, x, g = _hash_inputs(jc, seed=6)
    seed = 24680 if stoch else None
    shapes = []

    def spy(idx, vals, num_rows, pack=False):
        shapes.append((tuple(idx.shape), tuple(vals.shape)))
        return t_seg.segment_sum(idx, vals, num_rows, pack)
    monkeypatch.setattr(t_hg, "segment_sum", spy)
    jseed = None if seed is None else np.uint32(seed)
    _, vjp = jax.vjp(lambda a: j_hg.hashgrid_encode(a, jnp.asarray(x), jc,
                                                    seed=jseed),
                     jnp.asarray(table))
    (j_dt,) = vjp(jnp.asarray(g))
    tt = _t(table).requires_grad_()
    t_hg.hashgrid_encode(tt, _t(x), tc, seed=seed).backward(_t(g))
    n, L = x.shape[0], tc.n_levels
    G = L if stoch else L * 8
    assert shapes == [((n, G), (n * G, tc.n_features))]
    _rel_close(tt.grad, j_dt, 1e-5)


# --------------------------------------------------------------------------
# fused head: the gradient (plain recompute) against jax.vjp of the Pallas
# kernel in interpret mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_head_gradients_match(dtype):
    rng = np.random.default_rng(11)
    n = 300
    feats = rng.normal(size=(n, 32)).astype(np.float32) * 0.5
    sh = rng.normal(size=(n, 16)).astype(np.float32) * 0.5
    ws = [(rng.uniform(-1, 1, s) * np.sqrt(6.0 / s[0])).astype(np.float32)
          for s in t_fused.HEAD_SHAPES]
    gh = rng.normal(size=(n, 16)).astype(np.float32)
    grgb = rng.normal(size=(n, 3)).astype(np.float32)
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda f, s, w: j_head(f, s, w, jd, True),
                     jnp.asarray(feats), jnp.asarray(sh),
                     tuple(jnp.asarray(w) for w in ws))
    j_df, j_ds, j_dw = vjp((jnp.asarray(gh), jnp.asarray(grgb)))
    tf = _t(feats).requires_grad_()
    ts = _t(sh).requires_grad_()
    tw = [_t(w).requires_grad_() for w in ws]
    h, rgb = t_fused.fused_field_head(tf, ts, tw, getattr(torch, dtype))
    torch.autograd.backward((h, rgb), (_t(gh), _t(grgb)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    _rel_close(tf.grad, j_df, tol)
    _rel_close(ts.grad, j_ds, tol)
    for a, b in zip(tw, j_dw):
        _rel_close(a.grad, b, tol)


# --------------------------------------------------------------------------
# training marchers
# --------------------------------------------------------------------------

def _rays(n=512, scale=0.5, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([1.2 * np.cos(th), rng.uniform(-0.4, 0.2, n),
                  1.2 * np.sin(th)], 1) * (scale / 0.5)
    tgt = rng.uniform(-0.3, 0.3, (n, 3)) * scale
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    noise = rng.random(n).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), noise


def _march_setup(scale=0.5, n=512):
    o, d, noise = _rays(n, scale)
    G = SMALL["grid_size"]
    cascades = max(1 + int(np.ceil(np.log2(2 * scale))), 1)
    occ = analytic_occupancy(scale, G, cascades).numpy()
    cfg = t_ngp.NGPConfig(scale=scale, **SMALL)
    hits = scene_hits(_t(o), _t(d), cfg).numpy()
    exp_step = 1 / 256 if scale > 0.5 else 0.0
    kw = dict(scale=scale, cascades=cascades, exp_step_factor=exp_step,
              grid_size=G, max_samples=1024,
              n_candidates=default_candidates(cfg, exp_step))
    return o, d, hits, occ, noise, kw


def _coarse(occ, kw):
    r = t_march.coarse_dilation_radius(
        scale=kw["scale"], exp_step_factor=kw["exp_step_factor"],
        grid_size=kw["grid_size"], max_samples=kw["max_samples"])
    return t_march.build_coarse_occupancy(_t(occ), kw["cascades"],
                                          kw["grid_size"], dilate=r).numpy()


def _assert_same_march(t, j):
    for k in ("counts", "ray_start", "ray_idx", "valid"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    for k in ("rm_samples", "max_nseg"):
        assert int(getattr(t, k)) == int(getattr(j, k)), k
    if j.total_nseg is not None:
        assert int(t.total_nseg) == int(j.total_nseg)
    for k in ("xyzs", "ts", "deltas", "dirs"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), atol=1e-6,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("mode,selection,m_cap,scale", [
    ("single", "search", 40000, 0.5),
    ("single", "sort", 40000, 0.5),
    ("single", "search", 3000, 0.5),       # over budget: striding
    ("single", "sort", 20000, 1.0),        # two cascades, exp stepping
    ("two_level", "search", 40000, 0.5),
    ("two_level", "sort", 40000, 0.5),
    ("two_level", "sort", 3000, 0.5),
    ("two_level", "search", 3000, 0.5),
])
def test_march_rays_train_matches(mode, selection, m_cap, scale):
    o, d, hits, occ, noise, kw = _march_setup(scale)
    kw = dict(kw, m_cap=m_cap, s_cap=1024)
    occ_c = _coarse(occ, kw) if mode == "two_level" else None
    j = j_march.march_rays_train(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hits), jnp.asarray(occ),
        jnp.asarray(noise), seg_cap=64,
        occ_coarse=None if occ_c is None else jnp.asarray(occ_c),
        selection=selection, **kw)
    t = t_march.march_rays_train(
        _t(o), _t(d), _t(hits), _t(occ), _t(noise), seg_cap=64,
        occ_coarse=None if occ_c is None else _t(occ_c), **kw)
    assert int(t.rm_samples) > 0
    if m_cap == 3000:
        assert int(t.rm_samples) > m_cap      # the striding regime
    _assert_same_march(t, j)


@pytest.mark.parametrize("selection,m_cap,pool", [
    ("sort", 40000, 512 * 16), ("search", 40000, 512 * 16),
    ("sort", 3000, 900), ("search", 3000, 900),   # both budgets strided
])
def test_march_rays_train_pooled_matches(selection, m_cap, pool):
    o, d, hits, occ, noise, kw = _march_setup(0.5)
    kw = dict(kw, m_cap=m_cap, s_cap=1024)
    occ_c = _coarse(occ, kw)
    j = j_march.march_rays_train_pooled(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(hits), jnp.asarray(occ),
        jnp.asarray(noise), occ_coarse=jnp.asarray(occ_c),
        seg_pool_cap=pool, selection=selection, **kw)
    t = t_march.march_rays_train_pooled(
        _t(o), _t(d), _t(hits), _t(occ), _t(noise), occ_coarse=_t(occ_c),
        seg_pool_cap=pool, **kw)
    if pool == 900:
        assert int(t.total_nseg) > pool
    _assert_same_march(t, j)


# --------------------------------------------------------------------------
# compositing and losses
# --------------------------------------------------------------------------

def _segments(seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, 40)
    counts[3] = 0
    M = int(counts.sum()) + 17                  # trailing invalid slots
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ray_idx = np.minimum(np.searchsorted(starts, np.arange(M),
                                         side="right") - 1, 39)
    valid = np.arange(M) < counts.sum()
    sig = rng.uniform(0, 30, M).astype(np.float32)
    rgb = rng.random((M, 3)).astype(np.float32)
    deltas = rng.uniform(0.002, 0.05, M).astype(np.float32)
    ts = np.cumsum(deltas).astype(np.float32)
    return (sig, rgb, deltas, ts, ray_idx.astype(np.int64), valid,
            starts.astype(np.int64), counts.astype(np.int64))


def test_composite_train_values_and_gradients():
    sig, rgb, deltas, ts, ray_idx, valid, starts, counts = _segments()
    rng = np.random.default_rng(1)
    g_op, g_rgb = rng.normal(size=40), rng.normal(size=(40, 3))

    def j_fn(s, c):
        r = j_composite(s, c, jnp.asarray(deltas), jnp.asarray(ts),
                        jnp.asarray(ray_idx), jnp.asarray(valid),
                        jnp.asarray(starts), jnp.asarray(counts), 1e-4)
        return jnp.sum(r.opacity * g_op) + jnp.sum(r.rgb * g_rgb), r
    (_, j_r), (j_ds, j_dc) = jax.value_and_grad(j_fn, argnums=(0, 1),
                                                has_aux=True)(
        jnp.asarray(sig), jnp.asarray(rgb))
    ts_ = _t(sig).requires_grad_()
    tc_ = _t(rgb).requires_grad_()
    r = composite_train(ts_, tc_, _t(deltas), _t(ts), _t(ray_idx),
                        _t(valid), _t(starts), _t(counts), 1e-4)
    (torch.sum(r.opacity * _t(g_op).float())
     + torch.sum(r.rgb * _t(g_rgb).float())).backward()
    for k in ("opacity", "depth", "rgb", "ws"):
        _rel_close(getattr(r, k), getattr(j_r, k), 1e-5)
    assert int(r.vr_samples) == int(j_r.vr_samples)
    _rel_close(ts_.grad, j_ds, 1e-5)
    _rel_close(tc_.grad, j_dc, 1e-5)


def test_distortion_loss_values_and_gradients():
    sig, _, deltas, ts, ray_idx, valid, starts, counts = _segments(2)
    ws = (sig / 30.0).astype(np.float32)
    args = (deltas, ts, ray_idx, valid, starts, counts)
    j_val, j_grad = jax.value_and_grad(
        lambda w: jnp.sum(j_distortion(w, *map(jnp.asarray, args))))(
        jnp.asarray(ws))
    tw = _t(ws).requires_grad_()
    t_val = torch.sum(distortion_loss(tw, *map(_t, args)))
    t_val.backward()
    # the loss is a difference of products of prefix sums: the cumsum's
    # order (sequential here, a scan in XLA) shows ~1e-5 of the total
    _rel_close(t_val, j_val, 5e-5)
    _rel_close(tw.grad, j_grad, 5e-5)


@pytest.mark.parametrize("loss_set,lam", [("raw", 0.0), ("log", 1e-3),
                                          ("tanh", 0.0)])
def test_nerf_loss_values_and_gradients(loss_set, lam):
    sig, _, deltas, ts, ray_idx, valid, starts, counts = _segments(3)
    rng = np.random.default_rng(4)
    rgb = rng.uniform(0.05, 0.95, (40, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    opa = rng.uniform(0.01, 0.99, 40).astype(np.float32)
    depth = rng.uniform(0.1, 1.5, 40).astype(np.float32)
    ws = (sig / 30.0).astype(np.float32)
    fixed = dict(depth=depth, ws=ws, deltas=deltas, ts=ts, ray_idx=ray_idx,
                 valid=valid, ray_start=starts, counts=counts)
    kw = dict(loss_set=loss_set, lambda_depth=lam, lambda_distortion=lam)

    def j_fn(r, o):
        res = {"rgb": r, "opacity": o,
               **{k: jnp.asarray(v) for k, v in fixed.items()}}
        return j_losses.total_loss(j_losses.nerf_loss(
            res, jnp.asarray(gt), j_losses.NeRFLossConfig(**kw)))
    j_val, (j_dr, j_do) = jax.value_and_grad(j_fn, argnums=(0, 1))(
        jnp.asarray(rgb), jnp.asarray(opa))
    tr, to = _t(rgb).requires_grad_(), _t(opa).requires_grad_()
    res = {"rgb": tr, "opacity": to, **{k: _t(v) for k, v in fixed.items()}}
    t_val = t_losses.total_loss(t_losses.nerf_loss(
        res, _t(gt), t_losses.NeRFLossConfig(**kw)))
    t_val.backward()
    _rel_close(t_val, j_val, 1e-5)
    _rel_close(tr.grad, j_dr, 1e-5)
    _rel_close(to.grad, j_do, 1e-5)


# --------------------------------------------------------------------------
# occupancy-grid maintenance
# --------------------------------------------------------------------------

def _ngp_pair(stoch=False, seed=0):
    jc = j_ngp.NGPConfig(scale=0.5, stoch_corners=stoch, **SMALL)
    tc = t_ngp.NGPConfig(scale=0.5, stoch_corners=stoch, **SMALL)
    j_params = j_ngp.ngp_init(jax.random.PRNGKey(seed), jc)
    from arnerf_tpu.training.ckpt import _flatten
    return jc, tc, j_params, params_from_jax(_flatten(j_params, "params/"))


def _cameras():
    from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                     SyntheticDataset)
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=(40, 30), n_train=6))
    return ds.K, ds.poses


def test_mark_invisible_cells_exact():
    jc, tc, _, _ = _ngp_pair()
    K, poses = _cameras()
    poses = poses.copy()
    poses[:, :3, 3] *= 0.45    # cameras inside the grid: too-near cells
    rng = np.random.default_rng(0)
    dg = rng.uniform(-0.5, 3, (1, 32 ** 3)).astype(np.float32)
    j_state = j_ngp.grid_state_init(jc)._replace(density_grid=jnp.asarray(dg))
    t_state = t_ngp.grid_state_init(tc)._replace(density_grid=_t(dg))
    j = j_ngp.mark_invisible_cells(j_state, jnp.asarray(K),
                                   jnp.asarray(poses), jc, 40, 30)
    t = t_ngp.mark_invisible_cells(t_state, K, poses, tc, 40, 30)
    np.testing.assert_array_equal(t.density_grid.numpy(),
                                  np.asarray(j.density_grid))
    np.testing.assert_array_equal(t.count_grid.numpy(),
                                  np.asarray(j.count_grid))
    assert (t.density_grid.numpy() == -1).any()


def _jax_draws(key, jc, state, threshold, warmup):
    """The draws of the JAX update_density_grid for `key`, replayed."""
    G3 = jc.grid_size ** 3
    C = jc.cascades
    k_sample, k_jitter, k_stoch = jax.random.split(key, 3)
    seed = int(jax.random.bits(k_stoch, dtype=jnp.uint32)) \
        if jc.stoch_corners else None
    if warmup:
        idx, m = None, G3
    else:
        M = G3 // 4
        ku, ko = jax.random.split(k_sample)
        uniform_idx = jax.random.randint(ku, (C, M), 0, G3, jnp.int32)
        u = jax.random.uniform(ko, (C, M))
        occ_idx = t_ngp.occupied_cells(_t(state.density_grid), threshold,
                                       _t(u))
        idx = torch.cat([_t(uniform_idx).long(), occ_idx], dim=1)
        m = 2 * M
    jitter = jax.random.uniform(k_jitter, (C * m, 3))
    return idx, _t(jitter), seed


@pytest.mark.parametrize("warmup,stoch", [(True, False), (False, False),
                                          (True, True), (False, True)])
def test_update_density_grid_core_matches(warmup, stoch):
    jc, tc, j_params, t_params = _ngp_pair(stoch, seed=1)
    thr = 0.01 * 1024 / 3 ** 0.5
    rng = np.random.default_rng(5)
    dg = np.where(rng.random((1, 32 ** 3)) < 0.1, -1.0,
                  rng.uniform(0, 20, (1, 32 ** 3))).astype(np.float32)
    cg = rng.random((1, 32 ** 3)).astype(np.float32)
    j_state = j_ngp.grid_state_init(jc)._replace(
        density_grid=jnp.asarray(dg), count_grid=jnp.asarray(cg))
    t_state = t_ngp.grid_state_init(tc)._replace(density_grid=_t(dg),
                                                 count_grid=_t(cg))
    key = jax.random.PRNGKey(3)
    erode = not warmup
    j = j_ngp.update_density_grid(j_params, j_state, key, jc,
                                  density_threshold=thr, warmup=warmup,
                                  erode=erode)
    idx, jitter, seed = _jax_draws(key, jc, j_state, thr, warmup)
    t = t_ngp.update_density_grid_core(t_params, t_state, tc, thr, idx,
                                       jitter, seed=seed, erode=erode)
    np.testing.assert_allclose(t.density_grid.numpy(),
                               np.asarray(j.density_grid), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(t.occ_flat.numpy(), np.asarray(j.occ_flat))
    np.testing.assert_array_equal(t.bitfield.numpy(), np.asarray(j.bitfield))


def test_occupied_cells_matches_jax_lower_bound():
    rng = np.random.default_rng(6)
    dg = rng.uniform(0, 20, (2, 4096)).astype(np.float32)
    u = rng.random((2, 1000)).astype(np.float32)
    cdf = jnp.cumsum((jnp.asarray(dg) > 10.0).astype(jnp.float32), axis=-1)
    q = jnp.asarray(u) * jnp.maximum(cdf[:, -1:], 1e-9)
    rows = jnp.broadcast_to(jnp.arange(2)[:, None], (2, 1000))
    j = np.minimum(np.asarray(j_march._lower_bound_rows(
        cdf.reshape(-1), rows.reshape(-1), q.reshape(-1), 4096)), 4095)
    t = t_ngp.occupied_cells(_t(dg), 10.0, _t(u))
    np.testing.assert_array_equal(t.numpy().reshape(-1), j)
    assert (dg[np.arange(2)[:, None], t.numpy()] > 10.0).all()
