"""The port's delta bake (rendering_baked.bake_ngp_delta / bake_field_delta)
against the JAX package's on the CPU, at tests/test_baked_delta.py's sizes
(occupancy grid 16, bake 32, n_dirs 8, exact corners) and sequences.

Both packages start from the same JAX-initialised NGP (converted by
params_from_jax) and the same numpy density and occupancy grids, and run
the same sequence of bakes and deltas. After every step: the stats and
the snapshots (src_density, src_occ, src_mask, bake_phase) exactly equal;
rows and sigma to 1e-5 of their largest entry; the mip, its distance
field, the sigma bricks, the row index, the int8 colour codes and the
bounds exactly equal. Each case also keeps the JAX test's own claim on the
port's side (no work without change, convergence to a full bake, removed
voxels zeroed, the fallbacks).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu import rendering_baked as jrb
from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_init as j_init)
from arnerf_tpu.training.ckpt import _flatten

from arnerf_tpu_torch import rendering_baked as trb
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.training.ckpt import params_from_jax

torch.set_num_threads(2)

B = 32   # bake resolution
G = 16   # occupancy grid
SMALL = dict(grid_size=G, n_levels=4, log2_hashmap_size=12,
             base_resolution=4, sigma_hidden=16, rgb_hidden=16)


def _ball():
    xyz = np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    inside = np.linalg.norm(xyz - G / 2 + 0.5, axis=1) < G / 4
    dens = np.where(inside, 1.0, 0.0).astype(np.float32)[None]
    return dens, inside.astype(np.uint8)


class Scene:
    """One NGP in both packages, and grid states made from numpy."""

    def __init__(self, scale=0.5):
        self.j_cfg = JConfig(scale=scale, **SMALL)
        self.t_cfg = NGPConfig(scale=scale, **SMALL)
        self.j_params = j_init(jax.random.PRNGKey(0), self.j_cfg)
        C = self.j_cfg.cascades
        dens, occ = _ball()
        self.dens = np.tile(dens, (C, 1))
        self.occ = np.tile(occ, C)

    def params(self, eps=0.0):
        """(JAX, port) params; eps shifts the first rgb layer, as the JAX
        test's _perturb."""
        jp = dict(self.j_params)
        if eps:
            jp["rgb_mlp"] = [jp["rgb_mlp"][0] + eps] + list(jp["rgb_mlp"][1:])
        return jp, params_from_jax(_flatten(jp, "params/"))

    def states(self, dens=None, occ=None):
        dens = self.dens if dens is None else dens
        occ = self.occ if occ is None else occ
        return (j_grid_init(self.j_cfg)._replace(
                    density_grid=jnp.asarray(dens), occ_flat=jnp.asarray(occ)),
                grid_state_init(self.t_cfg)._replace(
                    density_grid=torch.from_numpy(dens.copy()),
                    occ_flat=torch.from_numpy(occ.copy())))

    def bake(self, params, states, **kw):
        return (jrb.bake_ngp(params[0], states[0], self.j_cfg, resolution=B,
                             **kw),
                trb.bake_ngp(params[1], states[1], self.t_cfg, resolution=B,
                             **kw))

    def delta(self, params, states, prev, **kw):
        """One delta in each package from its own previous bake; asserts
        they agree and returns (JAX, port) bakes and the port's stats."""
        j_stats, t_stats = {}, {}
        jb = jrb.bake_ngp_delta(params[0], states[0], self.j_cfg, prev[0],
                                stats=j_stats, **kw)
        tb = trb.bake_ngp_delta(params[1], states[1], self.t_cfg, prev[1],
                                stats=t_stats, **kw)
        assert t_stats == j_stats
        assert_same(tb, jb)
        return (jb, tb), t_stats


def _rel(t, j, tol=1e-5):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=tol * max(float(np.abs(j).max()), 1e-30))


def assert_same(tb, jb):
    """A port bake against a JAX bake: floats to 1e-5 of their largest
    entry, codes, bounds and snapshots exactly."""
    _rel(tb.rows, jb.rows)
    _rel(tb.sigma, jb.sigma)
    for k in ("aabb_lo", "aabb_hi", "mip", "mip_dist", "sigma_bricks",
              "row_index"):
        jv = getattr(jb, k)
        if jv is None:
            assert getattr(tb, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                          np.asarray(jv), err_msg=k)
    jq, tq = np.asarray(jb.rows_q), tb.rows_q.numpy()
    np.testing.assert_array_equal(tq[:, :28], jq[:, :28])
    _rel(torch.from_numpy(tq[:, 28:].copy().view(np.float32)),
         jq[:, 28:].copy().view(np.float32))
    for k in ("src_density", "src_occ", "src_mask"):
        jv = getattr(jb, k)
        if jv is None:
            assert getattr(tb, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(tb, k), np.asarray(jv),
                                          err_msg=k)
    assert tb.bake_phase == int(jb.bake_phase)


@pytest.fixture(scope="module")
def scene():
    return Scene()


def test_snapshots_and_nochange_delta(scene):
    p, s = scene.params(), scene.states()
    full = scene.bake(p, s, n_dirs=8)
    assert_same(full[1], full[0])
    assert full[1].src_density is not None and full[1].src_occ is not None
    d1, stats = scene.delta(p, s, full, n_dirs=8, refresh_k=0)
    assert stats["n_changed"] == 0 and stats["n_removed"] == 0
    assert torch.equal(d1[1].rows, full[1].rows)
    assert torch.equal(d1[1].sigma_bricks, full[1].sigma_bricks)


def test_refresh_stripes_converge_to_full_bake(scene):
    """Only the appearance net drifts: the K stripes tile the cells, so K
    deltas re-bake every voxel and equal the full bake of the new net."""
    p, s = scene.params(), scene.states()
    cur = scene.bake(p, s, n_dirs=8)
    p2 = scene.params(0.05)
    target = scene.bake(p2, s, n_dirs=8)
    K, covered = 4, 0
    for _ in range(K):
        cur, stats = scene.delta(p2, s, cur, n_dirs=8, refresh_k=K)
        covered += stats["n_changed"]
    assert covered > 0
    np.testing.assert_allclose(cur[1].rows.numpy(), target[1].rows.numpy(),
                               atol=1e-6, rtol=0)
    assert_same(target[1], target[0])


def test_density_change_rebakes_changed_cells_only(scene):
    p, s = scene.params(), scene.states()
    full = scene.bake(p, s, n_dirs=8)
    p2 = scene.params(0.1)
    xyz = np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    dens = scene.dens.copy()
    hot = (xyz < G // 2).all(axis=1) & (dens[0] > 0)
    dens[0, hot] *= 2.0
    s2 = scene.states(dens=dens)
    d, stats = scene.delta(p2, s2, full, n_dirs=8, refresh_k=0)
    assert 0 < stats["n_changed"] < stats["n_total"]
    target = trb.bake_ngp(p2[1], s2[1], scene.t_cfg, resolution=B, n_dirs=8)
    vid = np.arange(B ** 3)
    vx, vy, vz = vid // (B * B), (vid // B) % B, vid % B
    hot_v = (vx < B // 3) & (vy < B // 3) & (vz < B // 3)
    cold_v = (vx > 2 * B // 3) & (vy > 2 * B // 3) & (vz > 2 * B // 3)
    baked_v = target.rows[:, 0].numpy() > 0
    rows_d = d[1].rows.numpy()
    np.testing.assert_allclose(rows_d[hot_v & baked_v],
                               target.rows.numpy()[hot_v & baked_v],
                               atol=1e-6)
    np.testing.assert_allclose(rows_d[cold_v & baked_v],
                               full[1].rows.numpy()[cold_v & baked_v],
                               atol=1e-6)
    assert np.all(d[1].src_density[0, hot] == dens[0, hot])


def test_stochastic_delta_draws_what_jax_draws(scene):
    """Stochastic corners: each chunk of the delta is seeded with its index
    within the delta, as in JAX, so the rows agree draw for draw."""
    p, s = scene.params(), scene.states()
    full = scene.bake(p, s, n_dirs=8, stoch=True)
    assert_same(full[1], full[0])
    dens = scene.dens * np.where(np.arange(G ** 3) % 3 == 0, 1.5, 1.0)
    d, stats = scene.delta(scene.params(0.05), scene.states(
        dens=dens.astype(np.float32)), full, n_dirs=8, refresh_k=4,
        stoch=True)
    assert 0 < stats["n_changed"] < stats["n_total"]
    assert not torch.equal(d[1].rows, full[1].rows)


def test_occupancy_removal_zeroes_rows_and_mip(scene):
    p, s = scene.params(), scene.states()
    full = scene.bake(p, s, n_dirs=8)
    occ2, dens2 = scene.occ.copy(), scene.dens.copy()
    gone = np.nonzero(occ2)[0][: len(np.nonzero(occ2)[0]) // 2]
    occ2[gone] = 0
    dens2[0, gone] = 0.0
    s2 = scene.states(dens=dens2, occ=occ2)
    d, stats = scene.delta(p, s2, full, n_dirs=8, refresh_k=0)
    assert stats["n_removed"] > 0
    target = trb.bake_ngp(p[1], s2[1], scene.t_cfg, resolution=B, n_dirs=8)
    t_sig = target.rows[:, 0].numpy()
    assert np.all(d[1].rows[:, 0].numpy()[t_sig == 0] == 0)
    assert torch.equal(d[1].mip, target.mip)


def test_fallback_full_bake_without_snapshots(scene):
    p, s = scene.params(), scene.states()
    full = scene.bake(p, s, n_dirs=8)
    legacy = (full[0]._replace(src_density=None, src_occ=None),
              dataclasses.replace(full[1], src_density=None, src_occ=None))
    d, _ = scene.delta(p, s, legacy, n_dirs=8)
    np.testing.assert_allclose(d[1].rows.numpy(), full[1].rows.numpy(),
                               atol=1e-6, rtol=0)
    assert d[1].src_density is not None


def test_budgeted_delta_bounded_cost_and_convergence(scene):
    """budget_cells caps each delta at the most-moved cells and leaves the
    rest dirty; repeated budgeted deltas of a static field converge to its
    full bake (JAX's sequence, at the default 32 directions)."""
    p, s = scene.params(), scene.states()
    baked = scene.bake(p, s)
    dens = scene.dens * 1.5
    s2 = scene.states(dens=dens)
    budget = max(8, int(scene.occ.sum()) // 4)
    cur, stats = scene.delta(p, s2, baked, refresh_k=0, budget_cells=budget)
    assert stats["n_changed"] < stats["n_total"]
    assert int((np.abs(cur[1].src_density - dens) > 1e-6).sum()) > 0
    for _ in range(16):
        cur, _ = scene.delta(p, s2, cur, refresh_k=0, budget_cells=budget)
    ref = trb.bake_ngp(p[1], s2[1], scene.t_cfg, resolution=B)
    np.testing.assert_allclose(cur[1].rows.numpy(), ref.rows.numpy(),
                               rtol=0, atol=1e-5)
    assert (np.abs(cur[1].src_density - dens) < 1e-6).all()


def test_multi_cascade_falls_back_to_a_full_bake():
    """Three cascades: no snapshots, and the delta is a full multi-cascade
    bake in both packages."""
    mc = Scene(scale=2.0)
    assert mc.t_cfg.cascades == 3
    p, s = mc.params(), mc.states()
    full = mc.bake(p, s, n_dirs=8)
    assert full[1].src_density is None and full[1].cascades == 3
    d, stats = mc.delta(mc.params(0.05), s, full, n_dirs=8)
    assert stats == {}
    assert d[1].cascades == 3 and d[1].src_density is None
