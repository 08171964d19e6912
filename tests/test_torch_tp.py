"""The port's row-sharded hash table (arnerf_tpu_torch/parallel/tp.py, the
trainer on a (data, model) mesh, `train --model_parallel`) on gloo ranks
on the CPU, against the JAX package and against the port's own data
parallel runs, at tests/test_tp.py's size (16x16 images, 4 levels, a 2^12
table of 12,352 rows, batch 64).

- TP against DP: a 2x2 run equals a 4-rank DP run given the same
  per-rank draws: the loss to rtol 1e-4, the table and every leaf to atol
  2e-5 and rtol 1e-3, as tests/test_tp.py:45 requires (the collectives
  only reorder the sums).
- Sharding: in a 1x2 run each rank holds padded/2 rows of the table and
  of its Adam mu and nu; in a 1x3 run padded/3 of 12,354 rows.
- Checkpoints: a port 1x2 checkpoint loads into the JAX unsharded
  trainer; a JAX make_mesh_2d(2, 4) checkpoint loads into a port 1x3
  trainer, which re-pads it (12,352 rows do not divide by 3) and trains
  one block.
- pad_tree / unpad_tree equal JAX's on the same numpy tree.
- Collective bytes of a 2x2 block against JAX's block_collective_report
  per primitive, to the byte (reduce_scatter is lax.psum_scatter's
  primitive); departure: the port also counts the nseg max (`pmax`),
  which JAX's accounting does not list.
- The entry point: `--device cpu --num_gpus 4 --model_parallel 2` trains
  and writes an unpadded checkpoint; `--num_gpus 3 --model_parallel 2`
  raises JAX's ValueError.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_init as j_init)
from arnerf_tpu.parallel.tp import (make_mesh_2d as j_make_mesh_2d,
                                    pad_table as j_pad_table,
                                    pad_tree as j_pad_tree,
                                    unpad_table as j_unpad_table,
                                    unpad_tree as j_unpad_tree)
from arnerf_tpu.training.ckpt import load_ckpt as j_load

from arnerf_tpu_torch.parallel import tp as t_tp

import test_torch_parallel_worker as worker
from test_tp import _setup, _trainer
from test_torch_parallel import _jax_block_report, _leaves

REPO = Path(__file__).resolve().parent.parent
TE, F = 12352, 2          # the table's rows and features at this size


@pytest.fixture(scope="module")
def jax_tp_ckpt(tmp_path_factory):
    """A JAX 2x4 sharded trainer's checkpoint after one block."""
    cfg, tc, ds = _setup()
    assert cfg.hash_cfg.total_entries == TE
    tr = _trainer(cfg, tc, ds, j_make_mesh_2d(2, 4))
    tr.train_block()
    path = str(tmp_path_factory.mktemp("jax") / "tp24.npz")
    tr.save(path)
    return path, np.asarray(tr.params["hash_table"])


@pytest.fixture(scope="module")
def runs(jax_tp_ckpt, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    tp22, dp4, tp12, tp13 = worker.run_ranks(
        [{"kind": "blocks", "n_dp": 2, "n_mp": 2, "blocks": 2},
         {"kind": "blocks", "n_dp": 4, "n_mp": 1, "blocks": 2},
         {"kind": "blocks", "n_dp": 1, "n_mp": 2, "blocks": 1,
          "save": str(tmp / "tp12.npz")},
         {"kind": "blocks", "n_dp": 1, "n_mp": 3, "blocks": 1,
          "load": jax_tp_ckpt[0], "save": str(tmp / "tp13.npz")}], tmp)
    return {"tp22": tp22, "dp4": dp4, "tp12": tp12, "tp13": tp13,
            "tp12_ckpt": str(tmp / "tp12.npz")}


def _table(ranks, n_mp):
    """The full unpadded table from the shards of data row 0."""
    return np.concatenate([ranks[m]["param/0"] for m in range(n_mp)])[:TE]


def test_tp_matches_dp(runs):
    tp, dp = runs["tp22"], runs["dp4"]
    for r in range(4):
        assert np.isfinite(tp[r]["metric1/loss"])
        np.testing.assert_allclose(tp[r]["metric1/loss"],
                                   dp[r]["metric1/loss"], rtol=1e-4)
    # ranks (d, m) and (d', m) hold the same rows, bitwise
    np.testing.assert_array_equal(tp[0]["param/0"], tp[2]["param/0"])
    np.testing.assert_array_equal(tp[1]["param/0"], tp[3]["param/0"])
    np.testing.assert_allclose(_table(tp, 2), dp[0]["param/0"], atol=2e-5,
                               rtol=1e-3)
    rest = _leaves(dp[0], "param")[1:]
    assert len(rest) == len(_leaves(tp[0], "param")[1:]) > 0
    for a, b in zip(_leaves(tp[0], "param")[1:], rest):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-3)
    np.testing.assert_array_equal(tp[0]["grid/occ_flat"],
                                  dp[0]["grid/occ_flat"])


@pytest.mark.parametrize("run,n_mp", [("tp12", 2), ("tp13", 3)])
def test_table_and_moments_are_sharded(runs, run, n_mp):
    padded = t_tp.padded_rows(TE, n_mp)
    assert padded == (TE if n_mp == 2 else TE + 2)
    n_params = len(_leaves(runs[run][0], "param"))
    for out in runs[run]:
        assert out["param/0"].shape == (padded // n_mp, F)
        # optax's Adam leaves: count, mu (table first), nu, schedule count
        assert out["opt/1"].shape == out[f"opt/{1 + n_params}"].shape \
            == (padded // n_mp, F)
        assert out["opt/2"].shape == out["param/1"].shape
    # the alignment rows stay zero, in the table and its moments
    last = runs["tp13"][2]
    for k in ("param/0", "opt/1", f"opt/{1 + n_params}"):
        assert not last[k][-2:].any(), k
    assert last["param/0"][:-2].any()


def test_port_tp_checkpoint_loads_in_the_jax_unsharded_trainer(runs):
    cfg, tc, ds = _setup()
    single = _trainer(cfg, tc, ds, None)
    single.load(runs["tp12_ckpt"])
    assert single.step == 16
    np.testing.assert_array_equal(np.asarray(single.params["hash_table"]),
                                  _table(runs["tp12"], 2))
    # Adam's table moments come back whole too
    mu = [l for l in jax.tree.leaves(single.opt_state)
          if getattr(l, "shape", None) == (TE, F)]
    assert len(mu) == 2
    np.testing.assert_array_equal(np.asarray(mu[0]), np.concatenate(
        [runs["tp12"][m]["opt/1"] for m in range(2)]))
    assert np.isfinite(float(single.train_block()["loss"]))


def test_jax_tp_checkpoint_loads_in_a_port_tp_trainer(runs, jax_tp_ckpt):
    _, j_table = jax_tp_ckpt
    want = np.concatenate([j_table[:TE], np.zeros((2, F), np.float32)])
    for m, out in enumerate(runs["tp13"]):
        assert int(out["loaded_step"]) == 16
        np.testing.assert_array_equal(out["loaded_table"],
                                      want[m * 4118:(m + 1) * 4118])
        assert np.isfinite(out["metric0/loss"])
        assert not np.array_equal(out["param/0"], out["loaded_table"])
    # and its own checkpoint is the unpadded table again
    j_cfg = JConfig(**worker.SMALL)
    params, _, _, step = j_load(
        str(Path(runs["tp12_ckpt"]).parent / "tp13.npz"),
        params_template=j_init(jax.random.PRNGKey(0), j_cfg),
        grid_template=j_grid_init(j_cfg))
    assert step == 32
    np.testing.assert_array_equal(np.asarray(params["hash_table"]),
                                  _table(runs["tp13"], 3))


@pytest.mark.parametrize("te,n_mp", [(101, 8), (12352, 3), (12352, 4)])
def test_pad_and_unpad_tree_match_jax(te, n_mp):
    rng = np.random.default_rng(te + n_mp)
    tree = {"hash_table": rng.random((te, F), np.float32),
            "mlp": [rng.random((3, 5), np.float32)],
            "other": (np.ones((te + 1, F), np.float32), None)}
    padded_j = j_pad_tree(tree, te, F, n_mp)
    padded_t = t_tp.pad_tree(tree, te, F, n_mp)
    torch_t = t_tp.pad_tree(
        t_tp.tree_map(torch.from_numpy, tree), te, F, n_mp)
    for a, b, c in zip(jax.tree.leaves(padded_j), jax.tree.leaves(padded_t),
                       jax.tree.leaves(t_tp.tree_map(
                           lambda t: t.numpy(), torch_t))):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, c)
    assert padded_t["hash_table"].shape[0] == t_tp.padded_rows(te, n_mp)
    # the table-only forms
    pt = t_tp.pad_table({"hash_table": tree["hash_table"]}, n_mp)
    pj = j_pad_table({"hash_table": tree["hash_table"]}, n_mp)
    np.testing.assert_array_equal(pt["hash_table"],
                                  np.asarray(pj["hash_table"]))
    np.testing.assert_array_equal(
        t_tp.unpad_table(pt, te)["hash_table"],
        np.asarray(j_unpad_table(pj, te)["hash_table"]))
    back_j = j_unpad_tree(padded_j, te, F, n_mp)
    back_t = t_tp.unpad_tree(padded_t, te, F, n_mp)
    for a, b, c in zip(jax.tree.leaves(back_j), jax.tree.leaves(back_t),
                       jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(b, c)


def test_block_collective_bytes_match_jax(runs):
    want = _jax_block_report(j_make_mesh_2d(2, 2))
    for out in runs["tp22"]:
        got = {k.split("/")[1]: int(v) for k, v in out.items()
               if k.startswith("collective/")}
        # departure: the nseg max, which JAX's accounting does not count
        assert got.pop("pmax") == 4 * 16
        assert got == want["per_block"]
        assert set(got) == {"psum", "all_gather", "reduce_scatter"}


def test_entry_point_trains_sharded_and_checks_the_layout(tmp_path):
    from arnerf_tpu_torch import train as t_train
    with pytest.raises(ValueError, match="--num_gpus must be a multiple "
                                         "of --model_parallel"):
        t_train.main(["--device", "cpu", "--num_gpus", "3",
                      "--model_parallel", "2"])
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "arnerf_tpu_torch.train", "--device", "cpu",
         "--num_gpus", "4", "--model_parallel", "2", "--dataset_name",
         "synthetic", "--downsample", "0.25", "--num_epochs", "1",
         "--steps_per_epoch", "32", "--batch_size", "256", "--exp_name",
         "tp", "--grid_size", "32", "--n_levels", "4",
         "--log2_hashmap_size", "12"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("test/psnr=") == 1
    j_cfg = JConfig(scale=0.5, grid_size=32, n_levels=4,
                    log2_hashmap_size=12)
    params, grid, _, step = j_load(
        str(tmp_path / "ckpts" / "synthetic" / "tp" / "epoch=0.npz"),
        params_template=j_init(jax.random.PRNGKey(0), j_cfg),
        grid_template=j_grid_init(j_cfg))
    assert step == 32 and int(np.asarray(grid.occ_flat).sum()) > 0
    assert params["hash_table"].shape == (j_cfg.hash_cfg.total_entries, F)
