"""ARNERF_AUTO_RESUME and the crash-durable snapshot (NeRFTrainer.fit's
disk_snapshot, the train entry point) against the JAX package's on the CPU,
at the tiny configuration of tests/test_torch_train.py.

A snapshot written by the JAX trainer's _write_disk_snapshot resumes the
port's entry point with its parameters, grid, Adam leaves and step, bit for
bit; a port snapshot loads in the JAX trainer's load. A run stopped after a
snapshot resumes at its step and removes the file at its end;
--weight_path and --ckpt_path are not overridden by a snapshot (the JAX
CLI resumes over --weight_path: the departure ROADMAP.md records); a
non-finite loss leaves the last good snapshot; two gloo ranks with the
table sharded (--model_parallel 2) write one unpadded snapshot.
"""

import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_init as j_init)
from arnerf_tpu.training.trainer import (NeRFTrainer as JTrainer,
                                         TrainConfig as JTrainConfig,
                                         make_optimizer as j_make_opt)

from arnerf_tpu_torch import train as t_train
from arnerf_tpu_torch.training import trainer as t_trainer
from arnerf_tpu_torch.training.ckpt import params_from_jax, tree_leaves

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SMALL_FLAGS = ["--grid_size", "32", "--n_levels", "4",
               "--log2_hashmap_size", "12"]
J_CFG = JConfig(scale=0.5, grid_size=32, n_levels=4, log2_hashmap_size=12)


def _argv(steps=64, exp="r", *extra, downsample="1.0"):
    return ["--device", "cpu", "--dataset_name", "synthetic",
            "--downsample", downsample, "--num_epochs", "1",
            "--steps_per_epoch", str(steps), "--batch_size", "256",
            "--exp_name", exp, "--no_save_test", *SMALL_FLAGS, *extra]


def _snap_path(tmp_path, exp="r"):
    return tmp_path / "ckpts" / "synthetic" / exp / "snapshot.npz"


@pytest.fixture(autouse=True)
def small_scene(monkeypatch):
    """The synthetic scene at 24x24 with one test view (as
    test_torch_train's trainer has it): the entry point's validation
    renders are most of a tiny run's time."""
    import arnerf_tpu_torch.datasets as t_dsets
    from arnerf_tpu_torch.datasets.synthetic import SyntheticConfig
    orig = t_dsets.dataset_dict["synthetic"]
    monkeypatch.setitem(t_dsets.dataset_dict, "synthetic", lambda **kw: orig(
        config=SyntheticConfig(img_wh=(24, 24), n_train=6, n_test=1,
                               gt_samples=64), **kw))


@pytest.fixture
def at_fit(monkeypatch):
    """The trainer's state as each fit() call starts."""
    seen = []
    orig = t_trainer.NeRFTrainer.fit

    def fit(self, *a, **kw):
        seen.append({
            "step": self.step,
            "generator": self.generator.get_state().clone(),
            "params": [p.detach().clone().numpy()
                       for p in tree_leaves(self.params)],
            "opt": [np.array(v) if not torch.is_tensor(v)
                    else v.clone().numpy() for v in self.opt.state_leaves()],
            "grid": {k: v.clone().numpy()
                     for k, v in self.grid_state._asdict().items()}})
        return orig(self, *a, **kw)

    monkeypatch.setattr(t_trainer.NeRFTrainer, "fit", fit)
    return seen


def _jax_snapshot(path, step):
    """A snapshot written by the JAX trainer's _write_disk_snapshot: moved
    parameters, Adam moments and grid, at `step`."""
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda v: np.asarray(v) + rng.normal(0, 1e-2, v.shape).astype(
            v.dtype), j_init(jax.random.PRNGKey(0), J_CFG))
    tx, _ = j_make_opt(JTrainConfig(batch_size=256, num_epochs=1,
                                    steps_per_epoch=64))
    leaves, treedef = jax.tree.flatten(tx.init(params))
    leaves = [np.asarray(step, np.int32) if np.ndim(v) == 0 else
              np.abs(rng.normal(0, 1e-3, v.shape)).astype(np.float32)
              for v in leaves]
    grid = j_grid_init(J_CFG)._replace(
        density_grid=rng.random((1, 32 ** 3)).astype(np.float32),
        occ_flat=(rng.random(32 ** 3) < 0.3).astype(np.uint8))
    stub = types.SimpleNamespace(
        _snap=(params, jax.tree.unflatten(treedef, leaves), grid),
        _snap_step=step, _n_mp=1, cfg=J_CFG)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    JTrainer._write_disk_snapshot(stub, str(path))


def test_jax_snapshot_resumes_the_port_entry_point(tmp_path, monkeypatch,
                                                   capsys, at_fit):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARNERF_AUTO_RESUME", "1")
    snap = _snap_path(tmp_path)
    _jax_snapshot(snap, 32)
    with np.load(snap) as f:
        blob = dict(f)
    t_train.main(_argv(48))
    assert "auto-resume: snapshot at step 32" in capsys.readouterr().out
    got = at_fit[0]
    assert got["step"] == 32
    want = [t.numpy() for t in tree_leaves(params_from_jax(blob))]
    assert len(got["params"]) == len(want) == sum(
        k.startswith("params/") for k in blob)
    for a, b in zip(got["params"], want):
        np.testing.assert_array_equal(a, b)
    n = int(blob["opt_n_leaves"])
    assert len(got["opt"]) == n
    for i in range(n):
        np.testing.assert_array_equal(got["opt"][i], blob[f"opt/{i}"])
    for k, v in got["grid"].items():
        np.testing.assert_array_equal(v, blob[f"grid/{k}"])
    # the run completed: the snapshot is gone, the checkpoint at step 48
    assert not snap.exists()
    with np.load(tmp_path / "ckpts" / "synthetic" / "r" / "epoch=0.npz") \
            as f:
        assert int(f["step"]) == 48


def test_port_snapshot_loads_in_the_jax_trainer(tmp_path):
    from tests.test_torch_train import _tiny_trainer
    tr = _tiny_trainer()
    path = tmp_path / "snapshot.npz"
    tr.fit(n_steps=32, log_every=0, disk_snapshot=str(path),
           snapshot_every_blocks=1)
    tx, _ = j_make_opt(JTrainConfig(batch_size=128, num_epochs=1,
                                    steps_per_epoch=64, warmup_steps=16))
    params = j_init(jax.random.PRNGKey(0), JConfig(scale=0.5, grid_size=32,
                                                   n_levels=4,
                                                   log2_hashmap_size=12,
                                                   base_resolution=4))
    stub = types.SimpleNamespace(params=params, opt_state=tx.init(params),
                                 grid_state=j_grid_init(J_CFG), _n_mp=1,
                                 cfg=J_CFG)
    JTrainer.load(stub, str(path))
    assert stub.step == 32
    for a, b in zip(jax.tree.leaves(stub.params), tree_leaves(tr.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
    o = jax.tree.leaves(stub.opt_state)
    assert int(o[0]) == 32 and int(o[-1]) == 32
    for a, b in zip(o[1:-1], tr.opt.mu + tr.opt.nu):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(stub.grid_state.density_grid),
                                  tr.grid_state.density_grid.numpy())


class _Stop(Exception):
    pass


def test_stopped_run_resumes_at_its_snapshot(tmp_path, monkeypatch, capsys,
                                             at_fit):
    """Snapshots every block; the run stops at step 48 (after that block's
    snapshot), the next run resumes there, ends at 64 and removes the
    file; its ray draws start from a seed of the step, not the run's."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARNERF_AUTO_RESUME", "1")
    orig = t_trainer.NeRFTrainer.fit
    monkeypatch.setattr(
        t_trainer.NeRFTrainer, "fit",
        lambda self, *a, **kw: orig(self, *a, **dict(
            kw, snapshot_every_blocks=1)))
    snap = _snap_path(tmp_path)

    def stop_at_48(step, metrics, trainer):
        if step == 48:
            raise _Stop()

    with pytest.raises(_Stop):
        t_train.main(_argv(64), callback=stop_at_48)
    with np.load(snap) as f:
        assert int(f["step"]) == 48
    steps = []
    t_train.main(_argv(64), callback=lambda s, m, tr: steps.append(s))
    assert "auto-resume: snapshot at step 48" in capsys.readouterr().out
    assert at_fit[-1]["step"] == 48 and steps == [64]
    # the resumed run's ray draws are reseeded from the step
    assert not torch.equal(at_fit[-1]["generator"], at_fit[0]["generator"])
    assert not snap.exists()
    with np.load(tmp_path / "ckpts" / "synthetic" / "r" / "epoch=0.npz") \
            as f:
        assert int(f["step"]) == 64
        assert all(np.isfinite(f[k]).all() for k in f.files
                   if k.startswith("params/"))


@pytest.mark.parametrize("flag", ["--weight_path", "--ckpt_path"])
def test_weight_and_ckpt_paths_are_not_overridden(tmp_path, monkeypatch,
                                                  capsys, at_fit, flag):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ARNERF_AUTO_RESUME", "1")
    snap = _snap_path(tmp_path)
    _jax_snapshot(snap, 32)
    given = tmp_path / "given.npz"               # the weights to load
    _jax_snapshot(given, 16)
    with np.load(given) as f:
        table = f["params/hash_table"] + 1.0
    with np.load(given) as f:
        np.savez(given, **dict(f, **{"params/hash_table": table}))
    t_train.main(_argv(32, "r", flag, str(given)))
    assert "auto-resume" not in capsys.readouterr().out
    got = at_fit[-1]
    assert got["step"] == (0 if flag == "--weight_path" else 16)
    with np.load(given) as f:
        keys = sorted(k for k in f.files if k.startswith("params/"))
    np.testing.assert_array_equal(
        got["params"][keys.index("params/hash_table")], table)


def test_non_finite_loss_leaves_the_last_good_snapshot(tmp_path,
                                                       monkeypatch):
    from tests.test_torch_train import _tiny_trainer
    tr = _tiny_trainer()
    orig = t_trainer.NeRFTrainer.train_block

    def block(self):
        out = orig(self)
        if self.step == 48:
            out = dict(out, loss=torch.tensor(float("nan")))
        return out

    monkeypatch.setattr(t_trainer.NeRFTrainer, "train_block", block)
    path = tmp_path / "snapshot.npz"
    with pytest.raises(FloatingPointError, match="step 48"):
        tr.fit(n_steps=64, log_every=0, disk_snapshot=str(path),
               snapshot_every_blocks=1)
    with np.load(path) as f:
        assert int(f["step"]) == 32
        assert all(np.isfinite(f[k]).all() for k in f.files)


def test_two_sharded_ranks_write_one_loadable_snapshot(tmp_path):
    """--num_gpus 2 --model_parallel 2 on gloo ranks: the snapshot fit
    writes as it starts is rank 0's one file, with the table gathered and
    unpadded; the JAX trainer loads it. The run is stopped (SIGKILL to its
    process group) once the file is there."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               ARNERF_AUTO_RESUME="1")
    argv = [sys.executable, "-m", "arnerf_tpu_torch.train", *_argv(
        4096, "tp", "--num_gpus", "2", "--model_parallel", "2",
        downsample="0.25")]
    proc = subprocess.Popen(argv, cwd=tmp_path, env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    snap = _snap_path(tmp_path, "tp")
    deadline = time.monotonic() + 180
    try:
        while not snap.exists() and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.2)
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
    assert snap.exists(), out[-3000:]
    assert os.listdir(snap.parent) == ["snapshot.npz"]
    tx, _ = j_make_opt(JTrainConfig(batch_size=256, num_epochs=1,
                                    steps_per_epoch=4096))
    params = j_init(jax.random.PRNGKey(0), J_CFG)
    stub = types.SimpleNamespace(params=params, opt_state=tx.init(params),
                                 grid_state=j_grid_init(J_CFG), _n_mp=1,
                                 cfg=J_CFG)
    JTrainer.load(stub, str(snap))
    assert stub.step == 0
    assert stub.params["hash_table"].shape == \
        (J_CFG.hash_cfg.total_entries, J_CFG.hash_cfg.n_features)
