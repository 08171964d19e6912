"""The port's tools against the JAX package's on the CPU: the .orbax
refusal of training/ckpt.py, utils/profiling.py (MetricsLogger's JSONL,
device_trace, StepTimer), insert/pretabulate_fh.py, insert/fit_log_loss.py
and insert/train_brdf.py (the JAX package's scripts/train_brdf.py, loaded
from its file: scripts/ is not a package).

Tolerances: the F table and the log-loss fit exactly (the same numpy and
scipy code); the GGX kernel's SH projections to 1e-5 of their largest
magnitude (sums of 4,096 float32 terms, the sphere directions the same
draws); two BRDF regression steps from the same weights to 1e-4 of each
leaf's largest magnitude.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnerf_tpu.insert import fit_log_loss as j_fit_log_loss
from arnerf_tpu.insert import sg_shadow as j_sg_shadow
from arnerf_tpu_torch.insert import fit_log_loss as t_fit_log_loss
from arnerf_tpu_torch.insert import pretabulate_fh, sg_shadow, train_brdf
from arnerf_tpu_torch.training import ckpt
from arnerf_tpu_torch.utils.profiling import (MetricsLogger, StepTimer,
                                              device_trace)

REPO = Path(__file__).resolve().parent.parent


def test_orbax_checkpoints_are_refused_by_name(tmp_path):
    path = str(tmp_path / "epoch=0.orbax")
    with pytest.raises(ValueError, match="orbax checkpoints .* JAX format"):
        ckpt.save_ckpt(path, params={"hash_table": torch.zeros(2, 2)})
    os.makedirs(path)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_ckpt(path)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_ckpt(path + "/")


def test_metrics_logger_appends_jsonl(tmp_path, monkeypatch):
    """One JSON line a log() call, appended across loggers; only the JSONL
    where torch.utils.tensorboard does not import."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricsLogger(str(tmp_path / "logs"))
    log.log(0, {"loss": torch.tensor(0.5), "psnr": 12.0})
    log.log(100, {"loss": np.float32(0.25)})
    log.close()
    log = MetricsLogger(str(tmp_path / "logs"))       # appends
    log.log(200, {"loss": 0.125})
    log.close()
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x) for x in lines] == [
        {"step": 0, "loss": 0.5, "psnr": 12.0}, {"step": 100, "loss": 0.25},
        {"step": 200, "loss": 0.125}]
    assert os.listdir(tmp_path / "logs") == ["metrics.jsonl"]


def test_metrics_logger_writes_tensorboard_events_when_it_imports(
        tmp_path):
    """As JAX's MetricsLogger: TensorBoard events beside the JSONL whenever
    torch.utils.tensorboard imports (here at the first log())."""
    pytest.importorskip("torch.utils.tensorboard")
    log = MetricsLogger(str(tmp_path))
    log.log(0, {"loss": 0.5})
    log.close()
    assert any(p.name.startswith("events.out.tfevents")
               for p in tmp_path.iterdir())
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == \
        {"step": 0, "loss": 0.5}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(64, 64)
    with device_trace(str(tmp_path / "tr")) as prof:
        with torch.profiler.record_function("my_span"):
            (a @ a).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "my_span" in names and "aten::mm" in names
    assert any(k.key == "my_span" for k in prof.key_averages())
    timer = StepTimer(alpha=0.5)
    for _ in range(3):
        with timer:
            pass
    assert timer.ema is not None and timer.fps > 0


def test_pretabulate_fh_writes_the_table(tmp_path, capsys, monkeypatch):
    """main() at a small quadrature (its compute_fh_table cut to 16 x 32 x
    8) writes what compute_fh_table gives, through the atomic write."""
    out = tmp_path / "fh.npy"
    monkeypatch.setattr(pretabulate_fh, "compute_fh_table",
                        lambda: sg_shadow.compute_fh_table(16, 32, 8))
    res = pretabulate_fh.main(["--out", str(out)])
    tab = np.load(out)
    assert tab.shape == (32, 16) == res["shape"]
    np.testing.assert_array_equal(tab, sg_shadow.compute_fh_table(16, 32, 8))
    np.testing.assert_array_equal(tab,
                                  j_sg_shadow.compute_fh_table(16, 32, 8))
    assert "saved (32, 16) table" in capsys.readouterr().out
    assert os.listdir(tmp_path) == ["fh.npy"]      # the temporary renamed


def test_fit_log_loss_is_jax_fit():
    np.testing.assert_array_equal(t_fit_log_loss.fit(256),
                                  j_fit_log_loss.fit(256))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_brdf", REPO / "scripts" / "train_brdf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ggx_kernel_sh_is_the_jax_scripts():
    script = _jax_script()
    rng = np.random.default_rng(0)
    n = rng.standard_normal((8, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.standard_normal((8, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    rough = rng.uniform(0.08, 1.0, (8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = script.ggx_kernel_sh(jnp.asarray(n), jnp.asarray(v),
                                jnp.asarray(rough), key)
    got = train_brdf.ggx_kernel_sh(torch.from_numpy(n), torch.from_numpy(v),
                                   torch.from_numpy(rough), np.asarray(key))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_two_train_brdf_steps_are_the_jax_scripts(tmp_path, monkeypatch,
                                                  capsys):
    """The JAX script's main for 2 steps from the port's initial weights
    (its mlp_skip_init patched to return them) against the port's train."""
    _, input_ch = train_brdf.get_embedder(3)
    params = train_brdf.mlp_skip_init(torch.Generator().manual_seed(42),
                                      input_ch * 2 + 1, 18, D=2, W=128)
    script = _jax_script()
    carried = {"layers": [{"w": jnp.asarray(lay["w"].numpy()),
                           "b": jnp.asarray(lay["b"].numpy())}
                          for lay in params["layers"]], "skips": ()}
    monkeypatch.setattr(script, "mlp_skip_init", lambda *a, **k: carried)
    out = tmp_path / "jax.npz"
    monkeypatch.setattr(sys, "argv", ["train_brdf.py", "--steps", "2",
                                      "--out", str(out)])
    script.main()
    j_loss = float(capsys.readouterr().out.split("loss=")[1].split()[0])
    params, losses = train_brdf.train(2, "cpu", params=params, log_every=0)
    assert losses[0] == pytest.approx(j_loss, abs=1e-5)   # printed .5f
    train_brdf.save(params, str(tmp_path / "port.npz"))
    with np.load(out) as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files) == [
            "b_0", "b_1", "b_2", "w_0", "w_1", "w_2"]
        for k in j.files:
            np.testing.assert_allclose(t[k], j[k], rtol=0,
                                       atol=1e-4 * np.abs(j[k]).max())


def test_train_brdf_entry_point(tmp_path, capsys):
    """It writes the port's model_brdf3.npz by default, runs on the card
    unless asked for the CPU, and lowers the loss."""
    assert Path(train_brdf.OUT) == REPO / "arnerf_tpu_torch" / "insert" / \
        "data" / "model_brdf3.npz"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_brdf.main(["--steps", "1", "--out", str(tmp_path / "x")])
    out = tmp_path / "brdf.npz"
    res = train_brdf.main(["--steps", "8", "--out", str(out), "--device",
                           "cpu"])
    assert res["losses"][-1] < res["losses"][0]
    with np.load(out) as f:
        assert f["w_0"].shape == (2 * train_brdf.get_embedder(3)[1] + 1,
                                  128)
    assert "saved neural BRDF" in capsys.readouterr().out
