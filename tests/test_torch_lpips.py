"""The port's LPIPS (arnerf_tpu_torch/training/lpips.py) and its threefry
draws (ops/threefry.py) against the JAX package on the CPU.

Threefry: PRNGKey, split, bits and uniform bit for bit against jax.random
under its defaults (threefry2x32, jax_threefry_partitionable), normals to
1e-6 (XLA's float32 log1p inside erfinv is its own polynomial, one ulp
away now and then). LPIPS: the random-feature weights equal JAX's
`lpips_params_random` (convolutions to 1e-6, lins exactly); the distance
at 64x64 equals `lpips_distance` to 1e-5 on JAX's own weights and on the
port's draws; the metric's axioms and the calibration's monotonicity
(tests/test_lpips.py, tests/test_lpips_calibration.py) hold for the port;
a vendored-weights file loads with the JAX key layout; and
`python -m arnerf_tpu_torch.train --eval_lpips` prints `test/lpips_rand=`.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from arnerf_tpu.training.lpips import (lpips_distance as j_distance,
                                       lpips_params_random as j_random)

from arnerf_tpu_torch.ops import threefry
from arnerf_tpu_torch.training import lpips as t_lpips
from arnerf_tpu_torch.training import lpips_calibration as t_calib
from arnerf_tpu_torch.training.metrics import LpipsValue, lpips

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789])
def test_threefry_keys_and_bits_match_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    k = threefry.prng_key(seed)
    np.testing.assert_array_equal(k, np.asarray(key))
    for n in (2, 3, 13):
        np.testing.assert_array_equal(threefry.split(k, n),
                                      np.asarray(jax.random.split(key, n)))
    a, b = jax.random.split(key)
    ka, kb = threefry.split(k)
    np.testing.assert_array_equal(ka, np.asarray(a))
    np.testing.assert_array_equal(kb, np.asarray(b))
    assert int(threefry.bits(k)) == int(jax.random.bits(key,
                                                        dtype=jnp.uint32))
    np.testing.assert_array_equal(
        threefry.bits(kb, (5, 7)),
        np.asarray(jax.random.bits(b, (5, 7), dtype=jnp.uint32)))
    np.testing.assert_array_equal(threefry.uniform(ka, (4096,)),
                                  np.asarray(jax.random.uniform(a, (4096,))))
    np.testing.assert_allclose(threefry.normal(kb, (3, 3, 8, 16)),
                               np.asarray(jax.random.normal(
                                   b, (3, 3, 8, 16))), rtol=0, atol=1e-6)


def test_threefry_normal_tails_within_1e6():
    key = jax.random.PRNGKey(42)
    t = threefry.normal(threefry.prng_key(42), (1 << 18,))
    j = np.asarray(jax.random.normal(key, (1 << 18,)))
    assert np.abs(j).max() > 4.0        # both erfinv branches
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def params():
    """(JAX's random-feature weights, the port's own draws)."""
    return j_random(0), t_lpips.lpips_params_random(0)


def _jax_as_port(jp):
    return t_lpips._to_params(
        [(np.asarray(c["w"]), np.asarray(c["b"])) for c in jp["convs"]],
        [np.asarray(l) for l in jp["lins"]], False, "cpu")


def test_random_weights_match_jax(params):
    jp, tp = params
    assert len(tp["convs"]) == 13 and len(tp["lins"]) == 5
    for jc, tc in zip(jp["convs"], tp["convs"]):
        np.testing.assert_allclose(
            tc["w"].numpy(), np.asarray(jc["w"]).transpose(3, 2, 0, 1),
            rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tc["b"].numpy(), np.asarray(jc["b"]))
    for jl, tl in zip(jp["lins"], tp["lins"]):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tp["trained"] is False


def _pair(seed=3, wh=64, noise=0.1):
    rng = np.random.default_rng(seed)
    img0 = rng.random((wh, wh, 3), np.float32)
    img1 = np.clip(img0 + noise * rng.standard_normal((wh, wh, 3),
                                                      np.float32), 0, 1)
    return img0, img1


@pytest.mark.parametrize("weights", ["jax", "port"])
def test_lpips_distance_matches_jax(params, weights):
    jp, tp = params
    if weights == "jax":
        tp = _jax_as_port(jp)
    img0, img1 = _pair()
    j = float(j_distance({"convs": jp["convs"], "lins": jp["lins"]},
                         jnp.asarray(img0), jnp.asarray(img1)))
    t = float(t_lpips.lpips_distance(tp, torch.from_numpy(img0),
                                     torch.from_numpy(img1)))
    assert j > 1e-4
    assert abs(t - j) <= 1e-5 * abs(j), (t, j)


def test_lpips_axioms(params):
    _, tp = params
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.random((24, 24, 3), np.float32))
    assert float(t_lpips.lpips_distance(tp, img, img)) < 1e-6
    small = torch.clamp(img + 0.02, 0, 1)
    large = torch.clamp(1.0 - img, 0, 1)
    d_small = float(t_lpips.lpips_distance(tp, img, small))
    d_large = float(t_lpips.lpips_distance(tp, img, large))
    assert 0 < d_small < d_large
    d_ab = float(t_lpips.lpips_distance(tp, img, large))
    d_ba = float(t_lpips.lpips_distance(tp, large, img))
    assert abs(d_ab - d_ba) <= 1e-6 * d_ab


def test_metric_wrapper_labels_and_vendored_weights(params, tmp_path,
                                                    monkeypatch):
    jp, _ = params
    img0, img1 = _pair(wh=32)
    v = lpips(torch.from_numpy(img0), torch.from_numpy(img1))
    assert isinstance(v, LpipsValue) and v.label == "lpips_rand"
    # the JAX package's key layout, loaded as trained weights
    blobs = {}
    for i, c in enumerate(jp["convs"]):
        blobs[f"conv{i}/w"] = np.asarray(c["w"])
        blobs[f"conv{i}/b"] = np.asarray(c["b"])
    for j, l in enumerate(jp["lins"]):
        blobs[f"lin{j}"] = np.asarray(l)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **blobs)
    loaded = t_lpips.lpips_params(str(path))
    assert loaded["trained"] is True
    for a, b in zip(loaded["convs"], _jax_as_port(jp)["convs"]):
        np.testing.assert_array_equal(a["w"].numpy(), b["w"].numpy())
    monkeypatch.setattr(t_lpips, "DEFAULT_WEIGHTS", str(path))
    from arnerf_tpu_torch.training import metrics
    monkeypatch.setattr(metrics, "_LPIPS_PARAMS", {})
    vt = lpips(torch.from_numpy(img0), torch.from_numpy(img1))
    assert vt.label == "lpips_vgg" and abs(float(vt) - float(v)) < 1e-4


@pytest.fixture(scope="module")
def calib():
    return t_calib.calibrate(wh=64)


def test_calibration_monotone_within_every_family(calib):
    for kind in t_calib.DISTORTIONS:
        assert calib[kind]["spearman_lpips_vs_strength"] == 1.0, \
            (kind, calib[kind]["lpips"])


def test_calibration_agrees_with_ssim_and_jax_distortions(calib):
    from arnerf_tpu.training import lpips_calibration as j_calib
    assert calib["cross_family_spearman_lpips_vs_1m_ssim"] >= 0.8
    img = t_calib.reference_image(32)
    np.testing.assert_allclose(img, j_calib.reference_image(32), atol=1e-6)
    for kind, strengths in t_calib.DISTORTIONS.items():
        np.testing.assert_array_equal(
            t_calib.distort(img, kind, strengths[2]),
            j_calib.distort(img, kind, strengths[2]))
    assert t_calib.spearman([1, 2, 3], [30, 20, 10]) == -1.0


def test_train_entry_point_prints_lpips_rand(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "arnerf_tpu_torch.train", "--device", "cpu",
         "--dataset_name", "synthetic", "--downsample", "0.25",
         "--num_epochs", "1", "--steps_per_epoch", "16", "--batch_size",
         "256", "--exp_name", "t", "--grid_size", "32", "--n_levels", "4",
         "--log2_hashmap_size", "12", "--eval_lpips", "--no_save_test"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if "test/psnr=" in ln][0]
    value = float(line.split("test/lpips_rand=")[1].split()[0])
    assert 0.0 < value < 10.0
