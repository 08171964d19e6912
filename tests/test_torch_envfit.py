"""The port's amortised SG fitter (arnerf_tpu_torch/insert/envfit.py:
threefry.permutation, sg_net_init, SGFittingNet, EnvTrainer) and
NGPInsertor.generate_envmaps against the JAX package's on the CPU.

The fitter runs at a small width (4 SGs instead of 32, a few maps) at the
full 128x128 map size its linear layer needs. The weights and the batch
order are the JAX package's draws, reproduced. Tolerances: the draws
bit for bit; the initial weights to 1e-6 (XLA's erfinv against the port's
emulation of it, one ulp); the forward to 1e-5 of the output's largest
magnitude; three Adam steps to 1e-4 relative in each leaf's Frobenius
norm. An elementwise bound would not hold: Adam's first steps move every
weight by about lr whatever its gradient's size, so the few weights whose
gradient is near eps (1e-8) take float32 rounding noise to lr's scale (one
weight in ~3e5 here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnerf_tpu.insert import envfit as j_envfit
from arnerf_tpu_torch.insert import envfit as t_envfit
from arnerf_tpu_torch.ops import threefry

N_SG = 4


def _jax_flat(params):
    return {k: np.asarray(v) for k, v in j_envfit.EnvTrainer._flatten(
        {k: v for k, v in params.items() if k != "n_sg"}).items()}


def _rel_frobenius(got, want):
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-30)) for k in want}


def _maps(n, seed=0):
    """Smooth env maps: the SG renders of random SGs, plus noise."""
    rng = np.random.default_rng(seed)
    sgs = rng.standard_normal((n, 6, 7)).astype(np.float32)
    sgs[..., 3] = np.abs(sgs[..., 3]) * 10
    ims = t_envfit.sg2envmap(torch.from_numpy(sgs), 128, 128).numpy()
    return (ims + 0.05 * rng.random(ims.shape)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 16, 512, 2000])
def test_permutation_is_jax_permutation(n):
    for seed in (0, 1, 42):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            threefry.permutation(np.asarray(key), n),
            np.asarray(jax.random.permutation(key, n)))
    # the rounds of jax's shuffle: one below ~1,600 items, two at 2,000
    rounds = int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1)))
    assert rounds == (0 if n == 1 else 1 if n < 1600 else 2)


def test_uniform_on_a_device_is_jax_uniform():
    key = jax.random.PRNGKey(5)
    for lo, hi in ((0.0, 1.0), (0.08, 1.0), (-3.0, 2.5)):
        want = np.asarray(jax.random.uniform(key, (64, 33), minval=lo,
                                             maxval=hi))
        np.testing.assert_array_equal(
            threefry.uniform(np.asarray(key), (64, 33), lo, hi), want)
        np.testing.assert_array_equal(threefry.uniform(
            np.asarray(key), (64, 33), lo, hi, device="cpu").numpy(), want)


def test_sg_net_init_is_jax_init():
    key = jax.random.PRNGKey(3)
    want = _jax_flat(j_envfit.sg_net_init(key, N_SG))
    got = t_envfit.sg_net_init(np.asarray(key), N_SG)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    # and through the weights carried across and back
    net = t_envfit.sg_net_from_jax(j_envfit.sg_net_init(key, N_SG))
    back = t_envfit.sg_net_to_jax(net)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_sg_fitting_net_is_sg_net_apply():
    params = j_envfit.sg_net_init(jax.random.PRNGKey(1), N_SG)
    im = np.random.default_rng(2).random((2, 128, 128, 3)).astype(
        np.float32)
    want = np.asarray(j_envfit.sg_net_apply(params, jnp.asarray(im)))
    got = t_envfit.sg_net_from_jax(params)(torch.from_numpy(im))
    assert tuple(got.shape) == (2, N_SG, 7)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_env_trainer_steps_are_jax_steps():
    """One epoch of 5 maps at batch 2: the key split, the permutation,
    batches of 2, 2 and 1 (the partial last one), three Adam steps."""
    key = jax.random.PRNGKey(7)
    maps = _maps(5)
    j_tr = j_envfit.EnvTrainer(maps, N_SG, key=key)
    t_tr = t_envfit.EnvTrainer(maps, N_SG, key=np.asarray(key))
    j_loss = j_tr.train(epochs=1, batch_size=2)
    t_loss = t_tr.train(epochs=1, batch_size=2)
    assert [o.count for o in t_tr._adam][:1] == [3]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-4)
    np.testing.assert_array_equal(t_tr.key, np.asarray(j_tr.key))
    errs = _rel_frobenius(t_envfit.sg_net_to_jax(t_tr.params),
                          _jax_flat(j_tr.params))
    assert max(errs.values()) < 1e-4, errs
    # eval: one map's SGs
    want = np.asarray(j_tr.eval(maps[0]))
    got = t_tr.eval(maps[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_learning_rate_halves_every_100_updates_as_in_jax():
    """The step is -lr * 0.5^(count // 100), count the updates so far
    (not the epoch): the JAX optimizer's update at count 100 against the
    port's, from the same moments and gradient."""
    maps = _maps(1)
    j_tr = j_envfit.EnvTrainer(maps, N_SG)
    t_tr = t_envfit.EnvTrainer(maps, N_SG)
    for c in (0, 99, 100, 250):
        assert t_tr._schedule(c) == 4e-4 * 0.5 ** (c // 100)
    p = {k: v for k, v in j_tr.params.items() if k != "n_sg"}
    g = jax.tree.map(lambda v: jnp.full_like(v, 0.5), p)
    adam, sched = j_tr.opt_state
    count = jnp.asarray(100, jnp.int32)
    state = (adam._replace(count=count), sched._replace(count=count))
    updates, _ = j_tr.tx.update(g, state, p)
    opt = t_envfit.Adam(t_tr.params.conv1.bias.detach(), t_tr._schedule)
    opt.count = 100
    got = opt.update(torch.full_like(opt.mu, 0.5))
    want = float(np.asarray(updates["conv1"]["b"])[0])
    assert got[0].item() == pytest.approx(want, rel=1e-6)
    # count 100: lr / 2 times the bias-corrected first step of 101 updates
    mu_hat = 0.1 * 0.5 / (1 - 0.9 ** 101)
    nu_hat = 0.001 * 0.25 / (1 - 0.999 ** 101)
    assert want == pytest.approx(-2e-4 * mu_hat / (nu_hat ** 0.5 + 1e-8),
                                 rel=1e-5)


def test_checkpoints_cross_between_the_packages(tmp_path):
    maps = _maps(3, seed=1)
    key = jax.random.PRNGKey(2)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_tr = j_envfit.EnvTrainer(maps, N_SG, key=key)
    j_tr.train(epochs=1, batch_size=2, ckpt_dir=j_dir)
    assert os.listdir(j_dir) == ["env_model_000001.npz"]
    # the port resumes JAX's checkpoint: epoch 1 of 1, nothing to train
    t_tr = t_envfit.EnvTrainer(maps, N_SG, key=np.asarray(key))
    assert t_tr.train(epochs=1, ckpt_dir=j_dir) == float("inf")
    got = t_envfit.sg_net_to_jax(t_tr.params)
    for k, v in _jax_flat(j_tr.params).items():
        np.testing.assert_array_equal(got[k], v)
    # and JAX resumes the port's
    t_tr = t_envfit.EnvTrainer(maps, N_SG, key=np.asarray(key))
    t_tr.train(epochs=2, batch_size=2, ckpt_dir=t_dir, ckpt_every=1)
    assert sorted(os.listdir(t_dir)) == ["env_model_000001.npz",
                                         "env_model_000002.npz"]
    j_tr = j_envfit.EnvTrainer(maps, N_SG, key=key)
    j_tr.train(epochs=2, ckpt_dir=t_dir)
    want = t_envfit.sg_net_to_jax(t_tr.params)
    for k, v in _jax_flat(j_tr.params).items():
        np.testing.assert_array_equal(v, want[k])


def test_generate_envmaps_matches_jax(tmp_path, monkeypatch):
    from arnerf_tpu_torch.insert import sg_shadow as t_sg_shadow
    from tests.test_torch_insertor import FH_PRETAB, TOL, build_pair
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_sg_shadow, "get_fh_table",
                        lambda: np.load(FH_PRETAB))
    j_ins, t_ins = build_pair(monkeypatch)
    for ins in (j_ins, t_ins):
        ins.global_sh = ins.global_sh * 0 + 0.3
        ins.generate_envmaps(env_num=3)
    j_maps = np.load(os.path.join(j_ins.gen_path, "envmaps.npy"))
    t_path = os.path.join(t_ins.gen_path, "envmaps.npy")
    t_maps = np.load(t_path)
    assert t_maps.shape == (3, 128, 128, 3) and t_maps.dtype == np.float32
    np.testing.assert_allclose(t_maps, j_maps, rtol=0, atol=TOL)
    # a second call keeps the file; the fitter trains on the maps
    t_ins.generate_envmaps(env_num=3)
    import arnerf_tpu_torch.insert.main as t_main
    monkeypatch.setattr(t_main, "EnvTrainer",
                        lambda maps, **kw: t_envfit.EnvTrainer(
                            maps, output_sg_num=N_SG, **kw))
    model = t_ins.load_or_train_envmaps(epochs=1)
    assert tuple(model.eval(t_maps[0]).shape) == (N_SG, 7)
