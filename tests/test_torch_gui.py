"""The port's viewer (arnerf_tpu_torch/show_gui.py) against the repository's
show_gui.py (the JAX viewer) on the CPU.

- OrbitCamera after a scripted orbit/scale/pan sequence, to 1e-12.
- NGPGUI.render_cam on one JAX-written checkpoint (a small NGP: the JAX
  NGPGUI is given the same sizes by patching the NGPConfig it builds):
  the network frame of an LDR, a --use_exposure (at exposures 1 and 8)
  and a --use_EXR model, and its depth view, against the JAX NGPGUI's
  to 1e-4 (test_torch_render.py's tolerance); the depth view's turbo
  colours are uint8 levels of the normalised depth, so a level may flip
  at a few pixels where the depths agree to 1e-4.
- The baked frame (a 16^3 bake, as tests/test_gui.py does). The colour
  frame is stochastic and departs from the JAX viewer's on purpose: JAX's
  baked_frame_display_fn passes the frame key to every bucket, the port
  splits it per bucket as render_baked does. So the port's frame equals
  JAX's render_baked(display=True) with the frame key, and JAX's
  baked_frame_display_fn with split(key, 1)[0] where there is one bucket;
  test_display_frame_splits_the_key_per_bucket pins the departure at
  several buckets. The baked depth view goes through render_baked in both
  viewers and is held against the JAX NGPGUI's directly.
- refresh_bake, run_dearpygui behind a stub dearpygui module, and the
  `python -m arnerf_tpu_torch.show_gui` entry point in-process.
"""

import functools
import sys
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import arnerf_tpu.models as j_models
from arnerf_tpu import rendering_baked as jrb
from arnerf_tpu.datasets.ray_utils import (get_ray_directions as
                                           j_directions, get_rays as j_rays)
from arnerf_tpu.models import (NGPConfig as JConfig, grid_state_init as
                               j_grid_init, ngp_init as j_init)
from arnerf_tpu.opt import get_opts as j_opts
from arnerf_tpu.training.ckpt import save_ckpt as j_save

from arnerf_tpu_torch import rendering_baked as trb
from arnerf_tpu_torch import show_gui as t_gui
from arnerf_tpu_torch.datasets.synthetic import analytic_occupancy
from arnerf_tpu_torch.ops import threefry
from arnerf_tpu_torch.opt import get_opts as t_opts

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import show_gui as j_gui  # noqa: E402  (the repository's JAX viewer)

torch.set_num_threads(2)

G = 32
SIZES = dict(grid_size=G, n_levels=4, log2_hashmap_size=12)
SIZE_FLAGS = ["--grid_size", "32", "--n_levels", "4",
              "--log2_hashmap_size", "12"]
K64 = np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]])
TOL = 1e-4
HDR_FLAGS = {"ldr": [], "exposure": ["--use_exposure"],
             "exr": ["--use_EXR"]}


def _write_ckpt(path, kind="ldr"):
    """A JAX-initialised small NGP with the analytic occupancy and a ball
    of EMA density, written by the JAX package."""
    cfg = JConfig(scale=0.5, rgb_act="Sigmoid" if kind == "ldr" else "None",
                  use_raw_hdr=kind == "exr", **SIZES)
    params = j_init(jax.random.PRNGKey(1), cfg)
    occ = analytic_occupancy(0.5, G, 1).numpy()
    state = j_grid_init(cfg)._replace(
        occ_flat=jnp.asarray(occ),
        density_grid=jnp.asarray(occ.astype(np.float32)[None] * 4.0))
    j_save(str(path), params=params, grid_state=state)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("gui")
    return {kind: _write_ckpt(d / f"{kind}.npz", kind) for kind in HDR_FLAGS}


@pytest.fixture
def small_jax_config(monkeypatch):
    """The JAX NGPGUI builds NGPConfig(scale, rgb_act, use_raw_hdr) at the
    full width; give it the checkpoint's sizes."""
    monkeypatch.setattr(j_models, "NGPConfig",
                        functools.partial(JConfig, **SIZES))


def _guis(ckpt, kind="ldr", baked=False):
    """The JAX and the port's viewer on `ckpt`, the camera moved alike.
    `baked` is the port's; the JAX viewer's bake (256^3 at startup) is set
    by the tests at 16^3."""
    flags = ["--dataset_name", "synthetic", "--ckpt_path", ckpt] \
        + HDR_FLAGS[kind]
    jg = j_gui.NGPGUI(j_opts(flags), K64, (64, 64), baked=False)
    tg = t_gui.NGPGUI(t_opts(flags + ["--device", "cpu"] + SIZE_FLAGS),
                      K64, (64, 64), baked=baked)
    for g in (jg, tg):
        g.cam.orbit(120, -40)
        g.cam.scale(0.5)
    return jg, tg


def _to_port(jb):
    kw = {k: None if getattr(jb, k) is None
          else torch.from_numpy(np.array(getattr(jb, k)))
          for k in ("rows", "aabb_lo", "aabb_hi", "mip", "sigma", "row_index",
                    "rows_q", "sigma_bricks", "mip_dist")}
    return trb.BakedField(resolution=jb.resolution, scale=jb.scale,
                          cascades=jb.cascades, **kw)


def _assert_depth_views_close(t_img, j_img, max_flips):
    """Turbo depth views: equal but for at most `max_flips` pixels, where
    the normalised depth's uint8 level flipped (one turbo step)."""
    diff = np.abs(t_img - j_img).max(axis=-1)
    assert int((diff > 1e-6).sum()) <= max_flips, int((diff > 1e-6).sum())
    assert float(diff.max()) < 0.05


def test_orbit_camera_matches_jax():
    t = t_gui.OrbitCamera(K64, (64, 64), r=2.5)
    j = j_gui.OrbitCamera(K64, (64, 64), r=2.5)
    steps = [("orbit", (100, 0)), ("orbit", (-35, 60)), ("scale", (1,)),
             ("pan", (10, -5)), ("orbit", (7, -300)), ("scale", (-2.5,)),
             ("pan", (-40, 3, 12)), ("orbit", (900, 45))]
    for name, args in steps:
        getattr(t, name)(*args)
        getattr(j, name)(*args)
        np.testing.assert_allclose(t.pose, j.pose, rtol=0, atol=1e-12)
    assert not np.allclose(t.pose[:3, :3], np.eye(3))
    np.testing.assert_allclose(t.pose[:3, :3] @ t.pose[:3, :3].T, np.eye(3),
                               atol=1e-12)


@pytest.mark.parametrize("kind,exposure", [("ldr", 1.0), ("exposure", 1.0),
                                           ("exposure", 8.0), ("exr", 1.0)])
def test_network_frame_matches_jax(ckpts, small_jax_config, kind, exposure):
    jg, tg = _guis(ckpts[kind], kind)
    jg.exposure = tg.exposure = exposure
    t_img, j_img = tg.render_cam(tg.cam), jg.render_cam(jg.cam)
    assert t_img.shape == (64, 64, 3) and t_img.dtype == np.float32
    np.testing.assert_allclose(t_img, j_img, atol=TOL, rtol=0)
    assert tg.mean_samples == jg.mean_samples > 0
    assert tg.dt > 0 and float(t_img.max()) > 0.05
    tg.img_mode = jg.img_mode = 1
    _assert_depth_views_close(tg.render_cam(tg.cam), jg.render_cam(jg.cam),
                              max_flips=8)


def _gui_rays(cam):
    d = jnp.asarray(j_directions(cam.H, cam.W, cam.K))
    return j_rays(d, jnp.asarray(cam.pose[:3], jnp.float32))


def test_baked_frame_matches_jax(ckpts, small_jax_config):
    jg, tg = _guis(ckpts["ldr"])
    jg.baked = jrb.bake_ngp(jg.params, jg.grid_state, jg.cfg, resolution=16,
                            n_dirs=8)
    own = trb.bake_ngp(tg.params, tg.grid_state, tg.cfg, resolution=16,
                       n_dirs=8)
    np.testing.assert_allclose(own.rows.numpy(), np.asarray(jg.baked.rows),
                               atol=1e-5 * float(np.abs(jg.baked.rows).max()))
    np.testing.assert_array_equal(own.sigma_bricks.numpy(),
                                  np.asarray(jg.baked.sigma_bricks))
    # render the same bake in both viewers
    tg.baked = _to_port(jg.baked)
    ro, rd = _gui_rays(tg.cam)
    t_img = tg.render_cam(tg.cam)
    key = jax.random.PRNGKey(1)         # frame 1
    ref = jrb.render_baked(jg.baked, None, ro, rd, jg.cfg, key=key,
                           T_threshold=1e-2, color_window=4,
                           img_wh=(64, 64), display=True, white_bg=0.0)
    want = np.asarray(ref["rgb_u8"], np.float32).reshape(64, 64, 3) / 255
    np.testing.assert_array_equal(t_img, want)
    assert float(t_img.max()) > 0.05
    # one bucket: JAX's frame function with the key the port gives it
    jframe = jrb.baked_frame_display_fn(jg.baked, ro, rd, T_threshold=1e-2,
                                        color_window=4, img_wh=(64, 64),
                                        white_bg=0.0)
    one = np.asarray(jframe(jax.random.split(key, 1)[0]), np.float32)
    np.testing.assert_array_equal(t_img, one.reshape(64, 64, 3) / 255)
    # the depth view: render_baked in both viewers, frame 2's key
    tg.img_mode = jg.img_mode = 1
    jg._frame = 1
    _assert_depth_views_close(tg.render_cam(tg.cam), jg.render_cam(jg.cam),
                              max_flips=8)
    assert tg._frame == jg._frame == 2


def test_display_frame_splits_the_key_per_bucket(ckpts, small_jax_config):
    """Four buckets: the port's frame(key) equals render_baked(display)
    with the key, bucket for bucket, and differs from JAX's frame function,
    which gives every bucket the one key."""
    jg, _ = _guis(ckpts["ldr"])
    jb = jrb.bake_ngp(jg.params, jg.grid_state, jg.cfg, resolution=16,
                      n_dirs=8)
    cam = j_gui.OrbitCamera(K64 * [[2], [2], [1]], (128, 128), r=1.6)
    ro, rd = _gui_rays(cam)
    key = jax.random.PRNGKey(5)
    kw = dict(T_threshold=1e-2, color_window=4, img_wh=(128, 128),
              white_bg=0.0, chunk=4096)
    frame = trb.baked_frame_display_fn(
        _to_port(jb), torch.from_numpy(np.array(ro)),
        torch.from_numpy(np.array(rd)), **kw)
    t_stats, j_stats = {}, {}
    got = frame(threefry.prng_key(5), stats=t_stats).numpy()
    ref = jrb.render_baked(jb, None, ro, rd, None, key=key, display=True,
                           stats=j_stats, **kw)
    assert j_stats["dispatches"] >= 3
    np.testing.assert_array_equal(got, np.asarray(ref["rgb_u8"]))
    assert t_stats["rounds"] == j_stats["rounds"]
    one_key = np.asarray(jrb.baked_frame_display_fn(jb, ro, rd, **kw)(key))
    assert (got != one_key).any()


def test_refresh_bake_advances_only_on_a_new_checkpoint(tmp_path,
                                                        monkeypatch,
                                                        small_jax_config):
    """The mtime poll and the delta: an unchanged file does nothing, a
    rewritten one reloads and delta-bakes, as the JAX viewer's does (the
    same delta in both, held like test_torch_baked_delta.py)."""
    path = _write_ckpt(tmp_path / "live.npz")
    bake = trb.bake_ngp
    monkeypatch.setattr(trb, "bake_ngp", lambda *a, **k: bake(
        *a, **{**k, "resolution": 16, "n_dirs": 8}))
    jg, tg = _guis(path, baked=True)
    jg.baked = jrb.bake_ngp(jg.params, jg.grid_state, jg.cfg, resolution=16,
                            n_dirs=8)
    assert tg.baked is not None and tg.bake_seconds > 0
    assert not tg.refresh_bake() and tg.delta_stats is None
    # a training run rewrites the checkpoint: weights and EMA density move
    with np.load(path) as f:
        blobs = dict(f)
    blobs["params/rgb_mlp/0"] = blobs["params/rgb_mlp/0"] + 0.05
    dens = blobs["grid/density_grid"]
    blobs["grid/density_grid"] = np.where(np.arange(dens.size) % 5 == 0,
                                          dens * 2, dens).reshape(dens.shape)
    np.savez(path, **blobs)
    t_old = tg._ckpt_mtime
    import os
    os.utime(path, (t_old + 5, t_old + 5))
    jg._ckpt_mtime = t_old
    assert tg.refresh_bake() and jg.refresh_bake()
    stats = dict(tg.delta_stats)
    assert stats.pop("seconds") > 0
    assert 0 < stats["n_changed"] < stats["n_total"] and stats["phase"] == 1
    assert tg.baked.bake_phase == int(jg.baked.bake_phase) == 1
    np.testing.assert_allclose(tg.baked.rows.numpy(),
                               np.asarray(jg.baked.rows), rtol=0,
                               atol=1e-5 * float(np.abs(jg.baked.rows).max()))
    np.testing.assert_array_equal(tg.baked.src_density,
                                  np.asarray(jg.baked.src_density))
    assert torch.equal(tg.params["rgb_mlp"][0],
                       torch.from_numpy(blobs["params/rgb_mlp/0"]))
    assert not tg.refresh_bake()
    assert tg.refresh_bake(force=True) and tg.baked.bake_phase == 2


class _StubDearPyGui(types.ModuleType):
    """Records what run_dearpygui does with dearpygui and plays a user:
    the viewport runs for two frames; before the second, a drag, a wheel
    step, a pan and a click on 'show depth'."""

    mvFormat_Float_rgb = "float_rgb"
    mvMouseButton_Left = 0
    mvMouseButton_Middle = 2

    def __init__(self):
        super().__init__("dearpygui.dearpygui")
        self.values = {"_exposure": 1.0}
        self.textures = []
        self.handlers = {}
        self.callbacks = {}
        self.frames = 0

    class _Ctx:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return lambda *a, **k: None

    def texture_registry(self, **k):
        return self._Ctx()

    window = handler_registry = texture_registry

    def add_raw_texture(self, w, h, buffer, **k):
        self.values[k["tag"]] = buffer

    def add_button(self, **k):
        self.callbacks[k["tag"]] = k["callback"]

    def add_mouse_drag_handler(self, button, callback):
        self.handlers[f"drag{button}"] = callback

    def add_mouse_wheel_handler(self, callback):
        self.handlers["wheel"] = callback

    def is_item_focused(self, tag):
        return tag == "_primary_window"

    def get_value(self, tag):
        return self.values[tag]

    def set_value(self, tag, value):
        if tag == "_texture":
            self.textures.append(np.array(value))
        self.values[tag] = value

    def is_dearpygui_running(self):
        return self.frames < 2

    def render_dearpygui_frame(self):
        self.frames += 1
        if self.frames == 1:
            self.handlers["drag0"](None, (0, 40.0, -12.0))
            self.handlers["wheel"](None, 1)
            self.handlers["drag2"](None, (0, 25.0, 5.0))
            self.callbacks["_button_depth"]()
            self.values["_exposure"] = 4.0


def test_run_dearpygui_drives_the_gui(ckpts, monkeypatch):
    stub = _StubDearPyGui()
    pkg = types.ModuleType("dearpygui")
    pkg.dearpygui = stub
    monkeypatch.setitem(sys.modules, "dearpygui", pkg)
    monkeypatch.setitem(sys.modules, "dearpygui.dearpygui", stub)
    gui = t_gui.NGPGUI(t_opts(["--device", "cpu", "--dataset_name",
                               "synthetic", "--ckpt_path", ckpts["ldr"]]
                              + SIZE_FLAGS), K64, (64, 48))
    pose0, radius0 = gui.cam.pose, gui.cam.radius
    t_gui.run_dearpygui(gui)
    assert stub.frames == 2 and len(stub.textures) == 2
    for tex in stub.textures:
        assert tex.shape == (48, 64, 3) and tex.dtype == np.float32
        assert np.isfinite(tex).all()
    assert not np.array_equal(stub.textures[0], stub.textures[1])
    assert gui.img_mode == 1 and gui.exposure == 4.0
    assert gui.cam.radius < radius0
    assert not np.allclose(gui.cam.pose[:3, :3], pose0[:3, :3])
    assert not np.allclose(gui.cam.center, 0)
    assert "FPS" in stub.values["_log_time"]


def test_entry_point_headless_on_the_cpu(ckpts, monkeypatch, capsys):
    """`python -m arnerf_tpu_torch.show_gui` in-process: 30 headless frames
    at 32x32 (--low_resolution 4), network and baked (the bake cut to
    16^3); no DISPLAY and no dearpygui here."""
    monkeypatch.setitem(sys.modules, "dearpygui", None)
    monkeypatch.delenv("DISPLAY", raising=False)
    argv = ["--device", "cpu", "--dataset_name", "synthetic", "--ckpt_path",
            ckpts["ldr"], "--low_resolution", "4"] + SIZE_FLAGS
    gui = t_gui.main(argv)
    out = capsys.readouterr().out
    assert (gui.W, gui.H) == (32, 32) and gui.baked is None
    assert "headless orbit:" in out and "FPS at 32x32" in out
    assert "fused-head launches: 0 in 30 frames" in out

    bake = trb.bake_ngp
    sizes = []

    def small_bake(*a, **k):
        sizes.append(k.get("resolution", 256))
        return bake(*a, **{**k, "resolution": 16, "n_dirs": 8})
    monkeypatch.setattr(trb, "bake_ngp", small_bake)
    monkeypatch.setenv("ARNERF_GUI_BAKED", "1")
    monkeypatch.setenv("DISPLAY", ":0")
    gui = t_gui.main(argv)
    out = capsys.readouterr().out
    assert sizes == [256] and gui.baked is not None
    assert "baked field in" in out and "headless orbit:" in out
    assert "dearpygui is not installed" in out and gui._frame == 30


def test_entry_point_needs_a_card_without_device_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_gui.main(["--dataset_name", "synthetic"] + SIZE_FLAGS)
