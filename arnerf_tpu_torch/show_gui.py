"""Interactive viewer (port of the repository's show_gui.py):

  python -m arnerf_tpu_torch.show_gui --dataset_name nerf --root_dir <scene> \
      --ckpt_path ckpt.npz [--low_resolution 2] [--device cpu]

Launch it with the flags of the training run plus --ckpt_path. Frames are
rendered on the card by default, in float32 as eval renders
(render_test(fast=True, max_samples=96, samples_per_round=32,
T_threshold=1e-2), the fused field head on the card); --device cpu
renders with the plain versions, and without it there must be a card.

ARNERF_GUI_BAKED=1 bakes the field at startup (rendering_baked.bake_ngp,
LDR Sigmoid models with a checkpoint) and renders colour frames through
baked_frame_display_fn, depth frames through render_baked. While a
training run rewrites the checkpoint, refresh_bake reloads it and re-bakes
only what changed (bake_ngp_delta, capped at 1/16 of the occupied cells a
refresh).

Frontends: dearpygui when it imports; else a headless orbit of 30 frames
that prints the mean FPS of frames 2 onwards. The OpenCV window of the
JAX viewer has no counterpart (the port uses no image library).
"""

import os
import sys
import time

import numpy as np
import torch

from .opt import get_opts, model_config


class OrbitCamera:
    """Orbit/scale/pan camera (reference show_gui.py:19-51)."""

    def __init__(self, K, img_wh, r):
        self.K = K
        self.W, self.H = img_wh
        self.radius = r
        self.center = np.zeros(3)
        self.rot = np.eye(3)

    @property
    def pose(self):
        res = np.eye(4)
        res[2, 3] -= self.radius
        rot = np.eye(4)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    def orbit(self, dx, dy):
        from scipy.spatial.transform import Rotation as R
        rotvec_x = self.rot[:, 1] * np.radians(0.05 * dx)
        rotvec_y = self.rot[:, 0] * np.radians(-0.05 * dy)
        self.rot = R.from_rotvec(rotvec_y).as_matrix() @ \
            R.from_rotvec(rotvec_x).as_matrix() @ self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        self.center += 1e-4 * self.rot @ np.array([dx, dy, dz])


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class NGPGUI:
    """The viewer's state and frame (reference show_gui.py:54-191).

    baked=True (or ARNERF_GUI_BAKED=1) bakes a Sigmoid model with a
    checkpoint once at startup and renders its frames from the bake; HDR
    models (--use_exposure, --use_EXR) keep the network frame. Frame
    number i of the baked path draws its jitter from threefry.prng_key(i).
    """

    def __init__(self, hparams, K, img_wh, radius=2.5, baked=None):
        from .device import resolve_device
        from .models import grid_state_init, ngp_init
        from .training.ckpt import load_ckpt

        self.hparams = hparams
        self.device = resolve_device(hparams.device)
        self.cfg = model_config(hparams, self.device, auto_on_cuda="float32")
        self.params = ngp_init(self.cfg, torch.Generator().manual_seed(0),
                               self.device)
        self.grid_state = grid_state_init(self.cfg, self.device)
        if hparams.ckpt_path:
            self.params, self.grid_state, _ = load_ckpt(
                hparams.ckpt_path, params_template=self.params,
                grid_template=self.grid_state, device=self.device)
        self.cam = OrbitCamera(K, img_wh, r=radius)
        self.W, self.H = img_wh
        self.dt = 0
        self.mean_samples = 0
        self.img_mode = 0
        self.exposure = 1.0
        if baked is None:
            baked = os.environ.get("ARNERF_GUI_BAKED", "") not in ("", "0")
        self.baked = None
        self.bake_seconds = None       # the startup bake's
        self.delta_stats = None        # the last refresh_bake's, with seconds
        if baked and self.cfg.rgb_act == "Sigmoid" and hparams.ckpt_path:
            from . import rendering_baked
            t0 = time.perf_counter()
            self.baked = rendering_baked.bake_ngp(self.params,
                                                  self.grid_state, self.cfg)
            _sync(self.device)
            self.bake_seconds = time.perf_counter() - t0
            print(f"baked field in {self.bake_seconds:.1f}s", flush=True)
        self._frame = 0
        self._ckpt_mtime = (os.path.getmtime(hparams.ckpt_path)
                            if hparams.ckpt_path
                            and os.path.exists(hparams.ckpt_path) else 0.0)

    def refresh_bake(self, force=False):
        """Live preview of a training run: if the checkpoint file changed
        on disk (or `force`), reload it and, on the baked path, re-bake
        only the changed cells (bake_ngp_delta), at most max(1024, occupied
        / 16) moved cells a refresh plus the refresh stripe. Returns True
        when the preview advanced."""
        from .training.ckpt import load_ckpt
        p = self.hparams.ckpt_path
        if not p or not os.path.exists(p):
            return False
        mtime = os.path.getmtime(p)
        if not force and mtime <= self._ckpt_mtime:
            return False
        self.params, self.grid_state, _ = load_ckpt(
            p, params_template=self.params, grid_template=self.grid_state,
            device=self.device)
        self._ckpt_mtime = mtime
        if self.baked is not None:
            from . import rendering_baked
            t0, stats = time.perf_counter(), {}
            occ_cells = int(self.grid_state.occ_flat.sum())
            self.baked = rendering_baked.bake_ngp_delta(
                self.params, self.grid_state, self.cfg, self.baked,
                stats=stats, budget_cells=max(1024, occ_cells // 16))
            _sync(self.device)
            stats["seconds"] = time.perf_counter() - t0
            self.delta_stats = stats
            print(f"delta bake {stats['seconds']:.1f}s "
                  f"({stats.get('n_changed', 0)} voxels, "
                  f"{100 * stats.get('frac', 0):.1f}%)", flush=True)
        return True

    def render_cam(self, cam):
        """One frame from `cam` as an (H, W, 3) float32 image in [0, 1];
        self.dt is its wall time up to the image on the host."""
        from .datasets.ray_utils import get_ray_directions, get_rays
        from .ops import threefry
        from .rendering import render_test
        from .rendering_baked import baked_frame_display_fn, render_baked
        dev = self.device
        t = time.perf_counter()
        directions = torch.as_tensor(get_ray_directions(cam.H, cam.W, cam.K),
                                     device=dev)
        rays_o, rays_d = get_rays(directions, torch.as_tensor(
            np.asarray(cam.pose[:3], np.float32), device=dev))
        exp_step_factor = 1 / 256 if self.hparams.dataset_name in (
            "colmap", "nerfpp") else 0.0
        if self.baked is not None:
            self._frame += 1
            key = threefry.prng_key(self._frame)
            if not self.hparams.use_EXR and self.img_mode == 0:
                frame = baked_frame_display_fn(
                    self.baked, rays_o, rays_d, T_threshold=1e-2,
                    color_window=4, img_wh=(cam.W, cam.H), white_bg=0.0)
                out = {"rgb": frame(key).cpu().numpy().astype(np.float32)
                       / 255.0,
                       "depth": np.zeros((cam.H * cam.W,), np.float32)}
            else:
                out = render_baked(self.baked, self.grid_state, rays_o,
                                   rays_d, self.cfg, key=key,
                                   T_threshold=1e-2, color_window=4,
                                   img_wh=(cam.W, cam.H))
            out["total_samples"] = 0
        else:
            kwargs = {}
            if self.cfg.rgb_act == "None" and not self.cfg.use_raw_hdr:
                kwargs["exposure"] = torch.full((1, 1), self.exposure,
                                                device=dev)
            out = render_test(
                self.params, self.grid_state, rays_o, rays_d, self.cfg,
                exp_step_factor=exp_step_factor, T_threshold=1e-2,
                max_samples=96, samples_per_round=32, fast=True,
                output_radiance=self.hparams.use_EXR, **kwargs)
        rgb = _host(out["rgb"]).reshape(self.H, self.W, 3)
        depth = _host(out["depth"]).reshape(self.H, self.W)
        self.dt = time.perf_counter() - t
        self.mean_samples = int(out["total_samples"]) / rays_o.shape[0]
        if self.hparams.use_EXR:
            rgb = np.power(rgb / (1 + rgb), 1.0 / 2.2)
        if self.img_mode == 0:
            return np.clip(rgb, 0, 1)
        from .train import depth2img
        return depth2img(depth).astype(np.float32) / 255.0


def run_dearpygui(gui):
    """The dearpygui frontend (reference show_gui.py:110-191)."""
    import dearpygui.dearpygui as dpg
    W, H = gui.W, gui.H
    buffer = np.ones((H, W, 3), dtype=np.float32)
    dpg.create_context()
    dpg.create_viewport(title="arnerf_tpu_torch", width=W, height=H,
                        resizable=False)
    with dpg.texture_registry(show=False):
        dpg.add_raw_texture(W, H, buffer, format=dpg.mvFormat_Float_rgb,
                            tag="_texture")
    with dpg.window(tag="_primary_window", width=W, height=H):
        dpg.add_image("_texture")
    dpg.set_primary_window("_primary_window", True)

    with dpg.window(label="Control", tag="_control_window", width=200,
                    height=150, pos=(10, 10)):
        dpg.add_slider_float(label="exposure", default_value=1.0,
                             min_value=1 / 60, max_value=32, tag="_exposure")
        dpg.add_button(label="show depth", tag="_button_depth",
                       callback=lambda: setattr(gui, "img_mode",
                                                1 - gui.img_mode))
        dpg.add_separator()
        dpg.add_text("no data", tag="_log_time")
        dpg.add_text("no data", tag="_samples_per_ray")

    def cb_drag(sender, app_data):
        if not dpg.is_item_focused("_primary_window"):
            return
        gui.cam.orbit(app_data[1], app_data[2])

    def cb_wheel(sender, app_data):
        if dpg.is_item_focused("_primary_window"):
            gui.cam.scale(app_data)

    def cb_pan(sender, app_data):
        if dpg.is_item_focused("_primary_window"):
            gui.cam.pan(app_data[1], app_data[2])

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left,
                                   callback=cb_drag)
        dpg.add_mouse_wheel_handler(callback=cb_wheel)
        dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle,
                                   callback=cb_pan)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    while dpg.is_dearpygui_running():
        gui.exposure = dpg.get_value("_exposure")
        gui.refresh_bake()   # live training preview: delta bake on a change
        buffer[:] = gui.render_cam(gui.cam)
        dpg.set_value("_texture", buffer)
        dpg.set_value("_log_time",
                      f"Render time: {1000 * gui.dt:.2f} ms "
                      f"FPS: {1 / max(gui.dt, 1e-9):.1f}")
        dpg.set_value("_samples_per_ray",
                      f"samples/ray: {gui.mean_samples:.2f}")
        dpg.render_dearpygui_frame()
    dpg.destroy_context()


def run_headless(gui, n_frames=30):
    """No display: orbit the camera, report the FPS of frames 2 onwards
    and the fused-head kernel's launches (0 on the CPU, where the plain
    version runs)."""
    from .ops import fused_head
    before = fused_head.launches
    times = []
    for i in range(n_frames):
        gui.cam.orbit(30, 0)
        gui.render_cam(gui.cam)
        times.append(gui.dt)
        if i == 0:
            print(f"first frame: {gui.dt:.2f}s", flush=True)
    t = np.mean(times[2:])
    print(f"headless orbit: {1 / t:.2f} FPS at {gui.W}x{gui.H}, "
          f"{gui.mean_samples:.1f} samples/ray", flush=True)
    print(f"fused-head launches: {fused_head.launches - before} in "
          f"{n_frames} frames, {before} before them", flush=True)


def main(argv=None):
    """Build the viewer from the flags and run a frontend; returns it."""
    hparams = get_opts(argv)
    from .datasets import dataset_dict, unported_reason
    reason = unported_reason(hparams.dataset_name)
    if reason:
        raise SystemExit(reason)
    dataset = dataset_dict[hparams.dataset_name](
        root_dir=hparams.root_dir, downsample=hparams.downsample,
        read_meta=False)
    low = hparams.low_resolution
    K = np.asarray(dataset.K, np.float32).copy()
    K[:2] /= low
    img_wh = (int(dataset.img_wh[0] / low), int(dataset.img_wh[1] / low))
    gui = NGPGUI(hparams, K, img_wh)
    try:
        import dearpygui.dearpygui  # noqa: F401
    except ImportError:
        if os.environ.get("DISPLAY"):
            print("dearpygui is not installed: running the headless orbit "
                  "(the port has no OpenCV window)", flush=True)
        run_headless(gui)
    else:
        run_dearpygui(gui)
    return gui


if __name__ == "__main__":
    main(sys.argv[1:])
