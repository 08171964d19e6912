"""Offline evaluation: test-set PSNR/SSIM + render FPS, occupancy-grid
slices, camera plot and isosurface mesh (port of the repository's
eval.py:22-157).

  python -m arnerf_tpu_torch.eval --dataset_name nerf --root_dir <scene> \
      --ckpt_path ckpt.npz [--mesh out.obj] [--grid_vis grid.png] \
      [--cam_vis cams.png] [--downsample 0.25] [--device cpu]

Runs on the card by default, with the fused field-head kernel; the field
is evaluated in float32 on every device, as the JAX eval renders
(--compute_dtype bfloat16 asks for bf16). --device cpu runs the plain
versions. Checkpoints are the JAX package's .npz layout. --mesh queries
the density at 256^3 points and runs marching tetrahedra on the same
device.

--use_exposure and --use_EXR build the HDR heads' model as the JAX
eval.py:52-55 does (rgb_act None; --use_EXR raw HDR radiance); the views
are rendered as in training (tonemapped at unit exposure, or the raw
radiance through a leaky ReLU) and clipped to [0, 1] before PSNR.

ARNERF_EVAL_BAKED=1 bakes the field (rendering_baked.bake_ngp, 256^3
voxels a cascade) and renders the views through render_baked instead of
the network; the bake time is printed before the FPS line. As in the JAX
eval, only LDR (Sigmoid) models bake; HDR models render the network.
"""

import os
import sys
import time

import numpy as np
import torch

from .opt import get_opts, model_config

from .image_io import write_png

EXTRA_FLAGS = ("--mesh", "--grid_vis", "--cam_vis")
MESH_RESOLUTION = 256      # grid points per axis of --mesh's density query


def _pop_flags(argv):
    """Take eval's own flags (each with one value) out of argv."""
    extra = {}
    for flag in EXTRA_FLAGS:
        if flag in argv:
            i = argv.index(flag)
            extra[flag[2:]] = argv[i + 1]
            del argv[i:i + 2]
    return extra


def grid_slices(occ_flat, cascades, grid_size):
    """The middle z slice of each cascade's occupancy, tiled horizontally,
    as a uint8 image (0 or 255)."""
    occ = np.asarray(occ_flat, np.uint8).reshape(cascades, grid_size,
                                                 grid_size, grid_size)
    tiles = [occ[c, :, :, grid_size // 2] * 255 for c in range(cascades)]
    return np.concatenate(tiles, axis=1).astype(np.uint8)


def camera_plot(poses, scale, size=320):
    """Camera centres and central view rays projected onto the xy | xz | yz
    planes with the scene's AABB, as a (size, 3 * size, 3) uint8 image (the
    notebook's plotly camera cell without plotly)."""
    S, half = size, float(scale)
    poses = np.asarray(poses)                          # (n, 3, 4)
    cam_o = poses[:, :, 3]
    cam_d = -poses[:, :, 2]                            # central ray
    cam_d /= np.linalg.norm(cam_d, axis=1, keepdims=True) + 1e-12
    lim = max(half, float(np.abs(cam_o).max())) * 1.15
    canvas = np.full((S, 3 * S, 3), 255, np.uint8)

    def px(v):      # world coord -> pixel
        return np.clip(((v + lim) / (2 * lim) * (S - 1)).astype(int),
                       0, S - 1)

    for p, (a, b) in enumerate(((0, 1), (0, 2), (1, 2))):
        x0 = p * S
        # scene AABB square
        lo, hi = px(np.float64(-half)), px(np.float64(half))
        canvas[lo:hi + 1, [x0 + lo, x0 + hi]] = (200, 200, 200)
        canvas[[lo, hi], x0 + lo:x0 + hi + 1] = (200, 200, 200)
        # central view rays (o -> o + 0.6 * lim * d) then camera dots
        for o, d in zip(cam_o, cam_d):
            t = np.linspace(0, 0.6 * lim, 64)
            seg = o[None, :] + t[:, None] * d[None, :]
            canvas[px(seg[:, b]), x0 + px(seg[:, a])] = (120, 170, 255)
        yy, xx = px(cam_o[:, b]), px(cam_o[:, a])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                canvas[np.clip(yy + dy, 0, S - 1),
                       x0 + np.clip(xx + dx, 0, S - 1)] = (220, 60, 40)
    return canvas


def main(argv=None) -> dict:
    """Evaluate; prints the FPS line (and one line per extra output) and
    returns the numbers as a dict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = _pop_flags(argv)
    hparams = get_opts(argv)

    from .datasets import dataset_dict, unported_reason
    from .datasets.ray_utils import get_rays
    from .device import resolve_device
    from .models import grid_state_init, ngp_init
    from .rendering import render_test
    from .training.ckpt import load_ckpt
    from .training.metrics import psnr as psnr_fn, ssim as ssim_fn

    device = resolve_device(hparams.device)
    reason = unported_reason(hparams.dataset_name)
    if reason:
        raise SystemExit(reason)
    if not hparams.ckpt_path:
        raise SystemExit("--ckpt_path is required")
    test_ds = dataset_dict[hparams.dataset_name](
        split="test", root_dir=hparams.root_dir,
        downsample=hparams.downsample, device=device)

    cfg = model_config(hparams, device, auto_on_cuda="float32")
    params, grid_state, _ = load_ckpt(
        hparams.ckpt_path,
        params_template=ngp_init(cfg, torch.Generator().manual_seed(0),
                                 device),
        grid_template=grid_state_init(cfg, device), device=device)

    exp_step_factor = 1 / 256 if hparams.scale > 0.5 else 0.0
    w, h = test_ds.img_wh
    dirs = torch.as_tensor(test_ds.directions, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    res = {}
    baked = None
    if os.environ.get("ARNERF_EVAL_BAKED", "") not in ("", "0") \
            and cfg.rgb_act == "Sigmoid":
        from .ops import threefry
        from .rendering_baked import bake_ngp, render_baked
        sync()
        t0 = time.perf_counter()
        baked = bake_ngp(params, grid_state, cfg)
        sync()
        res["bake_seconds"] = time.perf_counter() - t0
        # voxels evaluated: the occupied rows of the colour table
        res["bake_voxels"] = 0 if baked.rows_q is None \
            else int(baked.rows_q.shape[0]) - 1
        print(f"baked field in {res['bake_seconds']:.1f}s", flush=True)

    psnrs, ssims, times, samples, rounds = [], [], [], [], []
    for i in range(len(test_ds.poses)):
        rays_o, rays_d = get_rays(
            dirs, torch.as_tensor(test_ds.poses[i], device=device))
        sync()
        t0 = time.perf_counter()
        if baked is not None:
            stats = {}
            out = render_baked(baked, grid_state, rays_o, rays_d, cfg,
                               key=threefry.prng_key(i), T_threshold=1e-2,
                               img_wh=(w, h), stats=stats)
        else:
            out = render_test(params, grid_state, rays_o, rays_d, cfg,
                              exp_step_factor=exp_step_factor,
                              T_threshold=1e-2, max_samples=96, fast=True)
        sync()
        times.append(time.perf_counter() - t0)
        if baked is not None:
            rounds.append(stats["rounds"])
        else:
            samples.append(int(out["total_samples"]))
        pred = out["rgb"].reshape(h, w, 3)
        if exp_step_factor == 0.0:
            pred = pred + (1 - out["opacity"].reshape(h, w, 1))
        pred = torch.clamp(pred, 0, 1)
        if not torch.isfinite(pred).all():
            raise RuntimeError(f"view {i}: non-finite rgb")
        if len(test_ds.rays) > 0:
            gt = torch.as_tensor(test_ds.rays[i][:, :3],
                                 device=device).reshape(h, w, 3)
            psnrs.append(float(psnr_fn(pred, gt)))
            ssims.append(float(ssim_fn(pred, gt)))
    fps = 1.0 / np.mean(times[1:]) if len(times) > 1 else 1.0 / times[0]
    msg = f"FPS: {fps:.2f} ({w}x{h})"
    if psnrs:
        msg += f"  PSNR: {np.mean(psnrs):.3f}  SSIM: {np.mean(ssims):.4f}"
    print(msg, flush=True)
    res.update(fps=fps, img_wh=(w, h), seconds_per_view=times,
               total_samples=samples, psnr=psnrs, ssim=ssims,
               compute_dtype=cfg.compute_dtype, device=str(device),
               baked=baked is not None, rounds_per_bucket=rounds)

    if "grid_vis" in extra:
        write_png(extra["grid_vis"], grid_slices(
            grid_state.occ_flat.cpu().numpy(), cfg.cascades, cfg.grid_size))
        print(f"occupancy slices -> {extra['grid_vis']}", flush=True)
    if "cam_vis" in extra:
        write_png(extra["cam_vis"], camera_plot(test_ds.poses, hparams.scale))
        print(f"camera/ray plot (xy|xz|yz) -> {extra['cam_vis']}",
              flush=True)
    if "mesh" in extra:
        from .utils.mesh import extract_ngp_mesh, save_obj
        sync()
        t0 = time.perf_counter()
        verts, faces = extract_ngp_mesh(params, cfg,
                                        resolution=MESH_RESOLUTION,
                                        threshold=20.0)
        res["mesh_seconds"] = time.perf_counter() - t0
        save_obj(extra["mesh"], verts, faces)
        res["mesh_faces"] = len(faces)
        print(f"mesh: {len(verts)} verts, {len(faces)} faces -> "
              f"{extra['mesh']}", flush=True)
    return res


if __name__ == "__main__":
    main()
