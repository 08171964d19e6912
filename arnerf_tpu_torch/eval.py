"""Offline evaluation: test-set PSNR/SSIM + render FPS (port of the
repository's eval.py:22-107).

  python -m arnerf_tpu_torch.eval --dataset_name synthetic \
      --ckpt_path ckpt.npz [--downsample 0.25] [--device cpu]

Runs on the card by default, with the fused field-head kernel and
--compute_dtype auto = bfloat16; --device cpu runs the plain versions in
float32. Checkpoints are the JAX package's .npz layout. --mesh, --grid_vis,
--cam_vis and ARNERF_EVAL_BAKED need modules not ported yet and are
refused.
"""

import os
import sys
import time

import numpy as np
import torch

from .opt import get_opts, resolve_compute_dtype

UNPORTED_FLAGS = ("--mesh", "--grid_vis", "--cam_vis")


def main(argv=None) -> dict:
    """Evaluate; prints the FPS line and returns the numbers as a dict."""
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in UNPORTED_FLAGS:
        if flag in argv:
            raise SystemExit(f"{flag} is not ported to arnerf_tpu_torch yet; "
                             f"use the JAX eval.py")
    if os.environ.get("ARNERF_EVAL_BAKED", "") not in ("", "0"):
        raise SystemExit("ARNERF_EVAL_BAKED: the baked renderer is not "
                         "ported to arnerf_tpu_torch yet")
    hparams = get_opts(argv)

    from .datasets import dataset_dict
    from .datasets.ray_utils import get_rays
    from .device import resolve_device
    from .models import NGPConfig, grid_state_init, ngp_init
    from .rendering import render_test
    from .training.ckpt import load_ckpt
    from .training.metrics import psnr as psnr_fn, ssim as ssim_fn

    device = resolve_device(hparams.device)
    if hparams.dataset_name not in dataset_dict:
        raise SystemExit(f"dataset {hparams.dataset_name!r} is not ported to "
                         f"arnerf_tpu_torch yet (have: {sorted(dataset_dict)})")
    if not hparams.ckpt_path:
        raise SystemExit("--ckpt_path is required")
    test_ds = dataset_dict[hparams.dataset_name](
        split="test", root_dir=hparams.root_dir,
        downsample=hparams.downsample, device=device)

    rgb_act = "None" if (hparams.use_exposure or hparams.use_EXR) \
        else "Sigmoid"
    cfg = NGPConfig(scale=hparams.scale, rgb_act=rgb_act,
                    use_raw_hdr=hparams.use_EXR,
                    compute_dtype=resolve_compute_dtype(
                        hparams.compute_dtype, device),
                    fused_head=device.type == "cuda")
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

    psnrs, ssims, times, samples = [], [], [], []
    for i in range(len(test_ds.poses)):
        rays_o, rays_d = get_rays(
            dirs, torch.as_tensor(test_ds.poses[i], device=device))
        sync()
        t0 = time.perf_counter()
        out = render_test(params, grid_state, rays_o, rays_d, cfg,
                          exp_step_factor=exp_step_factor,
                          T_threshold=1e-2, max_samples=96, fast=True)
        sync()
        times.append(time.perf_counter() - t0)
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
    return {"fps": fps, "img_wh": (w, h), "seconds_per_view": times,
            "total_samples": samples, "psnr": psnrs, "ssim": ssims,
            "compute_dtype": cfg.compute_dtype, "device": str(device)}


if __name__ == "__main__":
    main()
