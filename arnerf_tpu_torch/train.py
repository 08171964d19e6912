"""Training CLI (port of the repository's train.py:26-203):

  python -m arnerf_tpu_torch.train --dataset_name nerf --root_dir <scene> \
      --exp_name exp [--num_epochs 30] [--device cpu]

Same flags and outputs as the JAX CLI: checkpoints under
ckpts/{dataset}/{exp}/ (epoch=N.npz and its _slim copy), metrics under
logs/{dataset}/{exp}/metrics.jsonl, and the test views with their depth
maps under results/{dataset}/{exp}/, relative to the working directory.
The depth maps are coloured with OpenCV's turbo map, as the JAX CLI's are
(the port carries the table: utils/colormap.py). --eval_lpips adds
`test/lpips_rand=` (or `test/lpips_vgg=` with the official weights) to the
test line (training/lpips.py).

Runs on the card by default, with the fused field-head kernel, bf16 field
evaluation and stochastic corners (train.py:64-75); --device cpu runs the
plain versions in float32 with exact corners. The datasets are synthetic,
nerf, nsvf, nerfpp and colmap. Flags whose modules are not ported yet are
refused: --optimize_ext, --use_exposure, --use_EXR, --num_gpus > 1,
--model_parallel > 1 and the EXR datasets (colmap_exr,
colmap_real_exr, myblender, rtmv). Synthetic-NSVF runs end with the JAX
CLI's no-mp4-backend message: the port writes no video.
"""

import json
import os
import sys

import numpy as np
import torch

from .image_io import write_png
from .opt import get_opts, model_config


def _refuse_unported(hparams):
    from .datasets import unported_reason
    for flag in ("optimize_ext", "use_exposure", "use_EXR"):
        if getattr(hparams, flag):
            raise SystemExit(f"--{flag} is not ported to arnerf_tpu_torch "
                             f"yet; use the JAX train.py")
    if hparams.num_gpus > 1 or hparams.model_parallel > 1:
        raise SystemExit("--num_gpus > 1 and --model_parallel > 1 (DDP, "
                         "sharded tables) are not ported to arnerf_tpu_torch "
                         "yet; use the JAX train.py")
    reason = unported_reason(hparams.dataset_name)
    if reason:
        raise SystemExit(reason)


def depth2img(depth):
    """Depth normalised to [0, 255], coloured with the turbo map as RGB
    (reference train.py:45-50)."""
    from .utils.colormap import apply_turbo
    d = (depth - depth.min()) / max(float(depth.max() - depth.min()), 1e-9)
    return apply_turbo((d * 255).astype(np.uint8))


def main(argv=None, callback=None) -> dict:
    """Train, save, validate. Returns the trainer and the test metrics.
    callback(step, metrics), if given, runs after every training block."""
    hparams = get_opts(argv)
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError("You need to provide a @ckpt_path for validation!")
    _refuse_unported(hparams)

    from .datasets import dataset_dict
    from .device import resolve_device
    from .training.ckpt import slim_ckpt
    from .training.losses import NeRFLossConfig
    from .training.metrics import (lpips as lpips_fn, psnr as psnr_fn,
                                   ssim as ssim_fn)
    from .training.trainer import NeRFTrainer, TrainConfig

    device = resolve_device(hparams.device)
    dataset_cls = dataset_dict[hparams.dataset_name]
    kwargs = {"root_dir": hparams.root_dir, "downsample": hparams.downsample,
              "device": device}
    train_ds = dataset_cls(split=hparams.split, **kwargs)
    test_ds = dataset_cls(split="test", **kwargs)

    stoch = (device.type == "cuda" if hparams.stoch_corners == "auto"
             else hparams.stoch_corners == "on")
    cfg = model_config(hparams, device, stoch_corners=stoch)
    tc = TrainConfig(
        batch_size=hparams.batch_size, lr=hparams.lr,
        num_epochs=hparams.num_epochs,
        steps_per_epoch=hparams.steps_per_epoch,
        random_bg=hparams.random_bg,
        ray_sampling_strategy=hparams.ray_sampling_strategy,
        val_batch_size=hparams.val_batch_size,
        erode=hparams.dataset_name == "colmap",
        seg_pool=hparams.seg_pool == "on",
        loss=NeRFLossConfig(
            loss_set=hparams.loss_func, grid_scale=hparams.scale,
            lambda_depth=hparams.depth_loss_w,
            lambda_distortion=hparams.distortion_loss_w))
    trainer = NeRFTrainer(cfg, tc, train_ds, test_ds, seed=0, device=device)

    ckpt_dir = f"ckpts/{hparams.dataset_name}/{hparams.exp_name}"
    if hparams.ckpt_path:
        trainer.load(hparams.ckpt_path)
    elif hparams.weight_path:
        trainer.load_weights(hparams.weight_path)

    if not hparams.val_only:
        log_dir = f"logs/{hparams.dataset_name}/{hparams.exp_name}"
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "metrics.jsonl"), "a") as log:
            def log_cb(step, m):
                if callback is not None:
                    callback(step, m)
                if step % 100 < tc.update_interval:
                    log.write(json.dumps(
                        {"step": int(step),
                         **{k: float(v) for k, v in m.items()}}) + "\n")
                    log.flush()
            trainer.fit(n_steps=max(tc.total_steps - trainer.step, 0),
                        log_every=1000, callback=log_cb)
        os.makedirs(ckpt_dir, exist_ok=True)
        full_path = f"{ckpt_dir}/epoch={hparams.num_epochs - 1}.npz"
        trainer.save(full_path)
        slim_ckpt(full_path,
                  f"{ckpt_dir}/epoch={hparams.num_epochs - 1}_slim.npz")

    # validation over the whole test split (reference validation_step)
    val_dir = f"results/{hparams.dataset_name}/{hparams.exp_name}"
    if not hparams.no_save_test:
        os.makedirs(val_dir, exist_ok=True)
    w, h = test_ds.img_wh
    psnrs, ssims, lpipss = [], [], []
    for i in range(len(test_ds.poses)):
        out = trainer.render_pose(test_ds.poses[i])
        pred = out["rgb"].reshape(h, w, 3)
        if trainer.exp_step_factor == 0.0:   # white background (synthetic)
            pred = pred + (1 - out["opacity"].reshape(h, w, 1))
        pred = torch.clamp(pred, 0, 1)
        if len(test_ds.rays) > 0:
            gt = torch.as_tensor(test_ds.rays[i][:, :3],
                                 device=device).reshape(h, w, 3)
            psnrs.append(float(psnr_fn(pred, gt)))
            ssims.append(float(ssim_fn(pred, gt)))
            if hparams.eval_lpips:
                lpipss.append(lpips_fn(pred, gt))
        if not hparams.no_save_test:
            write_png(os.path.join(val_dir, f"{i:03d}.png"),
                      (pred.cpu().numpy() * 255).astype(np.uint8))
            write_png(os.path.join(val_dir, f"{i:03d}_d.png"),
                      depth2img(out["depth"].reshape(h, w).cpu().numpy()))
    if psnrs:
        msg = f"test/psnr={np.mean(psnrs):.3f} test/ssim={np.mean(ssims):.4f}"
        if lpipss:
            # random-feature values are labelled lpips_rand, never lpips_vgg
            msg += f" test/{lpipss[0].label}={np.mean(lpipss):.4f}"
        print(msg, flush=True)
    # rgb/depth videos for Synthetic-NSVF (train.py:183-203): the port has
    # no mp4 encoder, so it takes the JAX CLI's no-backend branch
    if not hparams.no_save_test and hparams.dataset_name == "nsvf" \
            and "Synthetic" in hparams.root_dir:
        print("video export skipped (no mp4 backend: arnerf_tpu_torch "
              "writes no video)", flush=True)
    return {"trainer": trainer, "psnr": psnrs, "ssim": ssims,
            "lpips": [float(v) for v in lpipss], "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main(sys.argv[1:])
