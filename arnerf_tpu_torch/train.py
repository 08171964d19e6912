"""Training CLI (port of the repository's train.py:26-181):

  python -m arnerf_tpu_torch.train --dataset_name synthetic \
      --exp_name exp [--num_epochs 30] [--device cpu]

Same flags and outputs as the JAX CLI: checkpoints under
ckpts/{dataset}/{exp}/ (epoch=N.npz and its _slim copy), metrics under
logs/{dataset}/{exp}/metrics.jsonl, and the test views with their depth
maps under results/{dataset}/{exp}/, relative to the working directory.
The depth maps are grayscale PNGs (the JAX CLI colours them with OpenCV's
turbo map; the port depends on no image library).

Runs on the card by default, with the fused field-head kernel, bf16 field
evaluation and stochastic corners (train.py:64-75); --device cpu runs the
plain versions in float32 with exact corners. Flags whose modules are not
ported yet are refused: --optimize_ext, --use_exposure, --use_EXR,
--num_gpus > 1, --model_parallel > 1, --eval_lpips and the datasets other
than synthetic.
"""

import json
import os
import struct
import sys
import zlib

import numpy as np
import torch

from .opt import get_opts, model_config


def _refuse_unported(hparams):
    from .datasets import dataset_dict
    for flag in ("optimize_ext", "use_exposure", "use_EXR", "eval_lpips"):
        if getattr(hparams, flag):
            raise SystemExit(f"--{flag} is not ported to arnerf_tpu_torch "
                             f"yet; use the JAX train.py")
    if hparams.num_gpus > 1 or hparams.model_parallel > 1:
        raise SystemExit("--num_gpus > 1 and --model_parallel > 1 (DDP, "
                         "sharded tables) are not ported to arnerf_tpu_torch "
                         "yet; use the JAX train.py")
    if hparams.dataset_name not in dataset_dict:
        raise SystemExit(f"dataset {hparams.dataset_name!r} is not ported to "
                         f"arnerf_tpu_torch yet (have: {sorted(dataset_dict)})")


def write_png(path, img):
    """img: (H, W) or (H, W, 3) uint8 -> an 8-bit PNG file."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body \
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def depth2img(depth):
    """Depth normalised to [0, 255] (reference train.py:45-50, grayscale)."""
    d = (depth - depth.min()) / max(float(depth.max() - depth.min()), 1e-9)
    return (d * 255).astype(np.uint8)


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
    from .training.metrics import psnr as psnr_fn, ssim as ssim_fn
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
    psnrs, ssims = [], []
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
        if not hparams.no_save_test:
            write_png(os.path.join(val_dir, f"{i:03d}.png"),
                      (pred.cpu().numpy() * 255).astype(np.uint8))
            write_png(os.path.join(val_dir, f"{i:03d}_d.png"),
                      depth2img(out["depth"].reshape(h, w).cpu().numpy()))
    if psnrs:
        print(f"test/psnr={np.mean(psnrs):.3f} "
              f"test/ssim={np.mean(ssims):.4f}", flush=True)
    return {"trainer": trainer, "psnr": psnrs, "ssim": ssims,
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main(sys.argv[1:])
