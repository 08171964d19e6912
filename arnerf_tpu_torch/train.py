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
nerf, nsvf, nerfpp, colmap and the OpenEXR ones, colmap_exr,
colmap_real_exr and myblender. The HDR flags are the JAX CLI's
(train.py:54-83): --use_exposure trains the HDR-NeRF tonemapper heads on
the exposures a dataset carries (colmap's HDR-NeRF layouts) with the
unit-exposure anchor at the dataset's unit_exposure_rgb; --use_EXR trains
raw HDR radiance (rgb_act None, leaky ReLU) on the EXR datasets, usually
with --loss_func log; --optimize_ext refines every training pose. The
test views are clipped to [0, 1] before PSNR. Refused: --num_gpus > 1,
--model_parallel > 1 and rtmv (see datasets/__init__.py). Synthetic-NSVF
runs end with the JAX CLI's no-mp4-backend message: the port writes no
video.
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
    reason = unported_reason(hparams.dataset_name)
    if reason:
        raise SystemExit(reason)
    if hparams.model_parallel > 1 and \
            hparams.num_gpus % hparams.model_parallel:
        raise ValueError('--num_gpus must be a multiple of '
                         '--model_parallel')


def _launch(argv, hparams, device):
    """--num_gpus N outside torchrun: run this entry point as N ranks."""
    from .parallel.launch import launch
    n = hparams.num_gpus
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise RuntimeError(f"--num_gpus {n} needs {n} GPUs, but "
                           f"{torch.cuda.device_count()} GPU(s) are "
                           f"visible")
    launch(["-m", "arnerf_tpu_torch.train", *argv], n,
           cpu=device.type == "cpu")
    return {"ranks": n,
            "ckpt_dir": f"ckpts/{hparams.dataset_name}/{hparams.exp_name}"}


def _join_group(hparams, device):
    """Under torchrun's environment: join the group and lay its ranks out
    (data parallel, or --model_parallel ranks a table). Returns (device,
    mesh), mesh None when WORLD_SIZE is not set."""
    import torch.distributed as dist
    from .parallel import init_distributed, make_mesh, make_mesh_2d
    rank_device = init_distributed(device)
    if rank_device is None:
        return device, None
    world = dist.get_world_size()
    if hparams.num_gpus not in (1, world):
        raise ValueError(f"--num_gpus {hparams.num_gpus} but the process "
                         f"group has {world} ranks")
    n_mp = hparams.model_parallel    # divides world: _refuse_unported
    mesh = make_mesh_2d(world // n_mp, n_mp) if n_mp > 1 \
        else make_mesh(world)
    return rank_device, mesh


def depth2img(depth):
    """Depth normalised to [0, 255], coloured with the turbo map as RGB
    (reference train.py:45-50)."""
    from .utils.colormap import apply_turbo
    d = (depth - depth.min()) / max(float(depth.max() - depth.min()), 1e-9)
    return apply_turbo((d * 255).astype(np.uint8))


def main(argv=None, callback=None) -> dict:
    """Train, save, validate. Returns the trainer and the test metrics
    (empty on ranks other than 0). callback(step, metrics, trainer), if
    given, runs after every training block, on every rank. With
    --num_gpus > 1 and no WORLD_SIZE, starts the ranks, waits for them and
    returns {"ranks", "ckpt_dir"}."""
    argv = sys.argv[1:] if argv is None else list(argv)
    hparams = get_opts(argv)
    if hparams.val_only and not hparams.ckpt_path:
        raise ValueError("You need to provide a @ckpt_path for validation!")
    _refuse_unported(hparams)
    from .device import resolve_device
    device = resolve_device(hparams.device)
    if hparams.num_gpus > 1 and "WORLD_SIZE" not in os.environ:
        return _launch(argv, hparams, device)
    device, mesh = _join_group(hparams, device)
    out = _train(hparams, device, mesh, callback)
    if mesh is not None:
        import torch.distributed as dist
        mesh.barrier()
        dist.destroy_process_group()
    return out


def _train(hparams, device, mesh, callback):
    """Train, save and validate on `device` (one rank of `mesh`, if
    given)."""
    main_rank = mesh is None or mesh.rank == 0

    from .datasets import dataset_dict, loader_kwargs
    from .training.ckpt import slim_ckpt
    from .training.losses import NeRFLossConfig
    from .training.metrics import (lpips as lpips_fn, psnr as psnr_fn,
                                   ssim as ssim_fn)
    from .training.trainer import NeRFTrainer, TrainConfig

    dataset_cls = dataset_dict[hparams.dataset_name]
    kwargs = loader_kwargs(hparams, device)
    train_ds = dataset_cls(split=hparams.split, **kwargs)
    test_ds = dataset_cls(split="test", **kwargs)

    stoch = (device.type == "cuda" if hparams.stoch_corners == "auto"
             else hparams.stoch_corners == "on")
    cfg = model_config(hparams, device, stoch_corners=stoch)
    tc = TrainConfig(
        batch_size=hparams.batch_size, lr=hparams.lr,
        num_epochs=hparams.num_epochs,
        steps_per_epoch=hparams.steps_per_epoch,
        random_bg=hparams.random_bg, optimize_ext=hparams.optimize_ext,
        ray_sampling_strategy=hparams.ray_sampling_strategy,
        use_exposure=hparams.use_exposure,
        val_batch_size=hparams.val_batch_size,
        unit_exposure_rgb=float(getattr(train_ds, "unit_exposure_rgb", 0.5)),
        erode=hparams.dataset_name == "colmap",
        seg_pool=hparams.seg_pool == "on",
        loss=NeRFLossConfig(
            loss_set=hparams.loss_func, grid_scale=hparams.scale,
            lambda_depth=hparams.depth_loss_w,
            lambda_distortion=hparams.distortion_loss_w))
    trainer = NeRFTrainer(cfg, tc, train_ds, test_ds, seed=0, device=device,
                          mesh=mesh)

    ckpt_dir = f"ckpts/{hparams.dataset_name}/{hparams.exp_name}"
    if hparams.ckpt_path:
        trainer.load(hparams.ckpt_path)
    elif hparams.weight_path:
        trainer.load_weights(hparams.weight_path)

    if not hparams.val_only:
        log_dir = f"logs/{hparams.dataset_name}/{hparams.exp_name}"
        os.makedirs(log_dir, exist_ok=True)
        log = open(os.path.join(log_dir, "metrics.jsonl"), "a") \
            if main_rank else None
        try:
            def log_cb(step, m):
                if callback is not None:
                    callback(step, m, trainer)
                if log is not None and step % 100 < tc.update_interval:
                    log.write(json.dumps(
                        {"step": int(step),
                         **{k: float(v) for k, v in m.items()}}) + "\n")
                    log.flush()
            trainer.fit(n_steps=max(tc.total_steps - trainer.step, 0),
                        log_every=1000, callback=log_cb)
        finally:
            if log is not None:
                log.close()
        full_path = f"{ckpt_dir}/epoch={hparams.num_epochs - 1}.npz"
        trainer.save(full_path)      # every rank: a sharded table gathers
        if main_rank:
            slim_ckpt(full_path,
                      f"{ckpt_dir}/epoch={hparams.num_epochs - 1}_slim.npz")
    trainer.unshard()
    result = {"trainer": trainer, "psnr": [], "ssim": [], "lpips": [],
              "ckpt_dir": ckpt_dir}
    if not main_rank:
        return result

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
    result.update(psnr=psnrs, ssim=ssims, lpips=[float(v) for v in lpipss])
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
