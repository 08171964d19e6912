"""Pinned-seed quality regression of the port's trainer: the JAX package's
pinned 200-step CPU run (tests/test_quality_regression.py: the synthetic
scene at 64x64, 12 training views, an 8-level 2^15 table, float32, exact
corners, batch 1024) through arnerf_tpu_torch's NeRFTrainer on the CPU.
The port's own train and validation PSNR are pinned to +-0.25 dB, and both
must lie within 1 dB of the JAX run's pinned 19.55 / 18.87 dB: the two
packages draw different rays (torch generators against jax.random), so
their runs are not the same run.

Recorded on the CPU (torch 2.13.0+cpu, float32), 2026-10-17: 19.90 /
19.55 dB (JAX: 19.55 / 18.87). If a change intentionally moves quality,
re-record: python -m tests.test_torch_quality_regression prints the fresh
values.
"""

import pytest
import torch

from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset)
from arnerf_tpu_torch.models import NGPConfig
from arnerf_tpu_torch.training.losses import NeRFLossConfig
from arnerf_tpu_torch.training.trainer import NeRFTrainer, TrainConfig

PINNED_TRAIN_PSNR = 19.90
PINNED_VAL_PSNR = 19.55
TOL_DB = 0.25
JAX_TRAIN_PSNR, JAX_VAL_PSNR = 19.55, 18.87     # test_quality_regression
JAX_TOL_DB = 1.0


def run_pinned():
    torch.set_num_threads(4)
    scfg = SyntheticConfig(img_wh=(64, 64), n_train=12, n_test=2,
                           gt_samples=256)
    train_ds = SyntheticDataset(split="train", config=scfg)
    test_ds = SyntheticDataset(split="test", config=scfg)
    cfg = NGPConfig(scale=0.5, grid_size=64, n_levels=8,
                    log2_hashmap_size=15, base_resolution=16,
                    compute_dtype="float32", stoch_corners=False)
    tc = TrainConfig(batch_size=1024, lr=1e-2, num_epochs=1,
                     steps_per_epoch=200, warmup_steps=64,
                     samples_per_ray_budget=40, max_samples=256, s_cap=256,
                     adaptive_budget=False,
                     loss=NeRFLossConfig(grid_scale=0.5))
    trainer = NeRFTrainer(cfg, tc, train_ds, test_ds, seed=42)
    trainer.on_train_start()
    m = None
    for _ in range(200):
        m = trainer.train_step()
    train_psnr = float(m["psnr"])
    val = trainer.validate(max_images=1, compute_ssim=False)
    return train_psnr, float(val["psnr"])


@pytest.mark.slow
def test_port_pinned_seed_psnr_regression():
    train_psnr, val_psnr = run_pinned()
    assert abs(train_psnr - PINNED_TRAIN_PSNR) < TOL_DB, \
        f"train PSNR drifted: {train_psnr:.3f} vs {PINNED_TRAIN_PSNR}"
    assert abs(val_psnr - PINNED_VAL_PSNR) < TOL_DB, \
        f"val PSNR drifted: {val_psnr:.3f} vs {PINNED_VAL_PSNR}"
    assert abs(train_psnr - JAX_TRAIN_PSNR) < JAX_TOL_DB, train_psnr
    assert abs(val_psnr - JAX_VAL_PSNR) < JAX_TOL_DB, val_psnr


if __name__ == "__main__":
    t, v = run_pinned()
    print(f"PINNED_TRAIN_PSNR = {t:.2f}")
    print(f"PINNED_VAL_PSNR = {v:.2f}")
