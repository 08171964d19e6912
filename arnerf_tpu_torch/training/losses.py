"""Training losses (port of arnerf_tpu/training/losses.py; reference
losses.py).

rgb loss variants (reference losses.py:51-53):
  raw:  ((est - gt) / (stop_grad(est) + 1e-3))^2        relative MSE
  log:  (log((0.2935+est)/(0.2935+gt)) * 0.7607)^2      HDR log loss
  tanh: (tanh(est) - tanh(gt))^2
plus opacity entropy, a depth log-prior and the mip-NeRF-360 distortion
loss (ops/distortion.py).
"""

from dataclasses import dataclass

import torch

from ..ops.distortion import distortion_loss


@dataclass(frozen=True)
class NeRFLossConfig:
    loss_set: str = "raw"            # 'raw' | 'log' | 'tanh'
    grid_scale: float = 0.5
    lambda_opacity: float = 1e-3
    lambda_depth: float = 0.0
    lambda_distortion: float = 0.0


def rgb_loss_fn(loss_set: str, est, gt):
    if loss_set == "raw":
        return (est - gt) / (est.detach() + 1e-3)
    if loss_set == "log":
        return torch.log((0.2935 + est) / (0.2935 + gt)) * 0.7607
    if loss_set == "tanh":
        return torch.tanh(est) - torch.tanh(gt)
    raise ValueError(f"unknown loss_set {loss_set!r}")


def nerf_loss(results: dict, target_rgb, cfg: NeRFLossConfig) -> dict:
    """The per-term loss dict (each term is later averaged and the means
    summed, as the reference train step does, train.py:181-188)."""
    d = {"rgb": rgb_loss_fn(cfg.loss_set, results["rgb"], target_rgb) ** 2}
    o = results["opacity"] + 1e-10
    d["opacity"] = cfg.lambda_opacity * (-o * torch.log(o))
    if cfg.lambda_depth > 0:
        d["depth"] = -cfg.lambda_depth * torch.log(torch.clamp(
            results["depth"] / cfg.grid_scale + 1e-10, max=1.0))
    if cfg.lambda_distortion > 0:
        d["distortion"] = cfg.lambda_distortion * distortion_loss(
            results["ws"], results["deltas"], results["ts"],
            results["ray_idx"], results["valid"], results["ray_start"],
            results["counts"])
    return d


def total_loss(loss_dict: dict):
    return sum(torch.mean(v) for v in loss_dict.values())
