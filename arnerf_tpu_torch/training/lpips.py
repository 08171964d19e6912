"""LPIPS perceptual distance (port of arnerf_tpu/training/lpips.py; Zhang
et al., CVPR 2018), on NCHW tensors:

  input in [-1, 1]
    -> scaling layer (the official lpips shift/scale)
    -> VGG16's 13 3x3 convolutions, taps after relu1_2, relu2_2, relu3_3,
       relu4_3 and relu5_3
    -> channel unit normalisation, squared difference
    -> non-negative 1x1 "lin" weights, spatial mean, sum over the taps

Weights: `lpips_params(path)` loads arnerf_tpu_torch/data/lpips_vgg.npz
when it is present (the JAX package's key layout: HWIO `conv{i}/w`,
`conv{i}/b`, `lin{j}`) and is then the official metric; otherwise
`lpips_params_random()` draws the JAX package's seeded random-feature net
bit for bit (ops/threefry.py reproduces jax.random: PRNGKey(0), one split
per layer, He-normal convolutions, uniform lins / channels), so a
`lpips_rand` value means the same number in both packages.

The convolutions are torch's conv2d. They run in full float32 on the card
too: cuDNN's TF32 default is switched off for these calls only.
"""

import os
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import threefry

_VGG_PLAN = [(64, False), (64, False),
             (128, True), (128, False),
             (256, True), (256, False), (256, False),
             (512, True), (512, False), (512, False),
             (512, True), (512, False), (512, False)]
_TAPS = (1, 3, 6, 9, 12)          # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
_TAP_CH = (64, 128, 256, 512, 512)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "data",
                               "lpips_vgg.npz")


def _to_params(convs_hwio, lins, trained, device):
    """HWIO numpy convolutions -> OIHW tensors on `device`."""
    return {"convs": [{"w": torch.tensor(np.asarray(w), device=device)
                       .permute(3, 2, 0, 1).contiguous(),
                       "b": torch.tensor(np.asarray(b), device=device)}
                      for w, b in convs_hwio],
            "lins": [torch.tensor(np.asarray(l), device=device).reshape(-1)
                     for l in lins],
            "trained": trained}


def lpips_params_random(seed: int = 0, device="cpu") -> dict:
    """The JAX package's random-feature parameters (lpips.py:63-77)."""
    key = threefry.prng_key(seed)
    convs, lins = [], []
    c_in = 3
    for c_out, _ in _VGG_PLAN:
        key, kw = threefry.split(key)
        std = np.float32(np.sqrt(2.0 / (3 * 3 * c_in)))
        convs.append((threefry.normal(kw, (3, 3, c_in, c_out)) * std,
                      np.zeros(c_out, np.float32)))
        c_in = c_out
    for ch in _TAP_CH:
        key, kl = threefry.split(key)
        lins.append(threefry.uniform(kl, (ch,)) / np.float32(ch))
    return _to_params(convs, lins, False, device)


def lpips_params(path: str = None, device="cpu") -> dict:
    """The official weights from `path` (default DEFAULT_WEIGHTS) when the
    file exists, else lpips_params_random()."""
    path = DEFAULT_WEIGHTS if path is None else path
    if not os.path.exists(path):
        return lpips_params_random(device=device)
    blobs = np.load(path)
    convs = [(blobs[f"conv{i}/w"].astype(np.float32),
              blobs[f"conv{i}/b"].astype(np.float32))
             for i in range(len(_VGG_PLAN))]
    lins = [blobs[f"lin{j}"].astype(np.float32) for j in range(len(_TAPS))]
    return _to_params(convs, lins, True, device)


def vgg_features(params, x):
    """x: (N, 3, H, W) in [-1, 1] -> the five tapped feature maps."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    x = (x - shift) / scale
    feats = []
    for i, (_, pool_before) in enumerate(_VGG_PLAN):
        if pool_before:
            x = F.max_pool2d(x, 2, 2)
        conv = params["convs"][i]
        x = F.relu(F.conv2d(x, conv["w"], conv["b"], padding=1))
        if i in _TAPS:
            feats.append(x)
    return feats


@contextmanager
def _no_tf32_convolutions():
    """cuDNN convolutions in full float32 inside the block, the caller's
    setting restored after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _unit_normalize(f, eps=1e-10):
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


@torch.no_grad()
def lpips_distance(params, img0, img1):
    """LPIPS between two (H, W, 3) images in [0, 1] on one device -> a
    0-dim float32 tensor."""
    x = torch.stack([img0, img1]).float().permute(0, 3, 1, 2) * 2.0 - 1.0
    with _no_tf32_convolutions():
        feats = vgg_features(params, x)
    total = torch.zeros((), device=x.device)
    for f, lin in zip(feats, params["lins"]):
        d = (_unit_normalize(f[:1]) - _unit_normalize(f[1:])) ** 2
        total = total + torch.mean(torch.sum(d * lin.view(1, -1, 1, 1),
                                             dim=1))
    return total
