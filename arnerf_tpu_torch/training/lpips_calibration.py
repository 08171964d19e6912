"""Calibration of the random-feature LPIPS (port of
arnerf_tpu/training/lpips_calibration.py): controlled distortions at swept
strengths of a procedural render. Within each family `lpips_rand` must
rise monotonically with the strength, and across all distorted images it
should order them as 1 - SSIM does (Amir & Weiss, CVPR 2021, use the same
evidence for random deep features).

Families (weakest to strongest):
  blur   - separable Gaussian, sigma in pixels
  noise  - additive Gaussian, sigma in intensity units
  quant  - uniform quantization to L levels (fewer levels = stronger)
  block  - k x k block averaging
"""

import numpy as np
import torch

DISTORTIONS = {
    "blur": [0.5, 1.0, 2.0, 3.0, 4.0],
    "noise": [0.02, 0.05, 0.1, 0.2, 0.3],
    "quant": [64, 32, 16, 8, 4],
    "block": [2, 4, 8, 16, 32],
}


def _gauss_kernel(sigma):
    r = max(1, int(np.ceil(3 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur1d(a, k, axis):
    r = len(k) // 2
    pad = [(r, r) if i == axis else (0, 0) for i in range(a.ndim)]
    p = np.pad(a, pad, mode="edge")
    out = np.zeros_like(a)
    for i, kv in enumerate(k):
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(i, i + a.shape[axis])
        out += kv * p[tuple(sl)]
    return out


def distort(img: np.ndarray, kind: str, strength, seed: int = 0):
    """img: (H, W, 3) float in [0, 1] -> a distorted copy, same shape and
    range (the JAX package's numpy distortions, value for value)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    if kind == "blur":
        k = _gauss_kernel(float(strength))
        return np.clip(_blur1d(_blur1d(img, k, 0), k, 1), 0.0, 1.0)
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return np.clip(img + rng.normal(0, float(strength), img.shape)
                       .astype(np.float32), 0.0, 1.0)
    if kind == "quant":
        L = int(strength)
        return np.clip(np.round(img * (L - 1)) / (L - 1), 0.0, 1.0)
    if kind == "block":
        k = int(strength)
        hh, ww = (h // k) * k, (w // k) * k
        out = img.copy()
        blk = img[:hh, :ww].reshape(hh // k, k, ww // k, k, 3)
        out[:hh, :ww] = np.repeat(np.repeat(
            blk.mean(axis=(1, 3)), k, axis=0), k, axis=1).reshape(hh, ww, 3)
        return out
    raise ValueError(kind)


def spearman(a, b) -> float:
    """Spearman rank correlation."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def reference_image(wh: int = 96) -> np.ndarray:
    """A test view of the procedural scene, (wh, wh, 3) float32."""
    from ..datasets.synthetic import SyntheticConfig, SyntheticDataset
    scfg = SyntheticConfig(img_wh=(wh, wh), n_train=1, n_test=1,
                           gt_samples=256)
    ds = SyntheticDataset(split="test", config=scfg)
    return np.asarray(ds.rays[0][:, :3], np.float32).reshape(wh, wh, 3)


def calibrate(img: np.ndarray = None, wh: int = 96) -> dict:
    """The whole sweep:
    {family: {"strengths", "lpips", "ssim", "spearman_lpips_vs_strength",
              "spearman_ssim_vs_strength"},
     "cross_family_spearman_lpips_vs_1m_ssim": r}"""
    from .metrics import lpips, ssim
    if img is None:
        img = reference_image(wh)
    ref = torch.as_tensor(img)
    out = {}
    all_lp, all_ds = [], []
    for kind, strengths in DISTORTIONS.items():
        lps, ssims = [], []
        for s in strengths:
            d = torch.as_tensor(distort(img, kind, s))
            lps.append(float(lpips(d, ref)))
            ssims.append(float(ssim(d, ref)))
        rank_strength = list(range(len(strengths)))
        out[kind] = {
            "strengths": strengths, "lpips": lps, "ssim": ssims,
            "spearman_lpips_vs_strength": spearman(lps, rank_strength),
            "spearman_ssim_vs_strength": spearman(
                [-s for s in ssims], rank_strength)}
        all_lp.extend(lps)
        all_ds.extend(1.0 - np.asarray(ssims))
    out["cross_family_spearman_lpips_vs_1m_ssim"] = spearman(all_lp, all_ds)
    return out
