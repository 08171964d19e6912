"""Image quality metrics (port of arnerf_tpu/training/metrics.py: PSNR,
SSIM and LPIPS; the reference uses torchmetrics, train.py:68-74). LPIPS
always takes the port's own net (training/lpips.py): there is no
torchmetrics branch."""

import numpy as np
import torch


def mse(pred, gt):
    return torch.mean((pred - gt) ** 2)


def psnr(pred, gt, data_range: float = 1.0):
    return 10.0 * torch.log10(data_range ** 2 / mse(pred, gt))


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img, k):
    """Separable gaussian with 'valid' windowing over (H, W, C): written as
    shifted sums so float32 stays float32 on every device (a cuDNN
    convolution would run in TF32)."""
    n = len(k)
    H, W = img.shape[0] - n + 1, img.shape[1] - n + 1
    rows = sum(float(k[i]) * img[:, i:i + W] for i in range(n))
    return sum(float(k[i]) * rows[i:i + H] for i in range(n))


def ssim(pred, gt, data_range: float = 1.0):
    """Standard SSIM, 11x11 gaussian window, per-channel mean.
    pred, gt: (H, W, C) in [0, data_range]."""
    k = _gaussian_kernel()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu_p, mu_g = _blur(pred, k), _blur(gt, k)
    mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
    # clamp the E[x^2]-E[x]^2 variances at 0 and the covariance by
    # Cauchy-Schwarz (float32 cancellation on flat regions, see JAX twin)
    sigma_p = torch.clamp(_blur(pred * pred, k) - mu_pp, min=0.0)
    sigma_g = torch.clamp(_blur(gt * gt, k) - mu_gg, min=0.0)
    sigma_pg = _blur(pred * gt, k) - mu_pg
    bound = torch.sqrt(sigma_p * sigma_g)
    sigma_pg = torch.minimum(torch.maximum(sigma_pg, -bound), bound)
    s = ((2 * mu_pg + C1) * (2 * sigma_pg + C2)) / \
        ((mu_pp + mu_gg + C1) * (sigma_p + sigma_g + C2))
    return torch.mean(s)


class LpipsValue(float):
    """A float LPIPS value that says whether trained features produced it:
    `label` is `lpips_vgg` with the official weights and `lpips_rand` with
    the random-feature net, whose values are not comparable to published
    LPIPS(vgg) tables (training/lpips.py)."""
    trained: bool = False

    def __new__(cls, value, trained):
        v = super().__new__(cls, value)
        v.trained = bool(trained)
        return v

    @property
    def label(self):
        return "lpips_vgg" if self.trained else "lpips_rand"


_LPIPS_PARAMS = {}     # device -> the net's parameters, built once


def lpips(pred, gt):
    """LPIPS of two (H, W, 3) tensors in [0, 1] on one device, with the
    official weights when they are present, else the random-feature net."""
    from .lpips import lpips_distance, lpips_params
    dev = pred.device
    if dev not in _LPIPS_PARAMS:
        _LPIPS_PARAMS[dev] = lpips_params(device=dev)
    params = _LPIPS_PARAMS[dev]
    return LpipsValue(float(lpips_distance(params, pred, gt)),
                      params["trained"])
