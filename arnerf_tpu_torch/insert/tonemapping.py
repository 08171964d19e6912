"""HDR tonemapping operators (port of arnerf_tpu/insert/tonemapping.py;
reference insert/tonemapping.py). Tensor in, tensor out; the default
operator is gamma, as in the reference (tonemapping.py:32-33). Reinhard is
OpenCV's operator written in torch, with no image library."""

import math

import numpy as np
import torch


def tonemapping_simple_log(im):
    return torch.log(1.0 + 5000.0 * im) / math.log(1.0 + 5000.0)


def tonemapping_simple_gamma(im):
    return torch.pow(im / (1 + im), 1.0 / 2.2)


def tonemapping_simple_linear(im):
    return torch.pow(torch.clamp(im, 0, 1), 1.0 / 2.2)


DBL_EPSILON = 2.220446049250313e-16


def _linear_map(im):
    """OpenCV's Tonemap (gamma 1): (im - min) / (max - min), left as it is
    when max - min <= DBL_EPSILON."""
    lo, hi = torch.aminmax(im)
    if float(hi) - float(lo) <= DBL_EPSILON:
        return im
    return (im - lo) / (hi - lo)


def _f32(x) -> float:
    """x (a number or a one-element tensor on any device) rounded to
    float32, as OpenCV's float casts round it."""
    return float(np.float32(float(x)))


def tonemapping_complex_reinhard(im):
    """OpenCV's Reinhard operator (TonemapReinhardImpl::process, opencv
    modules/photo/src/tonemap.cpp) with the JAX package's parameters
    (cv2.createTonemapReinhard(2.2, 1, 0.5, 0): gamma 2.2, intensity 1,
    light_adapt 0.5, color_adapt 0) on (H, W, 3) float32 RGB, on the
    tensor's device. Sums and means accumulate in float64, as OpenCV's
    do. A constant image gives NaN everywhere (0/0 in the key), as OpenCV
    does. Departure: the linear maps give exactly 0 at the image's
    smallest value, where OpenCV's float32 scale-and-shift can land a hair
    below 0 and its gamma then returns NaN."""
    img = _linear_map(torch.as_tensor(im, dtype=torch.float32))
    gray = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    log_img = torch.log(torch.clamp(gray, min=1e-4))
    log_mean = _f32(log_img.double().mean())
    log_min, log_max = (float(x) for x in torch.aminmax(log_img))
    with np.errstate(divide="ignore", invalid="ignore"):   # IEEE, as C++
        key = _f32(np.float64(log_max - log_mean)
                   / np.float64(log_max - log_min))
        map_key = _f32(0.3 + 0.7 * np.float64(key) ** 1.4)
    # color_adapt 0: every channel adapts to the gray level, light_adapt
    # 0.5 halfway between the pixel's and the image's mean
    gray_mean = _f32(gray.double().mean())
    adapt = torch.pow(math.exp(-1.0) * (0.5 * gray + 0.5 * gray_mean),
                      map_key)[..., None]
    return torch.pow(_linear_map(img * (1.0 / (adapt + img))), 1.0 / 2.2)


tonemapping_simple = tonemapping_simple_gamma
