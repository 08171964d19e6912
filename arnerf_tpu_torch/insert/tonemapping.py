"""HDR tonemapping operators (port of arnerf_tpu/insert/tonemapping.py;
reference insert/tonemapping.py). Tensor in, tensor out; the default
operator is gamma, as in the reference (tonemapping.py:32-33)."""

import math

import torch


def tonemapping_simple_log(im):
    return torch.log(1.0 + 5000.0 * im) / math.log(1.0 + 5000.0)


def tonemapping_simple_gamma(im):
    return torch.pow(im / (1 + im), 1.0 / 2.2)


def tonemapping_simple_linear(im):
    return torch.pow(torch.clamp(im, 0, 1), 1.0 / 2.2)


tonemapping_simple = tonemapping_simple_gamma
