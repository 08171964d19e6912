"""The port's CUDA kernels on the card: each kernel against its plain
version, and the wrapper's refusals. These need an NVIDIA GPU and nvcc;
elsewhere they skip (the decision is made in a fixture, at run time).

Run on the card: python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from arnerf_tpu_torch.ops import fused_head as t_fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.rand(s, generator=g) * 2 - 1).mul(
        float(np.sqrt(6.0 / s[0]))).to(dev) for s in t_fused.HEAD_SHAPES)


def _inputs(n, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 32), generator=g).mul(0.5).to(dev),
            torch.randn((n, 16), generator=g).mul(0.5).to(dev))


@pytest.mark.parametrize("n", [1, 127, 2051, (1 << 18) + 5])
def test_kernel_matches_plain_f32(dev, n):
    w = _weights(dev)
    feats, sh = _inputs(n, dev)
    t_fused.reset_launches()
    h, rgb = t_fused.fused_field_head(feats, sh, w, torch.float32)
    torch.cuda.synchronize()
    assert t_fused.launches == 1
    h_p, rgb_p = t_fused._head_torch(feats, sh, w, torch.float32)
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("feats_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_bf16(dev, feats_dtype):
    w = _weights(dev, 2)
    feats, sh = _inputs(4099, dev, 3)
    feats = feats.to(feats_dtype)
    h, rgb = t_fused.fused_field_head(feats, sh, w, torch.bfloat16)
    h_p, rgb_p = t_fused._head_torch(feats, sh, w, torch.bfloat16)
    torch.testing.assert_close(h, h_p, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(rgb, rgb_p, rtol=2e-2, atol=2e-2)


def test_wrapper_refuses_bad_inputs(dev):
    w = _weights(dev)
    feats, sh = _inputs(64, dev)
    with pytest.raises(ValueError, match="shape"):
        t_fused.fused_field_head(feats[:, :16].contiguous(), sh, w)
    with pytest.raises(ValueError, match="contiguous"):
        t_fused.fused_field_head(feats.t().contiguous().t(), sh, w)
    with pytest.raises(ValueError, match="dtype"):
        t_fused.fused_field_head(feats, sh.double(), w)
    with pytest.raises(ValueError, match="on cpu"):
        t_fused.fused_field_head(feats, sh.cpu(), w)
    with pytest.raises(ValueError, match="bfloat16 feats"):
        t_fused.fused_field_head(feats.bfloat16(), sh, w, torch.float32)
