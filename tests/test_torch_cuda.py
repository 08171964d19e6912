"""The port's CUDA kernels on the card: each kernel against its plain
version, and the wrappers' refusals. These need an NVIDIA GPU and nvcc;
elsewhere they skip (the decision is made in a fixture, at run time).

Run on the card: python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from arnerf_tpu_torch.ops import fused_head as t_fused
from arnerf_tpu_torch.ops import segments as t_seg

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


@pytest.mark.parametrize("feats_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4099, (1 << 18) + 5])
def test_tensor_core_head_matches_plain(dev, n, feats_dtype):
    """The bf16 mode runs on the tensor cores in 16-row tiles; n covers one
    partial tile, a whole one, one row past it and ragged tails. Every
    element is held to rtol/atol 2e-2; on top, h and rgb are held to a
    relative Frobenius error of 1e-3. Products of bf16 values are exact in
    f32 on both sides, but the tensor cores sum in another order than
    cuBLAS, so a hidden activation near a bf16 rounding boundary may round
    the other way and move a few outputs by a bf16 ulp of its weight; the
    norm bound shows that such flips stay rare."""
    w = _weights(dev, 9)
    feats, sh = _inputs(n, dev, 10)
    feats = feats.to(feats_dtype)
    t_fused.reset_launches()
    h, rgb = t_fused.fused_field_head(feats, sh, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert t_fused.launches == 1
    h_p, rgb_p = t_fused._head_torch(feats, sh, w, torch.bfloat16)
    for got, want in ((h, h_p), (rgb, rgb_p)):
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
        rel = float(torch.linalg.norm(got - want)
                    / torch.linalg.norm(want).clamp(min=1e-30))
        assert rel <= 1e-3, f"relative Frobenius error {rel}"


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


def test_fused_head_gradients_with_kernel_forward(dev):
    """The forward launches the kernel; the backward recomputes through the
    plain version, so the gradients equal the plain version's."""
    for dtype in (torch.float32, torch.bfloat16):
        w = [x.clone().requires_grad_() for x in _weights(dev, 4)]
        feats, sh = (t.requires_grad_() for t in _inputs(5000, dev, 5))
        g = torch.Generator(device=dev).manual_seed(6)
        gh = torch.randn((5000, 16), generator=g, device=dev)
        grgb = torch.randn((5000, 3), generator=g, device=dev)
        t_fused.reset_launches()
        h, rgb = t_fused.fused_field_head(feats, sh, w, dtype)
        assert t_fused.launches == 1
        got = torch.autograd.grad((h, rgb), [feats, sh, *w], (gh, grgb))
        h_p, rgb_p = t_fused._head_torch(feats, sh, w, dtype)
        want = torch.autograd.grad((h_p, rgb_p), [feats, sh, *w],
                                   (gh, grgb))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _assert_sums_close(out, idx, vals, rows, pack):
    """Atomics add in another order every run, so f32 sums agree to a bound,
    not bit for bit. Each row is held to 1e-6 of the sum of its terms'
    magnitudes (~17 ulps of that sum): two summation orders of n terms stay
    well inside it, from a few terms to the ~37,500 of a colliding row."""
    ref = t_seg._segment_sum_torch(idx, vals, rows, pack)
    mag = t_seg._segment_sum_torch(idx, vals.abs(), rows, pack)
    err = (out - ref).abs()
    worst = float((err / (mag + 1e-30)).max())
    assert bool((err <= 1e-6 * mag).all()), f"error / magnitude {worst}"


def _updates(m, rows, f, dev, seed, collide=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    if collide:   # most updates on a handful of rows, as the coarse levels
        idx = torch.randint(0, 8, (m,), generator=g, device=dev)
    else:
        idx = torch.randint(0, rows, (m,), generator=g, device=dev)
    drop = torch.rand(m, generator=g, device=dev) < 0.05
    idx = torch.where(drop, -1, idx)
    idx[:3] = rows + 5                           # past the table: skipped
    vals = torch.randn((f, m), generator=g, device=dev).t()  # strided (M, F)
    return idx.to(torch.int32), vals


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("f,collide", [(1, False), (2, False), (2, True),
                                       (16, False)])
def test_segment_sum_kernel_matches_plain(dev, pack, f, collide):
    """-1 rows, rows past the table, and (collide) ~37,500 updates on each
    of 8 rows; tolerance in _assert_sums_close."""
    rows = 5000
    idx, vals = _updates(300_001, rows, f, dev, 7 + f, collide)
    t_seg.reset_launches()
    out = t_seg.segment_sum(idx, vals, rows, pack=pack)
    torch.cuda.synchronize()
    assert t_seg.launches == {"pack": int(pack), "exact": int(not pack)}
    _assert_sums_close(out, idx, vals, rows, pack)


def _grouped_updates(n, groups, f, rows, dev, seed, runs):
    """(n, groups) rows, sample-major, with -1 rows and rows past the
    table. runs: each column walks a sorted ray-like sequence, so equal
    rows come in runs of up to ~40 samples (the coarse levels along a
    ray); else random rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if runs:
        steps = torch.rand((n, groups), generator=g, device=dev) < 0.05
        idx = (torch.cumsum(steps.long(), 0)
               + torch.randint(0, rows, (1, groups), generator=g,
                               device=dev)) % rows
    else:
        idx = torch.randint(0, rows, (n, groups), generator=g, device=dev)
    drop = torch.rand((n, groups), generator=g, device=dev) < 0.03
    idx = torch.where(drop, -1, idx)
    idx[:2, :] = rows + 7                           # past the table: skipped
    vals = torch.randn((n * groups, f), generator=g, device=dev)
    return idx.to(torch.int32).contiguous(), vals


@pytest.mark.parametrize("runs", [True, False])
@pytest.mark.parametrize("f", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("groups", [1, 16, 128])
def test_segment_sum_grouped_matches_plain(dev, groups, f, runs):
    """2-D idx (N, G): the kernel merges runs of equal rows down each column
    before its atomics. Both modes, sorted runs and random rows, -1 rows
    and rows past the table; tolerance in _assert_sums_close."""
    rows = 3000
    idx, vals = _grouped_updates(20_011, groups, f, rows, dev,
                                 100 * groups + f, runs)
    for pack in (False, True):
        t_seg.reset_launches()
        out = t_seg.segment_sum(idx, vals, rows, pack=pack)
        torch.cuda.synchronize()
        assert t_seg.launches == {"pack": int(pack), "exact": int(not pack)}
        _assert_sums_close(out, idx.reshape(-1), vals, rows, pack)


def test_dense_segment_sum_batched_on_the_card(dev):
    """The batched API quantises on the card with pack=True only."""
    sizes = (4096, 70_000, 1 << 19)
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.stack([torch.randint(0, s, (100_000,), generator=g,
                                     device=dev) for s in sizes])
    cols = torch.randn((2, 3, 100_000), generator=g, device=dev)
    offs = torch.tensor([0, 4096, 4096 + 70_000], device=dev)[:, None]
    flat = (idx + offs).reshape(-1).to(torch.int32)
    vals = cols.reshape(2, -1).t()
    for pack in (False, True):
        out = t_seg.dense_segment_sum_batched(idx, cols, sizes, pack=pack)
        _assert_sums_close(out, flat, vals, sum(sizes), pack)


@pytest.mark.parametrize("stoch", [False, True])
def test_hashgrid_table_gradient_through_the_kernel(dev, stoch):
    """The hash-grid backward on the card launches the segment sum once
    (exact mode; pack mode with stochastic corners) and matches the CPU's
    plain backward. Pack rounds the cotangents to bf16, so the CPU side is
    given them rounded. Sum order differs: 1e-5 of the largest entry."""
    from arnerf_tpu_torch.ops import hashgrid as hg
    cfg = hg.HashGridConfig(n_levels=4, log2_hashmap_size=12,
                            base_resolution=4,
                            per_level_scale=hg.ngp_growth_factor(0.5, 4, 4))
    g = torch.Generator().manual_seed(8)
    table = torch.rand((cfg.total_entries, 2), generator=g) * 2 - 1
    x = torch.rand((3000, 3), generator=g) * 1.1 - 0.05
    gout = torch.randn((3000, cfg.out_dim), generator=g)
    seed = 12345 if stoch else None
    grads = {}
    for d in (dev, torch.device("cpu")):
        t = table.to(d).requires_grad_()
        go = gout.bfloat16().float() if stoch and d.type == "cpu" else gout
        t_seg.reset_launches()
        hg.hashgrid_encode(t, x.to(d), cfg, seed=seed).backward(go.to(d))
        grads[d.type] = (t.grad.cpu(), dict(t_seg.launches))
    assert grads["cuda"][1] == {"pack": int(stoch), "exact": int(not stoch)}
    want = grads["cpu"][0]
    torch.testing.assert_close(grads["cuda"][0], want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_segment_sum_wrapper_refuses_bad_inputs(dev):
    idx, vals = _updates(64, 10, 2, dev, 1)
    with pytest.raises(ValueError, match="int32"):
        t_seg.segment_sum(idx.long(), vals, 10)
    with pytest.raises(ValueError, match="float32"):
        t_seg.segment_sum(idx, vals.double(), 10)
    with pytest.raises(ValueError, match="columns"):
        t_seg.segment_sum(idx, torch.zeros((64, 17), device=dev), 10)
    with pytest.raises(ValueError, match="rows of idx"):
        t_seg.segment_sum(idx[:10], vals, 10)
    with pytest.raises(ValueError, match="idx is on cpu"):
        t_seg.segment_sum(idx.cpu(), vals, 10)
