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


def _f32_rows(edge):
    """Rows at an edge of the f32 kernel's tiling on this card, from its
    library: "tile-1" .. "wave+1", where a wave is one tile for every
    row-tile group of every resident block."""
    import chip_smoke
    shape = chip_smoke.f32_head_shape()
    unit, delta = edge[:4], edge[4:]
    return shape[f"{unit}_rows"] + int(delta or 0)


@pytest.mark.parametrize("n", [
    1, 127, 2051, (1 << 18) + 5,
    # the tiling's edges: one tile -1, +0, +1; one wave -1, +1; the bake's
    # launch; the 2M render round, ragged
    "tile-1", "tile", "tile+1", "wave-1", "wave+1", 1 << 20, (1 << 21) + 3])
def test_kernel_matches_plain_f32(dev, n):
    if isinstance(n, str):
        n = _f32_rows(n)
    w = _weights(dev)
    feats, sh = _inputs(n, dev)
    t_fused.reset_launches()
    h, rgb = t_fused.fused_field_head(feats, sh, w, torch.float32)
    torch.cuda.synchronize()
    assert t_fused.launches == 1
    h_p, rgb_p = t_fused._head_torch(feats, sh, w, torch.float32)
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-5)


def test_f32_head_zero_sh(dev):
    """sh = 0: rgb comes from h @ V0[16:] alone, so a V0 row staged in the
    wrong half cannot hide behind the sh terms."""
    w = _weights(dev, 11)
    feats, sh = _inputs(4099, dev, 12)
    sh = torch.zeros_like(sh)
    h, rgb = t_fused.fused_field_head(feats, sh, w, torch.float32)
    h_p, rgb_p = t_fused._head_torch(feats, sh, w, torch.float32)
    assert float(rgb_p.abs().max()) > 0
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rgb, rgb_p, rtol=1e-4, atol=1e-5)


def test_f32_head_dead_sigma_layer(dev):
    """W0 >= 0 and feats < 0: relu(feats @ W0) is 0 on every row, so h must
    be exactly 0 and rgb comes from sh @ V0[:16] alone."""
    w = list(_weights(dev, 13))
    w[0] = w[0].abs()
    feats, sh = _inputs(4099, dev, 14)
    feats = -feats.abs() - 1e-3
    h, rgb = t_fused.fused_field_head(feats, sh, tuple(w), torch.float32)
    h_p, rgb_p = t_fused._head_torch(feats, sh, tuple(w), torch.float32)
    assert float(h.abs().max()) == 0.0
    assert float(rgb_p.abs().max()) > 0
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


def test_ar_frame_on_the_card_matches_the_cpu(dev, tmp_path, monkeypatch):
    """One AR frame through the insertor on the card (the fused head in f32,
    every NeRF render of the frame) and on the CPU (plain versions), from
    the same weights, occupancy, light, SSDF volume and object raster: the
    SH probe, then the SG frame with self-shadow and the SSDF shadow. The
    segment sum must not run (the normals' gradient is the positions').
    The kernel takes the full-width head (16 levels x 2 features); the
    table and the grid are small. Sum orders differ: 1e-3 absolute on the
    probe and the normals, 5e-3 on the SG frame, whose lobes turn input
    roundings into up to ~5e-4 (chip_smoke.py's check and tolerances)."""
    from dataclasses import replace
    from arnerf_tpu_torch.insert import main as im
    from arnerf_tpu_torch.insert import sg_shadow
    from arnerf_tpu_torch.opt import get_opts
    from arnerf_tpu_torch.rendering import render_surface_normal
    monkeypatch.chdir(tmp_path)
    tab = sg_shadow.compute_fh_table(theta_num=64, lbd_num=256, zeta_num=32)
    monkeypatch.setattr(sg_shadow, "get_fh_table", lambda: tab)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "pca.npz",
             coeff=rng.normal(0, 0.02, (20 ** 3, 128)).astype(np.float32),
             component=rng.normal(0, 0.05, (128, 74, 148)).astype(np.float32),
             mean=np.full((1, 74, 148), 0.3, np.float32))
    G = 32
    g = (np.arange(G) + 0.5) / G * 2 - 1
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    occ = torch.from_numpy((np.sqrt(X ** 2 + Y ** 2 + Z ** 2) < 0.6)
                           .astype(np.uint8).reshape(-1))
    normals = rng.normal(size=(8, 8, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    depths = rng.uniform(0.8, 1.6, (8, 8)).astype(np.float32)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    sgs = np.concatenate([axes, rng.uniform(2, 30, (6, 1)),
                          rng.uniform(0.1, 1.5, (6, 3))], -1) \
        .astype(np.float32)
    outs = []
    for d in ("cuda", "cpu"):
        ins = im.NGPInsertor(get_opts([
            "--dataset_name", "synthetic", "--downsample", "0.1875",
            "--exp_name", f"ar_{d}", "--device", d, "--compute_dtype",
            "float32", "--grid_size", str(G), "--log2_hashmap_size",
            "14"]))
        ins.cfg = replace(ins.cfg, fused_head=True)
        ins.grid_state = ins.grid_state._replace(occ_flat=occ.to(ins.device))
        ins.global_sh[0, 0] = 0.5
        ins.set_sg_shadow(str(tmp_path / "pca.npz"))
        t_fused.reset_launches()
        t_seg.reset_launches()
        sh = ins.generate_probe([0.0, 0.05, 0.0], sh_probe=True)
        pose = ins.dataset.poses[1]
        frame = ins.render_insert_object(
            normals, depths, pose, sgs, 0.6, 0.4, model_bbox=[[6, 8],
                                                              [14, 16]],
            model_bbox_last=None, model_radius=0.3,
            model_pos=[0.0, 0.05, 0.0], model_rot_inv=np.eye(3), gen_shadow=1)
        n = render_surface_normal(ins.params, torch.rand(
            (500, 3), generator=torch.Generator().manual_seed(1)).to(
                ins.device) - 0.5, ins.cfg)
        if d == "cuda":
            torch.cuda.synchronize()
            assert t_fused.launches > 0
            assert t_seg.launches == {"pack": 0, "exact": 0}
        outs.append((sh.cpu().numpy(), frame, n.cpu().numpy()))
    assert outs[0][1].shape == (24, 24, 3) and np.isfinite(outs[0][1]).all()
    for a, b, tol in zip(*outs, (1e-3, 5e-3, 1e-3)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# exact hash-grid encode, forward (csrc/hashgrid.cu)
# ---------------------------------------------------------------------------

def _hash_cfg(kind):
    from arnerf_tpu_torch.ops import hashgrid as hg
    levels, log2_t, base, scale = {
        "synthetic": (16, 19, 16, 0.5), "unbounded": (16, 19, 16, 16.0),
        "small": (4, 12, 4, 0.5)}[kind]
    return hg.HashGridConfig(
        n_levels=levels, log2_hashmap_size=log2_t, base_resolution=base,
        per_level_scale=hg.ngp_growth_factor(scale, levels, base))


def _hash_points(cfg, n, seed):
    """Uniform points in [0, 1]^3 led by points on level-cell boundaries
    (x*s + 0.5 integral), points outside [0, 1] (clamped), 0 and 1, as
    tests/test_torch_ops.py's _encode_points; cut to n rows."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (max(n, 18), 3)).astype(np.float32)
    for l, s in enumerate(cfg.scales[:6]):
        x[l, :] = np.float32((np.floor(0.3 * s) + 0.5) / s)
    x[8:16] = rng.uniform(-0.5, 1.5, (8, 3)).astype(np.float32)
    x[16] = [0.0, 1.0, 0.0]
    x[17] = [1.0, 1.0, 1.0]
    return torch.from_numpy(x[:n].copy())


def _hash_table(cfg, dtype, dev, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((cfg.total_entries, 2), generator=g) * 2 - 1) \
        .to(dtype).to(dev)


@pytest.mark.parametrize("n", [0, 1, 1 << 18, (1 << 18) + 3])
@pytest.mark.parametrize("kind", ["synthetic", "unbounded", "small"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hashgrid_kernel_matches_plain(dev, dtype, kind, n):
    """The kernel against the plain version on the card: bit for bit equal
    to the plain products summed in the corner order of _CORNERS, and
    within the bound on two orders of an 8-term float32 sum (7 eps x the
    sum of |products|; a bf16 table one bf16 ulp more) of
    _encode_fwd_impl, whose torch.sum takes another order: near a sum that
    cancels to 0, ulps of the sum itself say nothing. One launch a call,
    none for no rows."""
    import chip_smoke
    from arnerf_tpu_torch.ops import hashgrid as hg
    cfg = _hash_cfg(kind)
    table = _hash_table(cfg, dtype, dev)
    x = _hash_points(cfg, n, 10 + n).to(dev)
    hg.reset_launches()
    out = hg.hashgrid_encode(table, x, cfg)
    torch.cuda.synchronize()
    assert hg.launches == int(n > 0)
    assert out.dtype == dtype and out.shape == (n, cfg.out_dim)
    off, gap = chip_smoke.hashgrid_gaps(out, table, x, cfg)
    assert off == 0
    assert gap <= 7.0


def test_hashgrid_gradients_with_the_kernel_forward(dev, monkeypatch):
    """Table and position gradients through hashgrid_encode, whose
    cotangent depends on the forward (loss = <out, g> + |out|^2 / 2), with
    the kernel's forward and with the plain one on the card. The backward
    is the plain one on both sides; its table sum runs atomics, in another
    order each run: 1e-5 of the largest entry."""
    from arnerf_tpu_torch.ops import hashgrid as hg
    cfg = _hash_cfg("synthetic")
    table = _hash_table(cfg, torch.float32, dev)
    x = _hash_points(cfg, 4099, 5).to(dev)
    g = torch.randn((4099, cfg.out_dim),
                    generator=torch.Generator().manual_seed(6)).to(dev)

    def grads():
        t = table.clone().requires_grad_()
        xx = x.clone().requires_grad_()
        out = hg.hashgrid_encode(t, xx, cfg)
        ((out * g).sum() + 0.5 * (out * out).sum()).backward()
        return t.grad, xx.grad

    hg.reset_launches()
    kt, kx = grads()
    assert hg.launches == 1
    monkeypatch.setattr(hg, "_encode_forward", hg._encode_fwd_impl)
    pt, px = grads()
    assert hg.launches == 1
    torch.testing.assert_close(kt, pt, rtol=0,
                               atol=1e-5 * float(pt.abs().max()))
    torch.testing.assert_close(kx, px, rtol=0,
                               atol=1e-5 * float(px.abs().max()))


def test_hashgrid_wrapper_refuses_bad_inputs(dev):
    from arnerf_tpu_torch.ops import hashgrid as hg
    cfg = _hash_cfg("small")
    table = _hash_table(cfg, torch.float32, dev)
    x = _hash_points(cfg, 64, 1).to(dev)
    f4 = hg.HashGridConfig(n_levels=4, n_features=4, log2_hashmap_size=12,
                           base_resolution=4,
                           per_level_scale=cfg.per_level_scale)
    with pytest.raises(ValueError, match="F = 2"):
        hg.hashgrid_encode(torch.zeros((f4.total_entries, 4), device=dev),
                           x, f4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        hg.hashgrid_encode(table.half(), x, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        hg.hashgrid_encode(table, x.t().contiguous().t(), cfg)
    with pytest.raises(ValueError, match="x is on cpu"):
        hg.hashgrid_encode(table, x.cpu(), cfg)


# ---------------------------------------------------------------------------
# test-time march (csrc/marching.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_candidates", [97, 512])
@pytest.mark.parametrize("n_samples", [1, 32, 64])
@pytest.mark.parametrize("mode", ["single", "coarse", "coarse_truncated",
                                  "multi_cascade", "coarse_odd_scale",
                                  "multi_cascade_odd_scale"])
def test_march_kernel_matches_plain(dev, mode, n_samples, n_candidates):
    """The kernel against the plain version on the same CUDA tensors,
    torch.equal on every output (the kernel repeats the plain version's
    float32 operations); one launch a call."""
    import chip_smoke
    from arnerf_tpu_torch.ops import marching
    args, kw = chip_smoke.march_inputs(mode, dev)
    kw.update(n_candidates=n_candidates, n_samples=n_samples)
    marching.reset_launches()
    got = marching.march_rays_test(*args, **kw)
    torch.cuda.synchronize()
    assert marching.launches == 1
    want = marching._march_rays_test_plain(*args, **kw)
    assert marching.launches == 1
    names = ("xyzs", "deltas", "ts", "n_eff", "t_next")
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if not torch.equal(a, b):
            bad = (a != b).reshape(a.shape[0], -1).any(dim=1)
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {a.shape[0]} rays differ, "
                f"first {int(torch.nonzero(bad)[0, 0])}")
    n_eff = got[3]
    assert int(n_eff.sum()) > 0
    assert bool((n_eff == 0).any())
    if n_samples == 1:
        assert bool((n_eff == 1).any())
    if mode == "coarse_truncated":     # truncated rays stop short of t2
        t2 = args[3]
        assert bool(((n_eff < n_samples) & (got[4] < t2)).any())


def test_march_kernel_without_rays(dev):
    import chip_smoke
    from arnerf_tpu_torch.ops import marching
    args, kw = chip_smoke.march_inputs("coarse", dev, n=8)
    args = tuple(a[:0] for a in args[:4]) + args[4:]
    marching.reset_launches()
    out = marching.march_rays_test(*args, n_candidates=512, n_samples=32,
                                   **kw)
    assert marching.launches == 0
    assert [tuple(x.shape) for x in out] == [(0, 32, 3), (0, 32), (0, 32),
                                             (0,), (0,)]


def _view_scene(dev):
    """Full-width seeded weights at the view's scale, the analytic
    occupancy, and march_inputs' 128 x 128 rays around the box."""
    import chip_smoke
    from arnerf_tpu_torch.datasets.synthetic import analytic_occupancy
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init, ngp_init
    cfg = NGPConfig(scale=0.5)
    params = ngp_init(cfg, torch.Generator().manual_seed(0), dev)
    occ = analytic_occupancy(cfg.scale, cfg.grid_size, cfg.cascades,
                             device=dev)
    state = grid_state_init(cfg, dev)._replace(occ_flat=occ)
    (o, d, *_), _ = chip_smoke.march_inputs("coarse", dev, n=128 * 128,
                                            seed=21)
    return cfg, params, state, o, d


def test_first_hit_and_render_through_the_kernel(dev, monkeypatch):
    """first_hit and render_test(fast=True) at the view's settings: the
    same alive set, first t, image and sample total through the kernel as
    through the plain version, with launches only on the kernel's side."""
    from arnerf_tpu_torch import rendering
    from arnerf_tpu_torch.ops import marching
    cfg, params, state, o, d = _view_scene(dev)
    view = dict(fast=True, max_samples=96, samples_per_round=32,
                T_threshold=1e-2, chunk=4096)
    hits = rendering.scene_hits(o, d, cfg)
    coarse = rendering._coarse_occupancy(state, cfg, 0.0, 96, 1.0)

    def run():
        fh = rendering.first_hit(state.occ_flat, coarse, o, d, hits, cfg,
                                 max_samples=96, n_candidates=97,
                                 dt_scale=1.0)
        return fh, rendering.render_test(params, state, o, d, cfg, **view)

    marching.reset_launches()
    (alive, t_first), img = run()
    torch.cuda.synchronize()
    kernel_launches = marching.launches
    monkeypatch.setattr(rendering, "march_rays_test",
                        marching._march_rays_test_plain)
    (alive_p, t_first_p), img_p = run()
    assert marching.launches == kernel_launches > 0
    assert torch.equal(alive, alive_p) and torch.equal(t_first, t_first_p)
    assert bool(alive.any()) and not bool(alive.all())
    assert img["total_samples"] == img_p["total_samples"] > 0
    for key in ("rgb", "depth", "opacity"):
        assert torch.equal(img[key], img_p[key]), key


def test_march_wrapper_refuses_bad_inputs(dev):
    import chip_smoke
    from arnerf_tpu_torch.ops import marching
    (o, d, t_cur, t2, occ), kw = chip_smoke.march_inputs("coarse", dev, n=64)
    kw.update(n_candidates=512, n_samples=32)
    march = marching.march_rays_test
    with pytest.raises(ValueError, match="inputs on"):
        march(o, d, t_cur, t2, occ.cpu(), **kw)
    with pytest.raises(ValueError, match="rays_d must be"):
        march(o, d.double(), t_cur, t2, occ, **kw)
    with pytest.raises(ValueError, match="rays_o must be"):
        march(o[:, :2], d, t_cur, t2, occ, **kw)
    with pytest.raises(ValueError, match="t2 must be"):
        march(o, d, t_cur, t2[:-1], occ, **kw)
    with pytest.raises(ValueError, match="occ_flat must be"):
        march(o, d, t_cur, t2, occ.int(), **kw)
    with pytest.raises(ValueError, match="occ_coarse must be"):
        march(o, d, t_cur, t2, occ, **{**kw, "occ_coarse": occ[:64]})
    with pytest.raises(ValueError, match="1 to 2"):
        march(o, d, t_cur, t2, occ, **{**kw, "n_samples": 0})
