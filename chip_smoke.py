#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (arnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases (all run, even after a failure; any failure exits non-zero):
  1. build     - compile every CUDA kernel from csrc/ with nvcc (sm_90a)
                 and the host image decoder (csrc/dataio.cpp) with c++, all
                 compilers started together; fails if ptxas reports a
                 spill.
  2. kernels   - each kernel against its plain PyTorch version on the card,
                 timed beside its bound and a library yardstick: the fused
                 head (forward, and its autograd gradient at 2^18 rows) and
                 the segment sum in pack and exact mode at the training
                 step's shapes, on the real hash mapping of uniform
                 positions in the hash-grid backward's grouped layout.
  3. slice     - the eval entry point (`arnerf_tpu_torch.eval.main`, i.e.
                 render_test(fast=True, max_samples=96, T_threshold=1e-2))
                 renders the synthetic scene's 4 test views at 800x800 with
                 a full-width NGP (16 levels, 2^19 table, 64-wide MLPs) of
                 seeded random weights and the analytic occupancy grid, in
                 bf16 and in f32; the fused-head launch counter must rise.
  4. train     - the train entry point (`arnerf_tpu_torch.train.main`)
                 trains the full-width NGP on the synthetic scene for one
                 1,000-step epoch (batch 8192, 400x400 images, bf16,
                 stochastic corners annealed to exact at step 800, segment
                 pool with sort selection), then the eval entry point
                 renders the checkpoint at 800x800 (f32, as eval runs by
                 default). The segment-sum kernel
                 must run in both modes and the fused head must run; train
                 PSNR must pass 19 dB and validation PSNR 17 dB.
  insert   - the AR insertion server's path at 800x800 from the train
                 phase's checkpoint: NGPInsertor, the surface cache and
                 point cloud over the 24 training poses, plane RANSAC, the
                 probe precompute (cut to INSERT_PROBE_POINTS points), 200
                 global-SH iterations; then NGPServer in a thread behind a
                 real socket, driven by a viewer: the camera, an SSDF
                 volume, INSERT_FRAMES object moves (actions 1, 3, 6 with a
                 sphere's normal/depth raster), a shadow-map frame and a
                 saved frame (PNG + EXR). The fused head must run and the
                 segment sum must not; frames must be finite; one SG and one
                 SH frame at 64x64 in f32 must match the CPU's to 1e-3.
  real_updates - the segment sum in both modes on the updates of one real
                 post-warmup training step of the trained model (captured
                 from the hash-grid backward), against its plain version,
                 timed beside index_add_ and the level-major order.
  baked    - the eval entry point with ARNERF_EVAL_BAKED=1 on the train
                 phase's checkpoint at 800x800: bake_ngp at 256^3 (f32,
                 stochastic corners, the fused head on every chunk), then
                 4 views through render_baked (bricks, 2x2 blocks); the
                 bake must launch the fused head and the views pass 17 dB.
                 Then a 64^3 stochastic bake of the checkpoint on the card
                 and on the CPU (rows to 1e-4 of their largest entry, codes
                 within 1) and a 64x64 trilinear and stochastic render of
                 the CPU's bake on both (1e-4, the same rounds).
  5. reference - a 64x64 view rendered in f32, and one f32 training step at
                 a small size, on the card (kernels) and on the CPU (plain
                 versions) must agree; the compositing's per-ray totals
                 of empty rays must be exactly zero on the card.
  captures - training and evaluation on captures on disk. The script writes
                 two captures of the procedural scene under
                 build/arnerf_tpu_torch/smoke/captures/ (datasets/captures.py,
                 rendered on the card): a Blender-format scene (100 train and
                 8 test RGBA PNGs at 800x800, alpha = opacity, rows filtered
                 with types 0-4 in rotation) and a COLMAP-format scene
                 (sparse/0/*.bin, PINHOLE, 64 PNGs at 1240x824 on black,
                 points on the analytic surface). The loaders must decode
                 every view to the pixels written, after their alpha blend,
                 within 1e-6. The train entry point then runs 1,000 steps on
                 each: nerf at the defaults (batch 8192) with --eval_lpips
                 (a finite lpips_rand), then eval in f32 with --grid_vis,
                 --cam_vis and --mesh (train PSNR > 19 dB, validation > 17
                 dB, all three files, > 0 faces) and again in bf16, and two
                 800x800 LPIPS pairs (a rendered view against its ground
                 truth, and the ground truth against itself shifted by 4
                 pixels) on the card with TF32 allowed around the call and
                 on the CPU (1e-4 relative); colmap
                 with the mip-NeRF 360 outdoor flags (--scale 16: 6
                 cascades, exp stepping; batch 4096, lr 2e-2), then eval (a
                 finite loss at every block, validation > 17 dB) and the
                 baked eval (the multi-cascade bake and renderer, > 17 dB,
                 fused-head launches in the bake). Both kernels must run
                 on both training paths. One f32 training step of the
                 trained scale-16 model must agree card vs CPU to 1e-5.
Then torch.profiler passes over one bf16 view, one baked view, one
post-warmup training block and one AR frame print where their time goes;
the baked view's pass bakes with exact corners and prints that bake's
seconds and its PSNR on the 4 views (measurements only; they fail
nothing).
Prints the card's name and power limit, then one JSON line of per-kernel
numbers, then the result line {"ok": true, "device": {...}}.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM, NVIDIA data sheet: HBM3 rate and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PARITY_ROWS = (1 << 21) + 3     # the 2M-sample render round, ragged
MAIN_PATH_ROWS = 1 << 18        # ngp_forward_chunked's chunk: one launch
TRAIN_SAMPLES = 8192 * 32       # batch x sample budget: one training step
SMOKE_DIR = ROOT / "build" / "arnerf_tpu_torch" / "smoke"
INSERT_FRAMES = 12              # object-move frames through the server
INSERT_PROBE_POINTS = 2048      # planar points of the probe precompute
# card vs CPU at 64x64 in f32, max abs: the SH probe and the SH frame to
# 1e-3; the SG frame to 5e-3, ~10x what rounding its inputs alone moves
# the CPU's frame (insert_card_vs_cpu reports it; 5.2e-4 in a run on an
# H100's host): SG lobes of lambda in the hundreds, and the GGX lobe's at
# grazing angles, turn roundings of the cosines into that much
INSERT_TOL = (1e-3, 5e-3, 1e-3)
TRAIN_ARGV = ["--dataset_name", "synthetic", "--downsample", "3.125",
              "--num_epochs", "1", "--batch_size", "8192",
              "--exp_name", "smoke"]
CAPTURES_DIR = SMOKE_DIR / "captures"
BLENDER_VIEWS = (100, 8)        # train, test: the reference's Blender split
BLENDER_WH = 800                # the Blender scenes' size (datasets/nerf.py)
COLMAP_VIEWS = 64               # every 8th is a test view
COLMAP_WH = (1240, 824)         # about mip-NeRF 360 at --downsample 0.25
BAKE_DIRS = 32                  # bake_ngp's quadrature directions
BAKE_CHECK_RES = 64             # card-vs-CPU bake (B^3 voxels)
CAPTURE_ARGV = {
    # benchmarking/benchmark_synthetic_nerf.sh passes --eval_lpips
    "nerf": ["--dataset_name", "nerf", "--num_epochs", "1",
             "--batch_size", "8192", "--eval_lpips"],
    # mip-NeRF 360's outdoor flags (benchmarking/benchmark_mipnerf360.sh)
    "colmap": ["--dataset_name", "colmap", "--scale", "16", "--batch_size",
               "4096", "--lr", "2e-2", "--num_epochs", "1"]}


def _time_ms(fn, iters):
    """CUDA events around `iters` eager calls: the device time per call, or
    the host's time per call where the host is the slower of the two."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_graph_ms(fn, iters, replays=3):
    """CUDA events around replays of one CUDA graph of `iters` calls: the
    device time per call without the host's launch overhead (the wrappers'
    checks and ctypes calls take tens of microseconds, as long as a
    2^18-row head launch)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _head_weights(dev):
    import torch
    from arnerf_tpu_torch.models import NGPConfig, ngp_init
    from arnerf_tpu_torch.ops.fused_head import head_weights_from_params
    params = ngp_init(NGPConfig(), torch.Generator().manual_seed(0), dev)
    return head_weights_from_params(params)


def _library_head(feats, sh, w):
    """The same function as one cuBLAS matmul + relu chain in the operand
    type (a yardstick only; the port never calls it)."""
    import torch
    w0, w1, v0, v1, v2 = w
    h = torch.relu(feats @ w0) @ w1
    r = torch.relu(torch.cat([sh, h], dim=1) @ v0)
    r = torch.relu(r @ v1)
    return h, r @ v2


def head_kernel_numbers(dtype_name, rows, w, dev):
    """Parity of the fused-head kernel with its plain version at `rows`
    rows, plus kernel / plain / library times and the bound."""
    import torch
    from arnerf_tpu_torch.ops import fused_head as fh
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(rows)
    feats = (torch.randn((rows, 32), generator=g, device=dev) * 0.5).to(dtype)
    sh = torch.randn((rows, 16), generator=g, device=dev) * 0.5
    h, rgb = fh.fused_field_head(feats, sh, w, dtype)
    torch.cuda.synchronize()
    h_p, rgb_p = fh._head_torch(feats, sh, w, dtype)
    err = max(float((h - h_p).abs().max()), float((rgb - rgb_p).abs().max()))
    tol = dict(rtol=1e-4, atol=1e-5) if dtype_name == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(h, h_p, **tol)
    torch.testing.assert_close(rgb, rgb_p, **tol)
    # bf16: a hidden activation near a rounding boundary may round the other
    # way under another f32 sum order; the norm bound keeps that rare
    rel_fro = max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                  for a, b in ((h, h_p), (rgb, rgb_p)))
    if dtype_name == "bfloat16" and rel_fro > 1e-3:
        raise AssertionError(f"fused_head[bfloat16] relative Frobenius "
                             f"error {rel_fro} > 1e-3")
    ms = _time_graph_ms(lambda: fh.fused_field_head(feats, sh, w, dtype), 20)
    eager_ms = _time_ms(lambda: fh.fused_field_head(feats, sh, w, dtype), 20)
    plain_ms = _time_ms(lambda: fh._head_torch(feats, sh, w, dtype), 5)
    wl = tuple(x.to(dtype) for x in w)
    shl = sh.to(dtype)
    library_ms = _time_graph_ms(lambda: _library_head(feats, shl, wl), 10)
    n_w = sum(x.numel() for x in w)
    bytes_moved = (rows * (32 * feats.element_size() + 16 * 4 + 16 * 4
                           + 3 * 4) + n_w * 4)
    flops = 2 * n_w * rows
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"rows": rows, "max_abs_err": err, "rel_frobenius": rel_fro,
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def head_gradient_check(rows, w, dev):
    """The fused head's autograd gradients with the kernel forward against
    the plain version's, in both dtypes. The backward recomputes through
    the plain version, so they must agree to rounding (1e-5)."""
    import torch
    from arnerf_tpu_torch.ops import fused_head as fh
    errs = {}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(rows + 1)
        feats = (torch.randn((rows, 32), generator=g, device=dev) * 0.5) \
            .to(dtype).requires_grad_()
        sh = (torch.randn((rows, 16), generator=g, device=dev) * 0.5) \
            .requires_grad_()
        ws = [x.detach().clone().requires_grad_() for x in w]
        gh = torch.randn((rows, 16), generator=g, device=dev)
        grgb = torch.randn((rows, 3), generator=g, device=dev)
        got = torch.autograd.grad(fh.fused_field_head(feats, sh, ws, dtype),
                                  [feats, sh, *ws], (gh, grgb))
        want = torch.autograd.grad(fh._head_torch(feats, sh, ws, dtype),
                                   [feats, sh, *ws], (gh, grgb))
        errs[dtype_name] = max(float((a.float() - b.float()).abs().max()
                                     / b.float().abs().max().clamp(min=1e-30))
                               for a, b in zip(got, want))
        if errs[dtype_name] > 1e-5:
            raise AssertionError(f"fused-head gradients disagree: {errs}")
    print(f"fused_head gradients (kernel forward vs plain) at {rows} rows: "
          f"max error relative to each leaf's largest entry {errs}",
          flush=True)


def _segment_updates(mode, dev):
    """The training step's segment-sum inputs at full width, in the layout
    the hash-grid backward passes: the real table rows of 262,144 uniform
    positions, (N, L) stochastic corners for pack mode and (N, L*8) corners
    for exact mode, and contiguous (M, 2) f32 values."""
    import torch
    from arnerf_tpu_torch.models import NGPConfig
    from arnerf_tpu_torch.ops import hashgrid as hg
    cfg = NGPConfig().hash_cfg
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.rand((TRAIN_SAMPLES, 3), generator=g, device=dev)
    if mode == "pack":
        flat = hg._stoch_indices(x, 12345, cfg)
    else:
        flat = hg._indices_weights(x, cfg)[0]
    idx = flat.reshape(TRAIN_SAMPLES, -1).to(torch.int32)
    vals = torch.randn((idx.numel(), 2), generator=g, device=dev)
    return idx, vals, cfg.total_entries, cfg.n_levels


def segment_sum_numbers(idx, vals, rows, pack, n_levels, dev,
                        plain_tol=True):
    """segment_sum on grouped updates (idx (N, G)) against its plain
    version, timed beside its bound and `index_add_` (the library call
    computing the same function, on pre-rounded values in pack mode).
    Atomics add in a different order each run, so sums are held to bounds,
    not bit for bit. Every row is held to the float32 bound of a sum of n
    terms in any order, n * 2^-24 * (sum of the terms' magnitudes), against
    a float64 sum of the same (rounded) values. With plain_tol, as on
    uniform positions, each row is also held to 1e-6 of that magnitude sum
    against the plain version (~17 ulps). A real step's coarse rows sum
    thousands of same-signed terms, where two float32 orders may differ by
    more than that, and only the first bound holds. Also times the kernel
    on the same updates in level-major order (1-D), which decides how many
    table rows the atomics in flight touch at once."""
    import torch
    from arnerf_tpu_torch.ops import segments as seg
    mode = "pack" if pack else "exact"
    f = vals.shape[1]
    out = seg.segment_sum(idx, vals, rows, pack=pack)
    torch.cuda.synchronize()
    ref = seg._segment_sum_torch(idx, vals, rows, pack)
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < rows)
    v64 = (vals.to(torch.bfloat16) if pack else vals).double()[ok]
    exact = torch.zeros((rows, f), dtype=torch.float64, device=dev) \
        .index_add_(0, flat[ok], v64)
    mag = torch.zeros((rows, f), dtype=torch.float64, device=dev) \
        .index_add_(0, flat[ok], v64.abs())
    count = torch.bincount(flat[ok], minlength=rows).double()[:, None]
    err64 = (out.double() - exact).abs()
    diff = (out - ref).abs()
    err = float(diff.max())
    scale = float(ref.abs().max())
    order_bound = float((err64 / (count * 2.0 ** -24 * mag + 1e-300)).max())
    if order_bound > 1.0:
        raise AssertionError(f"segment_sum[{mode}] breaks the float32 "
                             f"summation bound: worst error / bound "
                             f"{order_bound}")
    if plain_tol and not bool((diff <= 1e-6 * mag).all()):
        worst = float((diff / (mag + 1e-30)).max())
        raise AssertionError(f"segment_sum[{mode}] disagrees with its plain "
                             f"version: max abs err {err}, worst error / "
                             f"magnitude {worst}")
    ms = _time_graph_ms(lambda: seg.segment_sum(idx, vals, rows, pack=pack),
                        20)
    eager_ms = _time_ms(lambda: seg.segment_sum(idx, vals, rows, pack=pack),
                        20)
    plain_ms = _time_ms(lambda: seg._segment_sum_torch(idx, vals, rows,
                                                       pack), 5)
    lv = vals.to(torch.bfloat16).float() if pack else vals

    def library():    # zero fill included, as in the wrapper's time
        return torch.zeros((rows, f), device=dev).index_add_(0, flat, lv)
    library_ms = _time_graph_ms(library, 20)
    n = idx.shape[0]
    level_major = torch.arange(idx.numel(), device=dev) \
        .reshape(n, n_levels, -1).transpose(0, 1).reshape(-1)
    idx_lm = idx.reshape(-1)[level_major].contiguous()
    vals_lm = vals[level_major].contiguous()
    level_major_ms = _time_graph_ms(
        lambda: seg.segment_sum(idx_lm, vals_lm, rows, pack=pack), 20)
    m = idx.numel()
    bytes_moved = m * 4 + m * f * 4 + rows * f * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = m * f / PEAK_FLOPS["float32"] * 1e3
    return {"updates": m, "groups": idx.shape[1], "max_abs_err": err,
            "scale": scale, "error_over_order_bound": order_bound, "ms": ms,
            "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "level_major_ms": level_major_ms}


def real_segment_updates(trainer, mode, dev):
    """The segment-sum inputs of one real post-warmup training step: the
    trained model's own sample_rays and pooled marcher on a fresh batch,
    the field, the loss, and the hash-grid backward's call to segment_sum,
    captured as the backward makes it (grouped idx, cotangent values).
    'pack' runs the step with stochastic corners, 'exact' without. The
    trainer's state is not changed (no optimizer step, own generators)."""
    from dataclasses import replace
    import torch
    from arnerf_tpu_torch.ops import hashgrid as hg
    from arnerf_tpu_torch.rendering import draw_train_inputs
    from arnerf_tpu_torch.training import trainer as tr
    cfg = replace(trainer.cfg, stoch_corners=mode == "pack")
    tc = trainer.tc
    gen = torch.Generator(device=dev).manual_seed(29)
    rays_o, rays_d, rgb_gt, _ = tr.sample_rays(
        trainer.images, trainer.poses, trainer.directions, tc, gen)
    noise, seed, rgb_bg = draw_train_inputs(
        rays_o.shape[0], dev, generator=gen,
        host_generator=torch.Generator().manual_seed(31),
        stoch=cfg.stoch_corners, random_bg=tc.random_bg)
    captured = []
    segment_sum = hg.segment_sum

    def capture(idx, vals, num_rows, pack=False):
        captured.append((idx, vals.detach(), num_rows, pack))
        return segment_sum(idx, vals, num_rows, pack)
    hg.segment_sum = capture
    try:
        loss, res = tr.step_loss(
            trainer.params, trainer.grid_state, rays_o, rays_d, rgb_gt,
            noise=noise, seed=seed, rgb_bg=rgb_bg, cfg=cfg, tc=tc,
            exp_step_factor=trainer.exp_step_factor, seg_cap=tc.seg_cap)
        torch.autograd.grad(loss, [trainer.params["hash_table"]])
    finally:
        hg.segment_sum = segment_sum
    if len(captured) != 1 or captured[0][3] != (mode == "pack"):
        raise AssertionError(f"expected one {mode} segment sum in the "
                             f"backward, got {[c[3] for c in captured]}")
    idx, vals, rows, _ = captured[0]
    return idx, vals, rows, int(res["rm_samples"])


def run_real_updates(state, dev):
    """segment_sum in both modes on one real training step's updates."""
    trainer = state["trainer"]
    n_levels = trainer.cfg.hash_cfg.n_levels
    for mode in ("pack", "exact"):
        idx, vals, rows, rm = real_segment_updates(trainer, mode, dev)
        nums = segment_sum_numbers(idx, vals, rows, mode == "pack",
                                   n_levels, dev, plain_tol=False)
        nums["samples_demanded"] = rm
        print(f"segment_sum[{mode}] on a real training step's updates "
              f"(step {trainer.step}, idx {tuple(idx.shape)}): {nums}",
              flush=True)
        state[("segment_sum_real", mode)] = nums


def write_smoke_checkpoint(dev):
    """Full-width seeded random weights + the analytic occupancy grid."""
    import torch
    from arnerf_tpu_torch.datasets.synthetic import analytic_occupancy
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init, ngp_init
    from arnerf_tpu_torch.training.ckpt import save_ckpt
    cfg = NGPConfig(scale=0.5)
    params = ngp_init(cfg, torch.Generator().manual_seed(0), dev)
    occ = analytic_occupancy(cfg.scale, cfg.grid_size, cfg.cascades,
                             device=dev)
    state = grid_state_init(cfg, dev)._replace(occ_flat=occ)
    path = SMOKE_DIR / "random_full_width.npz"
    save_ckpt(str(path), params=params, grid_state=state)
    print(f"checkpoint: {path.relative_to(ROOT)}  occupied cells "
          f"{int(occ.sum())}/{occ.numel()}", flush=True)
    return str(path)


def run_slice(ckpt, dtype_name):
    import torch
    from arnerf_tpu_torch import eval as port_eval
    from arnerf_tpu_torch.ops import fused_head as fh
    argv = ["--dataset_name", "synthetic", "--downsample", "6.25",
            "--ckpt_path", ckpt, "--compute_dtype", dtype_name]
    fh.reset_launches()
    res = port_eval.main(argv)
    launches = fh.launches
    torch.cuda.synchronize()
    w, h = res["img_wh"]
    views = len(res["seconds_per_view"])
    if (w, h) != (800, 800) or views != 4:
        raise AssertionError(f"expected 4 views at 800x800, got {views} at "
                             f"{w}x{h}")
    if launches == 0:
        raise AssertionError("the fused-head kernel was never launched")
    if min(res["total_samples"]) <= 0:
        raise AssertionError(f"empty render: {res['total_samples']}")
    ms = [1e3 * s for s in res["seconds_per_view"]]
    print(f"slice[{dtype_name}]: FPS {res['fps']} ms/view {ms} total samples "
          f"{res['total_samples']} fused-head launches {launches} "
          f"({launches / views} per view) PSNR vs analytic GT {res['psnr']} "
          f"(random weights)", flush=True)
    return launches


def train_entry(argv, work, label):
    """The train entry point with `argv` in `work`, every launch counter
    set to 0 just before: returns its result, the counters at its last
    training block, each block's metrics and the launches of its test-split
    validation."""
    import numpy as np
    import torch
    from arnerf_tpu_torch import train as port_train
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    work.mkdir(parents=True, exist_ok=True)
    counts, blocks = {}, []

    def on_block(step, metrics):    # the counters as training leaves them
        counts.update(step=step, head=fh.launches, **seg.launches)
        blocks.append({k: float(v) for k, v in metrics.items()})

    cwd = os.getcwd()
    os.chdir(work)
    try:
        fh.reset_launches()
        seg.reset_launches()
        t0 = time.perf_counter()
        res = port_train.main(argv, callback=on_block)
        torch.cuda.synchronize()
        res["seconds"] = time.perf_counter() - t0
        # training's launches stop at its last block; the entry point's
        # test-split validation renders after it
        res["val_launches"] = fh.launches - counts["head"]
        res["ckpt"] = str(work / res["ckpt_dir"] / "epoch=0.npz")
    finally:
        os.chdir(cwd)
    trainer = res["trainer"]
    tc = trainer.tc
    anneal = tc.stoch_anneal_frac * tc.total_steps
    ms = {"warmup": [], "stochastic": [], "exact": []}
    for first, t, warmup in trainer.block_times:
        kind = "warmup" if warmup else \
            "exact" if first >= anneal else "stochastic"
        ms[kind].append(1e3 * t / tc.update_interval)
    res.update(counts=counts, blocks=blocks, ms=ms,
               ms_per_step=float(np.median(ms["stochastic"] + ms["exact"])))
    steps = counts["step"]
    print(f"{label}: {steps} steps in {res['seconds']:.1f} s (entry point, "
          f"incl. data and validation); median ms/step "
          f"{ {k: float(np.median(v)) for k, v in ms.items() if v} }, after "
          f"warmup {res['ms_per_step']:.2f}; last block {blocks[-1]}",
          flush=True)
    print(f"{label}: per-block ms/step "
          f"{ {k: [round(x, 2) for x in v] for k, v in ms.items()} }",
          flush=True)
    print(f"{label}: launches per step segment_sum[pack] "
          f"{counts['pack'] / steps} segment_sum[exact] "
          f"{counts['exact'] / steps} fused_head {counts['head'] / steps} "
          f"(totals {counts})", flush=True)
    print(f"{label}: test split PSNR {res['psnr']} SSIM {res['ssim']} "
          f"fused-head launches {res['val_launches']}", flush=True)
    return res


def eval_entry(argv, label, baked=False):
    """The eval entry point with `argv` (with ARNERF_EVAL_BAKED=1 if
    `baked`), the head's counter set to 0 just before; returns its result
    with the launches and ms/view added."""
    import numpy as np
    import torch
    from arnerf_tpu_torch import eval as port_eval
    from arnerf_tpu_torch.ops import fused_head as fh
    prev = os.environ.pop("ARNERF_EVAL_BAKED", None)
    if baked:
        os.environ["ARNERF_EVAL_BAKED"] = "1"
    try:
        fh.reset_launches()
        val = port_eval.main(argv)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("ARNERF_EVAL_BAKED", None)
        if prev is not None:
            os.environ["ARNERF_EVAL_BAKED"] = prev
    val["launches"] = fh.launches
    views = len(val["seconds_per_view"])
    val["ms_per_view"] = [1e3 * t for t in val["seconds_per_view"]]
    kind = (f"baked ({val['bake_voxels']} voxels x {BAKE_DIRS} directions "
            f"= {val['bake_voxels'] * BAKE_DIRS} field rows in "
            f"{val['bake_seconds']:.2f} s; rounds per bucket "
            f"{val['rounds_per_bucket']})" if val["baked"]
            else f"network, samples/view {val['total_samples']}")
    print(f"{label}: eval at {val['img_wh']} in {val['compute_dtype']}: "
          f"PSNR {val['psnr']} FPS {val['fps']} ms/view {val['ms_per_view']} "
          f"{kind}; fused-head launches {fh.launches} "
          f"({fh.launches / views} per view)", flush=True)
    if not all(np.isfinite(val["psnr"])):
        raise AssertionError(f"{label}: non-finite PSNR {val['psnr']}")
    return val


def run_train(state):
    """The train entry point for one 1,000-step epoch at full width, then
    the eval entry point on its checkpoint at 800x800."""
    import numpy as np
    res = train_entry(TRAIN_ARGV, SMOKE_DIR / "train", "train")
    counts, last = res["counts"], res["blocks"][-1]
    state["train_launches"] = {k: counts[k] for k in ("head", "pack", "exact")}
    state["train_val_launches"] = res["val_launches"]
    state["train_ckpt"] = res["ckpt"]
    state["trainer"] = res["trainer"]
    val = eval_entry(["--dataset_name", "synthetic", "--downsample", "6.25",
                      "--ckpt_path", res["ckpt"]], "train")
    state["train_summary"] = {"ms_per_step": res["ms_per_step"],
                              "train_psnr": last["psnr"],
                              "val_psnr": float(np.mean(val["psnr"])),
                              "ms_per_view": float(np.mean(
                                  val["ms_per_view"][1:]))}
    if not np.isfinite(last["loss"]):
        raise AssertionError(f"non-finite loss {last['loss']}")
    if min(counts["pack"], counts["exact"], counts["head"]) == 0:
        raise AssertionError(f"a kernel never ran in training: {counts}")
    if last["psnr"] <= 19.0 or float(np.mean(val["psnr"])) <= 17.0:
        raise AssertionError(f"quality bar missed: train PSNR "
                             f"{last['psnr']}, validation {val['psnr']}")


def baked_card_vs_cpu(ckpt, dev):
    """The train phase's checkpoint baked at BAKE_CHECK_RES^3 with
    stochastic corners on the card (fused head, f32) and on the CPU (plain
    versions): rows to 1e-4 of their largest entry, every code (sigma
    bricks, int8 colours) within 1, the row index equal. Then the CPU's
    bake renders a 64x64 view on both, trilinear and stochastic (bricks)
    from the same key: rgb, opacity and depth to 1e-4, rounds equal."""
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                     SyntheticDataset)
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init
    from arnerf_tpu_torch.ops import threefry
    from arnerf_tpu_torch.rendering_baked import (BakedField, bake_ngp,
                                                  render_baked)
    from arnerf_tpu_torch.training.ckpt import load_ckpt
    sides = (("card", dev), ("cpu", torch.device("cpu")))
    cfg = NGPConfig(scale=0.5, fused_head=True)
    bakes, secs = {}, {}
    for side, d in sides:
        params, state, _ = load_ckpt(ckpt, grid_template=grid_state_init(
            cfg, d), device=d)
        t0 = time.perf_counter()
        bakes[side] = bake_ngp(params, state, cfg,
                               resolution=BAKE_CHECK_RES, stoch=True)
        torch.cuda.synchronize()
        secs[side] = time.perf_counter() - t0
    g, c = bakes["card"], bakes["cpu"]
    rows_err = float((g.rows.cpu() - c.rows).abs().max()
                     / c.rows.abs().max())
    # rows_q: 27 int8 SH codes and a pad byte, then the f32 scale's bytes
    code_err = {k: int((getattr(g, k)[:, :cols].cpu().int()
                        - getattr(c, k)[:, :cols].int()).abs().max())
                for k, cols in (("sigma_bricks", None), ("rows_q", 28))}
    g_sc, c_sc = (b.rows_q[:, 28:].cpu().contiguous().view(torch.float32)
                  for b in (g, c))
    rows_err = max(rows_err, float((g_sc - c_sc).abs().max()
                                   / c_sc.abs().max()))
    same_index = bool(torch.equal(g.row_index.cpu(), c.row_index))
    print(f"baked: card vs CPU bake at {BAKE_CHECK_RES}^3 (stochastic "
          f"corners, f32): rows and colour scales max err / max "
          f"{rows_err}, codes max diff "
          f"{code_err}, row index equal {same_index}, "
          f"{int(c.rows_q.shape[0]) - 1} voxels; seconds {secs}",
          flush=True)
    ds = SyntheticDataset(split="test", read_meta=False,
                          config=SyntheticConfig(img_wh=(64, 64)))
    moved = BakedField(**{k: v.to(dev) if torch.is_tensor(v) else v
                          for k, v in vars(c).items()})
    errs = {}
    for interp in ("trilinear", "stochastic"):
        outs, stats = {}, {}
        for (side, d), bk in zip(sides, (moved, c)):
            ro, rd = get_rays(torch.as_tensor(ds.directions, device=d),
                              torch.as_tensor(ds.poses[0], device=d))
            stats[side] = {}
            outs[side] = render_baked(bk, None, ro, rd, cfg,
                                      key=threefry.prng_key(7),
                                      interp=interp, img_wh=(64, 64),
                                      stats=stats[side])
        errs[interp] = {k: float((outs["card"][k].cpu() - outs["cpu"][k])
                                 .abs().max())
                        for k in ("rgb", "opacity", "depth")}
        errs[interp]["rounds"] = (stats["card"]["rounds"],
                                  stats["cpu"]["rounds"])
        if not all(torch.isfinite(outs["card"][k]).all()
                   for k in ("rgb", "opacity", "depth")):
            raise AssertionError(f"baked {interp}: non-finite render")
    print(f"baked: card vs CPU render at 64x64 of the CPU's bake: {errs}",
          flush=True)
    if rows_err > 1e-4 or max(code_err.values()) > 1 or not same_index:
        raise AssertionError("card and CPU bakes disagree")
    for interp, e in errs.items():
        if max(e[k] for k in ("rgb", "opacity", "depth")) > 1e-4 \
                or e["rounds"][0] != e["rounds"][1]:
            raise AssertionError(f"card and CPU baked renders disagree "
                                 f"({interp})")
    return {"rows_err": rows_err, "code_err": code_err, "render": errs,
            "bake_seconds": secs}


def baked_phase(state, dev):
    """The eval entry point with ARNERF_EVAL_BAKED=1 on the train phase's
    checkpoint at 800x800 (bake at 256^3, 4 views through render_baked),
    then baked_card_vs_cpu."""
    import numpy as np
    ckpt = state["train_ckpt"]
    val = eval_entry(["--dataset_name", "synthetic", "--downsample", "6.25",
                      "--ckpt_path", ckpt], "baked", baked=True)
    state["baked_launches"] = val["launches"]
    net = state.get("train_summary", {})
    summary = {"bake_seconds": val["bake_seconds"],
               "bake_voxels": val["bake_voxels"],
               "bake_field_rows": val["bake_voxels"] * BAKE_DIRS,
               "bake_head_launches": val["launches"],
               "ms_per_view": float(np.mean(val["ms_per_view"][1:])),
               "rounds_per_bucket": val["rounds_per_bucket"],
               "psnr": float(np.mean(val["psnr"])),
               "network_ms_per_view": net.get("ms_per_view"),
               "network_psnr": net.get("val_psnr")}
    print(f"baked summary: {summary}", flush=True)
    state["baked_summary"] = summary
    if val["launches"] == 0:
        raise AssertionError("the bake launched no fused-head kernel")
    if summary["psnr"] <= 17.0:
        raise AssertionError(f"baked validation PSNR {val['psnr']}")
    summary["card_vs_cpu"] = baked_card_vs_cpu(ckpt, dev)


def lpips_card_vs_cpu(trainer, dev):
    """Two 800x800 pairs: the nerf capture's first test view rendered by
    the trained model against its ground truth (near-identical), and the
    ground truth against itself shifted by 4 pixels (a typical LPIPS).
    Each on the card, with cuDNN's TF32 allowed around the call as the
    library's default leaves it (LPIPS must turn it off itself), and on
    the CPU: within 1e-4 of the CPU's value, relative. The card's ms per
    pair from CUDA events."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.training import metrics
    from arnerf_tpu_torch.training.lpips import lpips_distance
    w, h = trainer.test_dataset.img_wh
    out = trainer.render_pose(trainer.test_dataset.poses[0])
    pred = torch.clamp(out["rgb"].reshape(h, w, 3)
                       + (1 - out["opacity"].reshape(h, w, 1)), 0, 1)
    gt = torch.as_tensor(trainer.test_dataset.rays[0][:, :3],
                         device=dev).reshape(h, w, 3)
    pairs = {"view": (pred, gt),
             "shifted": (gt, torch.roll(gt, shifts=(4, 4), dims=(0, 1)))}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = {k: metrics.lpips(a, b) for k, (a, b) in pairs.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    vals = {k: {"card": float(card[k]),
                "cpu": float(metrics.lpips(a.cpu(), b.cpu()))}
            for k, (a, b) in pairs.items()}
    for v in vals.values():
        v["rel_diff"] = abs(v["card"] - v["cpu"]) / max(abs(v["cpu"]),
                                                        1e-30)
    params = metrics._LPIPS_PARAMS[pred.device]
    ms = _time_ms(lambda: lpips_distance(params, pred, gt), 5)
    print(f"lpips: {card['view'].label} at {w}x{h}, card (TF32 allowed "
          f"outside LPIPS) vs CPU: {vals}; {ms:.3f} ms per pair on the card "
          f"(13 f32 convolutions, no TF32)", flush=True)
    if not all(np.isfinite(v["card"]) and v["rel_diff"] <= 1e-4
               for v in vals.values()):
        raise AssertionError("LPIPS: non-finite, or card and CPU disagree")
    return {"values": vals, "ms_per_pair": ms, "label": card["view"].label}


def _timed_block(trainer, activities=None):
    """One training block; its wall time from CUDA events recorded around
    it, and (with `activities`) the profiler that traced it."""
    import torch
    from torch.profiler import profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if activities is None:
        start.record()
        trainer.train_block()
        end.record()
        prof = None
    else:
        with profile(activities=activities) as prof:
            start.record()
            trainer.train_block()
            end.record()
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return start.elapsed_time(end), prof


def _print_kernels(kernels, top):
    """Device time by kernel name: the `top` largest, then the port's own
    kernels (csrc/) wherever they rank."""
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    own = [kv for kv in ranked[top:]
           if "fused_head" in kv[0] or "segment_sum" in kv[0]]
    for name, (t, c) in ranked[:top] + own:
        print(f"  kernel {t / 1e3:8.2f} ms x{c:5d}  {name[:110]}")


def profile_train_block(trainer):
    """Where post-warmup training blocks' time goes. Block 1 runs
    untraced (the wall time without the tracer's cost). Block 2 traces
    device activity only: its idle share is 1 - its kernel-time sum over
    its own wall time. Block 3 also records host ranges, for the spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    spans = ("grid_update", "sample", "march", "field", "composite", "loss",
             "backward", "adam")
    while trainer.step % trainer.tc.update_interval:   # align to a block
        trainer.train_step()
    trainer.train_block()

    def busy(prof):
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in spans]
        return kernels, sum(e.time_range.elapsed_us()
                            for e in kernels) / 1e3

    plain_ms, _ = _timed_block(trainer)
    dev_wall_ms, prof = _timed_block(trainer, [ProfilerActivity.CUDA])
    dev_kernels, dev_busy_ms = busy(prof)
    wall_ms, prof = _timed_block(trainer, [ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
    kernels, busy_ms = busy(prof)
    if not kernels or not dev_kernels:
        print(f"train profile: wall {wall_ms:.1f} ms; device time not "
              f"measured (no device events)", flush=True)
        return
    print(f"train idle share (one block = grid update + "
          f"{trainer.tc.update_interval} steps, step {trainer.step}, exact "
          f"corners {not trainer.cfg.stoch_corners}; CUDA-event wall): "
          f"untraced block {plain_ms:.1f} ms; device-traced block wall "
          f"{dev_wall_ms:.1f} ms, busy {dev_busy_ms:.1f} ms, idle share "
          f"{1 - dev_busy_ms / dev_wall_ms:.3f}, {len(dev_kernels)} "
          f"kernels/copies", flush=True)
    print(f"train profile (host and device traced): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), {len(kernels)} kernels/copies",
          flush=True)
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            print(f"  span {e.key}: host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device {e.device_time_total / 1e3:.1f} ms (kernel sum), "
                  f"calls {e.count}")
    _print_kernels(kernels, 10)


def _tree_to(tree, d):
    """A copy of a parameter tree (dicts, lists, tensors) on device d,
    each leaf requiring grad."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, d) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, d) for v in tree)
    return tree.detach().to(d).clone().requires_grad_(True)


def step_card_vs_cpu(label, cfg, tc, params, occ, ro, rd, gt, noise,
                     exp_step_factor, dev, sample_tol=0, grad_tol=1e-4):
    """One f32 training step (exact corners, sort marching) from the same
    weights and rays on the card (the segment-sum kernel) and on the CPU
    (plain versions). The loss agrees to 1e-5 and each gradient leaf to
    grad_tol of its largest entry (sum order: atomics, cuBLAS); the sample
    totals differ by at most sample_tol of the CPU's, and with sample_tol
    0 every ray's count is equal. Returns the loss's relative
    difference."""
    import torch
    from arnerf_tpu_torch.models import grid_state_init
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.training import trainer as tr
    from arnerf_tpu_torch.training.ckpt import tree_leaves
    out = {}
    for d in (dev, torch.device("cpu")):
        p = _tree_to(params, d)
        state = grid_state_init(cfg, d)._replace(occ_flat=occ.to(d))
        seg.reset_launches()
        loss, res = tr.step_loss(p, state, ro.to(d), rd.to(d), gt.to(d),
                                 noise=noise.to(d), seed=None, rgb_bg=None,
                                 cfg=cfg, tc=tc,
                                 exp_step_factor=exp_step_factor,
                                 seg_cap=tc.seg_cap)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[d.type] = (float(loss.detach()), [g.cpu() for g in grads],
                       int(res["rm_samples"]), res["counts"].cpu(),
                       dict(seg.launches))
    (lg, gg, rg, cg, kl), (lc, gc, rc, cc, _) = out["cuda"], out["cpu"]
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(gg, gc)]
    rel = abs(lg - lc) / abs(lc)
    rays_off = int((cg != cc).sum())
    print(f"{label}: one f32 training step (scale {cfg.scale}, "
          f"{cfg.cascades} cascades), card vs CPU: loss {lg} vs {lc} "
          f"(relative {rel:.3g}), gradient errors relative to each leaf's "
          f"largest entry {errs}, samples {rg} vs {rc} ({rays_off} rays' "
          f"counts differ), card segment_sum launches {kl}", flush=True)
    if abs(rg - rc) > sample_tol * rc or (sample_tol == 0 and rays_off):
        raise AssertionError(f"{label}: card and CPU sample sets differ")
    if rel > 1e-5 or max(errs) > grad_tol:
        raise AssertionError(f"{label}: card and CPU training steps "
                             f"disagree")
    if kl["exact"] != 1:
        raise AssertionError(f"{label}: the card's step did not launch the "
                             f"exact segment sum once: {kl}")
    return rel


def reference_train_step(dev):
    """step_card_vs_cpu at a small size (4 levels, 2^12 table, 32^3 grid,
    512 rays of the synthetic scene, random colours)."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                     SyntheticDataset,
                                                     analytic_occupancy)
    from arnerf_tpu_torch.models import NGPConfig, ngp_init
    from arnerf_tpu_torch.training import trainer as tr
    cfg = NGPConfig(scale=0.5, grid_size=32, n_levels=4, log2_hashmap_size=12,
                    base_resolution=4)
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=(48, 48)))
    rng = np.random.default_rng(0)
    img, pix = rng.integers(0, len(ds.poses), 512), rng.integers(0, 48 * 48,
                                                                  512)
    ro, rd = get_rays(torch.as_tensor(ds.directions[pix]),
                      torch.as_tensor(ds.poses[img]))
    gt = torch.as_tensor(rng.random((512, 3)), dtype=torch.float32)
    noise = torch.as_tensor(rng.random(512), dtype=torch.float32)
    step_card_vs_cpu("reference", cfg, tr.TrainConfig(batch_size=512,
                                                      seg_cap=8),
                     ngp_init(cfg, torch.Generator().manual_seed(3)),
                     analytic_occupancy(0.5, 32, 1), ro, rd, gt, noise, 0.0,
                     dev)


def ray_totals_check(dev):
    """Why composite_train sums each ray's weights directly: on 262,144
    weights in rays of 32 samples, half of them all zero, the difference
    of a global cumsum at each segment's ends (the JAX formulation) is
    counted where it is nonzero or negative, and _ray_totals must give
    exact zeros and no negative total."""
    import torch
    from arnerf_tpu_torch.ops.composite import _ray_totals
    g = torch.Generator(device=dev).manual_seed(0)
    m, per_ray = TRAIN_SAMPLES, 32
    ray_idx = torch.arange(m, device=dev) // per_ray
    empty = torch.rand(m // per_ray, generator=g, device=dev) < 0.5
    w = torch.where(empty[ray_idx], 0.0,
                    torch.rand(m, generator=g, device=dev) * 0.05)
    cum = torch.cumsum(w, 0)
    starts = torch.arange(0, m, per_ray, device=dev)
    diff = cum[starts + per_ray - 1] - torch.where(
        starts > 0, cum[(starts - 1).clamp(min=0)], 0.0)
    direct = _ray_totals(w, ray_idx, torch.ones_like(w, dtype=torch.bool),
                         m // per_ray)
    d_empty = diff[empty]
    print(f"reference: per-ray totals of {int(empty.sum())} empty rays "
          f"(running sum {float(cum[-1]):.1f}): cumsum difference nonzero "
          f"{int((d_empty != 0).sum())}, negative {int((d_empty < 0).sum())}"
          f", min {float(d_empty.min()):.3g}; direct sums nonzero "
          f"{int((direct[empty] != 0).sum())}, negative "
          f"{int((direct < 0).sum())}", flush=True)
    if bool((direct[empty] != 0).any()) or bool((direct < 0).any()):
        raise AssertionError("per-ray totals of empty rays are not zero")


def reference_check(ckpt, dev):
    """64x64 view, f32: card (fused kernel) vs CPU (plain versions)."""
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                     SyntheticDataset)
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init
    from arnerf_tpu_torch.rendering import render_test
    from arnerf_tpu_torch.training.ckpt import load_ckpt
    ds = SyntheticDataset(split="test", read_meta=False,
                          config=SyntheticConfig(img_wh=(64, 64)))
    outs = {}
    for d in (dev, torch.device("cpu")):
        cfg = NGPConfig(scale=0.5, fused_head=True)
        params, state, _ = load_ckpt(ckpt, grid_template=grid_state_init(
            cfg, d), device=d)
        ro, rd = get_rays(torch.as_tensor(ds.directions, device=d),
                          torch.as_tensor(ds.poses[0], device=d))
        outs[d.type] = render_test(params, state, ro, rd, cfg,
                                   T_threshold=1e-2, max_samples=96,
                                   fast=True)
    gpu, cpu = outs["cuda"], outs["cpu"]
    errs = {k: float((gpu[k].cpu() - cpu[k]).abs().max())
            for k in ("rgb", "opacity", "depth")}
    print(f"reference: card vs CPU at 64x64 f32: max abs err {errs}, "
          f"samples {gpu['total_samples']} vs {cpu['total_samples']}",
          flush=True)
    for k in ("rgb", "opacity", "depth"):
        if not torch.isfinite(gpu[k]).all():
            raise AssertionError(f"non-finite {k}")
    if gpu["total_samples"] != cpu["total_samples"] or \
            max(errs.values()) > 1e-3:
        raise AssertionError("card and CPU renders disagree")


def profile_view(ckpt, dev):
    """Where one 800x800 bf16 view's time goes: wall time, device busy time
    (sum of kernel durations, one stream), the render layers' spans
    (rendering.py's record_function ranges) and the top kernels. Reports
    "not measured" if the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.datasets.synthetic import SyntheticDataset
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init
    from arnerf_tpu_torch.rendering import render_test
    from arnerf_tpu_torch.training.ckpt import load_ckpt
    cfg = NGPConfig(scale=0.5, fused_head=True, compute_dtype="bfloat16")
    params, state, _ = load_ckpt(ckpt, grid_template=grid_state_init(cfg, dev),
                                 device=dev)
    ds = SyntheticDataset(split="test", downsample=6.25, read_meta=False)
    ro, rd = get_rays(torch.as_tensor(ds.directions, device=dev),
                      torch.as_tensor(ds.poses[1], device=dev))

    def view():
        return render_test(params, state, ro, rd, cfg, T_threshold=1e-2,
                           max_samples=96, fast=True)

    view()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = ("first_hit", "march", "field", "composite")
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in spans]
    if not kernels:
        print(f"profile: wall {wall_ms:.1f} ms; device time not measured "
              f"(the profiler recorded no device events)", flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), {len(kernels)} device "
          f"kernels/copies in the view", flush=True)
    for e in prof.key_averages():
        # each span is listed twice: its host range (kept; its device time
        # is the sum of the kernels it launched) and its GPU-side annotation
        if e.key in spans and e.device_type == DeviceType.CPU:
            print(f"  span {e.key}: host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device {e.device_time_total / 1e3:.1f} ms (kernel sum), "
                  f"calls {e.count}")
    _print_kernels(kernels, 12)


def profile_baked_view(ckpt, dev):
    """Where one 800x800 baked view's time goes: the train phase's
    checkpoint baked at 256^3 in f32 with exact corners (8 hash rows a
    level, 8x the stochastic bake's gathers), its seconds and its PSNR on
    the 4 test views (what the eval path's stochastic bake gives up to
    estimator noise), then one traced view: wall time, device busy time,
    the spans of rendering_baked.py and the top kernels."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from arnerf_tpu_torch.datasets import dataset_dict
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init
    from arnerf_tpu_torch.ops import threefry
    from arnerf_tpu_torch.rendering_baked import bake_ngp, render_baked
    from arnerf_tpu_torch.training.ckpt import load_ckpt
    from arnerf_tpu_torch.training.metrics import psnr
    cfg = NGPConfig(scale=0.5, fused_head=True)
    params, state, _ = load_ckpt(ckpt, grid_template=grid_state_init(cfg, dev),
                                 device=dev)
    t0 = time.perf_counter()
    baked = bake_ngp(params, state, cfg, stoch=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ds = dataset_dict["synthetic"](split="test", downsample=6.25,
                                   device=dev)
    psnrs = []
    for i, pose in enumerate(ds.poses):
        ro, rd = get_rays(torch.as_tensor(ds.directions, device=dev),
                          torch.as_tensor(pose, device=dev))
        out = render_baked(baked, state, ro, rd, cfg,
                           key=threefry.prng_key(i), img_wh=ds.img_wh)
        pred = torch.clamp(out["rgb"] + (1 - out["opacity"])[:, None], 0, 1)
        gt = torch.as_tensor(ds.rays[i][:, :3], device=dev)
        psnrs.append(float(psnr(pred, gt)))
    print(f"baked: exact-corner bake at 256^3 in {secs:.2f} s, PSNR "
          f"{psnrs} (mean {np.mean(psnrs):.3f})", flush=True)
    ro, rd = get_rays(torch.as_tensor(ds.directions, device=dev),
                      torch.as_tensor(ds.poses[1], device=dev))

    def view():
        return render_baked(baked, state, ro, rd, cfg,
                            key=threefry.prng_key(1), img_wh=ds.img_wh)

    view()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = ("cull", "prelude", "march", "color")
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in spans]
    if not kernels:
        print(f"profile[baked]: wall {wall_ms:.1f} ms; device time not "
              f"measured (the profiler recorded no device events)",
              flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"profile[baked]: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{len(kernels)} device kernels/copies in the view", flush=True)
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            print(f"  span {e.key}: host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device {e.device_time_total / 1e3:.1f} ms (kernel sum), "
                  f"calls {e.count}")
    _print_kernels(kernels, 10)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Viewer:
    """The external OpenGL viewer's side of the insertion server's
    length-prefixed protocol (arnerf_tpu_torch/insert/server.py)."""

    def __init__(self, port):
        import socket
        self.s = socket.create_connection(("127.0.0.1", port), timeout=300)

    def recv(self):
        n = int.from_bytes(self._recvn(8), "little")
        return self._recvn(n)

    def _recvn(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the insertion server closed the "
                                      "connection")
            buf += chunk
        return buf

    def send(self, aid, body=b""):
        import struct
        msg = struct.pack("i", aid) + body
        self.s.sendall(len(msg).to_bytes(8, "little") + msg)


def _gl_pose(c2w):
    """A NeRF c2w (3, 4) [right down front] as the viewer's GL pose (4, 4),
    the inverse of NGPServer.cam_pose_decoder's flip."""
    import numpy as np
    c2w = np.asarray(c2w, np.float32)
    gl = np.eye(4, dtype=np.float32)
    gl[:3] = np.stack([c2w[:, 0], -c2w[:, 1], -c2w[:, 2], c2w[:, 3]], -1)
    return gl


def sphere_raster(c2w, K, H, W, center, radius):
    """The viewer's raster of a sphere: bbox [[hs, ws], [hl, wl]] and an
    (h, w, 4) float32 map of world normals and z-depth (0 off the sphere),
    rows bottom-up as the viewer sends them."""
    import numpy as np
    c2w = np.asarray(c2w, np.float64)
    R, o = c2w[:, :3], c2w[:, 3]
    center = np.asarray(center, np.float64)
    xc = R.T @ (center - o)
    if xc[2] <= radius:
        raise AssertionError(f"the object at {center} is behind the camera")
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = fx * xc[0] / xc[2] + cx, fy * xc[1] / xc[2] + cy
    half = int(np.ceil(fx * radius / (xc[2] - radius))) + 1
    hs, hl = max(int(v) - half, 0), min(int(v) + half, H)
    ws, wl = max(int(u) - half, 0), min(int(u) + half, W)
    if hl - hs < 8 or wl - ws < 8:
        raise AssertionError(f"the object at {center} is off screen")
    vv, uu = np.meshgrid(np.arange(hs, hl) + 0.5, np.arange(ws, wl) + 0.5,
                         indexing="ij")
    d = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)], -1) @ R.T
    oc = o - center
    a = np.sum(d * d, -1)
    b = 2 * d @ oc
    disc = b * b - 4 * a * (oc @ oc - radius ** 2)
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    nrm = (o + t[..., None] * d - center) / radius * hit[..., None]
    raster = np.concatenate([nrm, t[..., None]], -1).astype(np.float32)
    return [[hs, ws], [hl, wl]], np.ascontiguousarray(raster[::-1])


def _ssdf_volume(path, seed=0):
    """A seeded PCA SSDF volume in the viewer's torch .tar layout (20^3
    grid, 128 components over a 74 x 148 lat-long map)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    torch.save({"coeff": torch.from_numpy(rng.normal(
                    0, 0.02, (20 ** 3, 128)).astype(np.float32)),
                "component": torch.from_numpy(rng.normal(
                    0, 0.05, (128, 74, 148)).astype(np.float32)),
                "mean": torch.full((1, 74, 148), 0.3)}, path)


def _insert_hparams(ckpt, downsample, device, compute_dtype="auto"):
    from arnerf_tpu_torch.opt import get_opts
    return get_opts(["--dataset_name", "synthetic", "--downsample",
                     str(downsample), "--ckpt_path", ckpt, "--exp_name",
                     "smoke", "--device", device, "--compute_dtype",
                     compute_dtype])


def _synced(dev, fn):
    import torch

    def run(*a, **k):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.ms.append(1e3 * (time.perf_counter() - t0))
        return out
    run.ms = []
    return run


def run_insert(ckpt, dev, downsample=6.25, frames=INSERT_FRAMES,
               probe_points=INSERT_PROBE_POINTS, radius=0.1, min_plane=1e5):
    """The insertion server's path on `dev`: the prep (insertor, surface
    cache and point cloud, planes, probe precompute cut to `probe_points`,
    200 global-SH iterations) and then NGPServer behind a real socket with
    a viewer that sends the camera, the SSDF volume and `frames` frames of
    object moves (actions 1, 3, 6), one shadow-map frame and one saved
    frame. Returns the measurements; checks nothing itself."""
    import struct
    import threading
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert import main as im
    from arnerf_tpu_torch.insert.global_light import GlobalLightEstimator
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    work = SMOKE_DIR / "insert"
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    shutil.rmtree(work / "insert", ignore_errors=True)
    res = {"prep_s": {}, "launches": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stage(name, fn):
        sync()
        n0, t0 = fh.launches, time.perf_counter()
        out = fn()
        sync()
        for key, v in (("prep_s", time.perf_counter() - t0),
                       ("launches", fh.launches - n0)):
            res[key][name] = res[key].get(name, 0) + v
        return out

    samples = []
    render_test = im.render_test

    def counted(*a, **k):
        out = render_test(*a, **k)
        samples.append(int(out["total_samples"]))
        return out
    im.render_test = counted
    try:
        fh.reset_launches()
        seg.reset_launches()
        ins = stage("insertor", lambda: im.NGPInsertor(
            _insert_hparams(ckpt, downsample, dev.type)))
        stage("surface_and_point_cloud", ins.generate_point_cloud)
        gle = stage("planes", lambda: GlobalLightEstimator(ins.gen_path))
        stage("planes", lambda: gle.detect_planar_patch(min_plane))
        n_plane = len(gle.t_pts)
        keep = np.random.default_rng(0).permutation(n_plane)[:probe_points]
        gle.t_pts, gle.t_rgbs, gle.t_normal = (
            gle.t_pts[keep], gle.t_rgbs[keep], gle.t_normal[keep])
        print(f"insert: {n_plane} planar points; the probe precompute is cut "
              f"to {len(keep)} points x 2048 rays (the reference's pts_use "
              f"2e6 would take hours)", flush=True)
        stage("probe_precompute", lambda: gle.save_results(ins))
        stage("global_sh_fit", lambda: ins.fit_global_sh(gle))
        res["prep_samples"] = sum(samples)
        res["global_sh_dc"] = ins.global_sh[0, 0].tolist()

        # serving: NGPServer in a thread, this thread the viewer
        _ssdf_volume(work / "smoke_mesh.tar")
        os.environ["VIEWER_SG_PATH"] = str(work)
        port = _free_port()
        holder, errors = {}, []

        def serve():
            try:
                holder["srv"] = srv = im.NGPServer(ins, port=port)
                for a in (1, 6, 9):
                    srv.act_dict[a] = holder[a] = _synced(dev,
                                                          srv.act_dict[a])
                srv.run()
            except BaseException as e:   # noqa: BLE001 - re-raised below
                errors.append(e)
                if "srv" in holder:
                    holder["srv"].server.conn.close()
        fit = ins.env_opt.eval = _synced(dev, ins.env_opt.eval)
        shaded = []
        insert_object = ins.render_insert_object

        def keep_frame(*a, **k):
            out = insert_object(*a, **k)
            shaded.append(out[0] if isinstance(out, tuple) else out)
            return out
        ins.render_insert_object = keep_frame
        th = threading.Thread(target=serve, daemon=True)
        th.start()
        viewer = None
        for _ in range(600):
            try:
                viewer = _Viewer(port)
                break
            except OSError:
                if errors:
                    raise errors[0]
                time.sleep(0.05)
        if viewer is None:
            raise AssertionError("the insertion server did not listen")
        H, W, _ = struct.unpack("iif", viewer.recv())
        viewer.recv()
        viewer.recv()
        pose = ins.dataset.poses[0]
        viewer.send(2, struct.pack("f" * 16, *_gl_pose(pose).ravel()))
        viewer.send(9, b"smoke_mesh")
        rot = np.eye(3, dtype=np.float32).tobytes()
        frame_ms, frame_launches, frame_samples, raster = [], [], [], None

        def frame(i, mode, body6=b""):
            nonlocal raster
            center = (0.22 + 0.004 * i, 0.17, 0.12 - 0.003 * i)
            bbox, raster = sphere_raster(pose, ins.K, H, W, center, radius)
            n0, s0 = fh.launches, len(samples)
            t0 = time.perf_counter()
            viewer.send(1, struct.pack("ifff", mode, *center) + rot)
            if mode == 2:
                viewer.recv()                    # the main light direction
            viewer.send(3, struct.pack("fiiii", radius, *bbox[0], *bbox[1])
                        + raster.tobytes())
            viewer.send(6, body6)
            if struct.unpack("i", viewer.recv()) != (0,):
                raise AssertionError("no render-complete reply")
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            frame_launches.append(fh.launches - n0)
            frame_samples.append(sum(samples[s0:]))

        for i in range(frames):
            frame(i, 1)
        tex = 512
        vp = np.array([[1.5, 0, 0, 0], [0, 0, 1.5, 0], [0, -1, 0, 0.8],
                       [0, 0, 0, 1]], np.float32)
        s_im = np.full((tex, tex), 0.5, np.float32)
        viewer.send(7, struct.pack("i", tex) + vp.tobytes(order="C")
                    + s_im.tobytes())
        frame(frames, 2)
        frame(frames + 1, 1, struct.pack("i", 1) + b"smoke")
        viewer.send(0)
        th.join(timeout=300)
        if errors:
            raise errors[0]
        if th.is_alive():
            raise AssertionError("the insertion server did not stop")
        res["action_ms"] = {a: holder[a].ms for a in (1, 6, 9)}
        res["sg_fit_ms"] = fit.ms
        res["frame_ms"] = frame_ms
        res["frame_launches"] = frame_launches
        res["frame_samples"] = frame_samples
        res["raster"] = raster.shape[:2]
        res["regular_frames"] = frames
        res["frames"] = shaded
        res["hw"] = (H, W)
        res["segment_sum_launches"] = dict(seg.launches)
        res["head_launches"] = fh.launches
        res["insertor"] = ins
        res["saved"] = sorted(p.name for p in (
            Path(ins.gen_path) / "results").iterdir())
    finally:
        im.render_test = render_test
        os.chdir(cwd)
    return res


def insert_card_vs_cpu(ckpt, ins_card, dev, downsample=0.5):
    """One AR frame at a reduced size (64x64) on the card (the fused head
    kernel in f32) and on the CPU (plain versions), same checkpoint, light,
    SSDF volume and object raster: the SG frame with self-shadow and SSDF
    shadow and the neural-BRDF SH frame with the shadow map. Returns the
    max abs errors of the SH probe and of the two frames, and how far the
    CPU's SG frame itself moves when its raster depths and lights are
    scaled by 1 + 1e-7 (its conditioning)."""
    import dataclasses
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert import main as im
    from arnerf_tpu_torch.insert.envfit import trans_raw_sg
    work = SMOKE_DIR / "insert"
    cwd = os.getcwd()
    os.chdir(work)      # the prep's gen_path: no ground truth is rendered
    try:
        outs = []
        for d in (dev, torch.device("cpu")):
            ins = im.NGPInsertor(_insert_hparams(ckpt, downsample, d.type,
                                                 "float32"))
            ins.cfg = dataclasses.replace(ins.cfg, fused_head=True)
            ins.global_sh = ins_card.global_sh.to(d)
            ins.set_sg_shadow(str(work / "smoke_mesh.tar"))
            pose = ins.dataset.poses[0]
            center = (0.22, 0.17, 0.12)
            bbox, raster = sphere_raster(pose, ins.K, ins.H, ins.W, center,
                                         0.1)
            raster = np.ascontiguousarray(raster[::-1])
            sh = ins.generate_probe(list(center), sh_probe=True)
            sg = trans_raw_sg(ins_card.env_opt.lgt_sgs.to(d))
            kw = dict(model_bbox=bbox, model_bbox_last=None,
                      model_radius=0.1, model_pos=center,
                      model_rot_inv=np.eye(3, dtype=np.float32))
            rgb_sg = ins.render_insert_object(
                raster[..., :3], raster[..., 3], pose, sg, gen_shadow=1, **kw)
            if d.type == "cpu":
                ins.last_rgb = None
                moved = ins.render_insert_object(
                    raster[..., :3], raster[..., 3] * (1 + 1e-7), pose,
                    sg * (1 + 1e-7), gen_shadow=1, **kw)
                sensitivity = float(np.abs(moved - rgb_sg).max())
            ins.last_rgb = None
            rgb_sh = ins.render_insert_object(
                raster[..., :3], raster[..., 3], pose, sh, 0.5, 0.4,
                use_sg_base=False, sg_use_self_shadow=False, gen_shadow=2,
                s_texSize=64, s_im=np.full((64, 64, 1), 0.5, np.float32),
                s_VP=np.eye(4, dtype=np.float32), **kw)
            outs.append((sh.cpu().numpy(), rgb_sg, rgb_sh))
    finally:
        os.chdir(cwd)
    for rgb in outs[0][1:]:
        if not np.isfinite(rgb).all():
            raise AssertionError("non-finite card frame")
    return [float(np.abs(a - b).max()) for a, b in zip(*outs)], sensitivity


def profile_insert_frame(ins, dev):
    """Where one serving frame's time goes (probe + SG fit, object shade,
    dirty-rect render, SSDF shadow), called directly on the insertor the
    server used: wall time, device busy time, idle share, top kernels."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from arnerf_tpu_torch.insert.envfit import trans_raw_sg
    pose = ins.dataset.poses[0]
    center = (0.25, 0.17, 0.1)
    bbox, raster = sphere_raster(pose, ins.K, ins.H, ins.W, center, 0.1)
    raster = np.ascontiguousarray(raster[::-1])
    kw = dict(model_bbox=bbox, model_bbox_last=[[bbox[0][0] - 4,
                                                 bbox[0][1] - 4], bbox[1]],
              model_radius=0.1, model_pos=center,
              model_rot_inv=np.eye(3, dtype=np.float32), gen_shadow=1)

    def one():
        sg = trans_raw_sg(ins.generate_probe(list(center), False))
        return ins.render_insert_object(raster[..., :3], raster[..., 3],
                                        pose, sg, **kw)
    one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = ("probe", "sg_fit", "shade", "rect", "shadow", "march",
             "field", "composite")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in spans]
    if not kernels:
        print(f"insert profile: wall {wall_ms:.1f} ms; device time not "
              f"measured (no device events)", flush=True)
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"insert profile (one frame: probe + SG fit + shade + rect render "
          f"+ SSDF shadow, {ins.W}x{ins.H}): wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.1f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{len(kernels)} device kernels/copies", flush=True)
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            print(f"  span {e.key}: host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device {e.device_time_total / 1e3:.1f} ms (kernel sum), "
                  f"calls {e.count}")
    _print_kernels(kernels, 12)


def insert_phase(state, dev):
    """run_insert on the card at 800x800, from the train phase's
    checkpoint (or the random-weights one), with its checks, then the
    card-vs-CPU frame check at 64x64."""
    import numpy as np
    ckpt = state.get("train_ckpt") or state.get("ckpt") \
        or write_smoke_checkpoint(dev)
    res = run_insert(ckpt, dev)
    state["insert_launches"] = res["head_launches"]
    state["insert_insertor"] = res["insertor"]
    a1, a6, a9 = (res["action_ms"][a] for a in (1, 6, 9))
    n = res["regular_frames"]
    print(f"insert: checkpoint {Path(ckpt).name}, frames {res['hw']}, object "
          f"raster {res['raster']}", flush=True)
    print(f"insert prep seconds {res['prep_s']}; fused-head launches "
          f"{res['launches']}; samples {res['prep_samples']}; global SH DC "
          f"{res['global_sh_dc']}", flush=True)
    print(f"insert serving (ms; first frame is warm-up): action 9 (SSDF "
          f"volume, F table) {a9}; action 1 (probe + SG fit) {a1}; SG fit "
          f"{res['sg_fit_ms']}; action 6 (shade + rect render + shadow) "
          f"{a6}; viewer round trip per frame {res['frame_ms']}", flush=True)
    warm = slice(1, n)     # the regular frames after the first
    probe_ms = np.subtract(a1, res["sg_fit_ms"])
    summary = {k: float(np.median(v[warm])) for k, v in (
        ("action1_ms", a1), ("probe_ms", probe_ms),
        ("sg_fit_ms", res["sg_fit_ms"]), ("action6_ms", a6),
        ("round_trip_ms", res["frame_ms"]),
        ("samples", res["frame_samples"]),
        ("launches", res["frame_launches"]))}
    print(f"insert per frame after warm-up (medians): {summary}; samples "
          f"per frame {res['frame_samples']}; fused-head launches per frame "
          f"{res['frame_launches']}; segment_sum launches "
          f"{res['segment_sum_launches']}; saved {res['saved']}", flush=True)
    state["insert_summary"] = dict(summary, prep_s=res["prep_s"])
    if res["head_launches"] == 0 or min(res["frame_launches"]) == 0:
        raise AssertionError("the fused-head kernel did not run in the "
                             "insert path")
    if any(res["segment_sum_launches"].values()):
        raise AssertionError(f"the segment sum ran in the insert path: "
                             f"{res['segment_sum_launches']}")
    if n < 10:
        raise AssertionError(f"only {n} frames")
    if not {"0_smoke.png", "0_smoke.exr", "0_info.npz"} <= set(res["saved"]):
        raise AssertionError(f"the saved frame is missing: {res['saved']}")
    for f in res["frames"]:
        if f.shape != (800, 800, 3) or not np.isfinite(f).all():
            raise AssertionError(f"bad frame: {f.shape}, finite "
                                 f"{np.isfinite(f).all()}")
    errs, sensitivity = insert_card_vs_cpu(ckpt, res["insertor"], dev)
    print(f"insert: card vs CPU at 64x64 f32: max abs err SH probe "
          f"{errs[0]:.3g}, SG frame (self shadow + SSDF shadow) "
          f"{errs[1]:.3g}, SH frame (neural BRDF + shadow map) "
          f"{errs[2]:.3g} (tolerances {INSERT_TOL}); the CPU's SG frame "
          f"moves {sensitivity:.3g} when its inputs are scaled by 1 + 1e-7",
          flush=True)
    if any(e > tol for e, tol in zip(errs, INSERT_TOL)):
        raise AssertionError("card and CPU AR frames disagree")


def write_captures(dev):
    """Both captures of the procedural scene, rendered on the card and
    written in parallel; returns the uint8 images written."""
    import torch
    from arnerf_tpu_torch.datasets.captures import (write_blender_capture,
                                                    write_colmap_capture)
    shutil.rmtree(CAPTURES_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    blender = write_blender_capture(str(CAPTURES_DIR / "blender"),
                                    *BLENDER_VIEWS, wh=BLENDER_WH,
                                    device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    colmap = write_colmap_capture(str(CAPTURES_DIR / "colmap"),
                                  n_views=COLMAP_VIEWS, wh=COLMAP_WH,
                                  device=dev)
    t2 = time.perf_counter()
    size = sum(f.stat().st_size for f in CAPTURES_DIR.rglob("*.png"))
    print(f"captures: blender {BLENDER_VIEWS} views at {BLENDER_WH}^2 RGBA in "
          f"{t1 - t0:.1f} s, colmap {COLMAP_VIEWS} views at {COLMAP_WH} in "
          f"{t2 - t1:.1f} s (render + PNG filter types 0-4 + deflate); "
          f"{size / 2 ** 20:.1f} MiB of PNG", flush=True)
    return blender, colmap


def decode_check(blender, colmap):
    """Each split through its loader at downsample 1.0: every view must
    equal the pixels written, after the loader's alpha blend (Blender:
    to white; COLMAP: no alpha), within 1e-6. Returns load seconds."""
    import numpy as np
    from arnerf_tpu_torch.datasets import ColmapDataset, NeRFDataset
    seconds, worst = {}, 0.0
    keep = {"train": [i for i in range(COLMAP_VIEWS) if i % 8],
            "test": [i for i in range(COLMAP_VIEWS) if i % 8 == 0]}
    for split in ("train", "test"):
        t0 = time.perf_counter()
        ds = NeRFDataset(str(CAPTURES_DIR / "blender"), split=split)
        seconds[f"blender_{split}"] = time.perf_counter() - t0
        assert ds.rays.shape == (len(blender[split]), BLENDER_WH ** 2, 3)
        for got, img in zip(ds.rays, blender[split]):
            a = img.astype(np.float32) / 255.0
            want = a[..., :3] * a[..., 3:] + (1 - a[..., 3:])
            worst = max(worst, float(np.abs(got - want.reshape(-1, 3))
                                     .max()))
        t0 = time.perf_counter()
        ds = ColmapDataset(str(CAPTURES_DIR / "colmap"), split=split)
        seconds[f"colmap_{split}"] = time.perf_counter() - t0
        assert ds.rays.shape == (len(keep[split]), COLMAP_WH[0]
                                 * COLMAP_WH[1], 3)
        for got, i in zip(ds.rays, keep[split]):
            want = colmap[i].astype(np.float32) / 255.0
            worst = max(worst, float(np.abs(got - want.reshape(-1, 3))
                                     .max()))
    print(f"captures: decode check, max abs error over every view "
          f"{worst}; load seconds {seconds}", flush=True)
    if worst > 1e-6:
        raise AssertionError(f"decoded views differ from the pixels "
                             f"written: {worst}")
    return seconds


def capture_card_vs_cpu(trainer, dev):
    """step_card_vs_cpu on the trained scale-16 COLMAP model: its weights
    and occupancy, 512 rays of its training views, f32, exact corners.
    Exp stepping places samples with exp and log, and the cascade of a
    sample comes from log2; the card's and the CPU's float32 versions of
    these may differ by an ulp, which moves a sample across a cell or
    cascade boundary now and then (2 of 193,514 in an H100 run). So the
    sample totals may differ by 1e-4 of the total and each gradient leaf
    by 1e-3 of its largest entry; the loss is held to 1e-5 as at scale
    0.5."""
    import dataclasses
    import numpy as np
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    rng = np.random.default_rng(1)
    images = trainer.images.cpu().numpy()
    img = rng.integers(0, len(images), 512)
    pix = rng.integers(0, images.shape[1], 512)
    ro, rd = get_rays(torch.as_tensor(trainer.dataset.directions[pix]),
                      torch.as_tensor(trainer.dataset.poses[img]))
    cfg = dataclasses.replace(trainer.cfg, compute_dtype="float32",
                              stoch_corners=False)
    tc = dataclasses.replace(trainer.tc, batch_size=512)
    return step_card_vs_cpu(
        "captures", cfg, tc, trainer.params, trainer.grid_state.occ_flat,
        ro, rd, torch.as_tensor(images[img, pix, :3]),
        torch.as_tensor(rng.random(512), dtype=torch.float32),
        trainer.exp_step_factor, dev, sample_tol=1e-4, grad_tol=1e-3)


def captures_phase(state, dev):
    """Write both captures, check the decode, train and evaluate on each
    through the entry points, and hold one scale-16 step card vs CPU."""
    import numpy as np
    blender, colmap = write_captures(dev)
    load_s = decode_check(blender, colmap)
    del blender, colmap
    summary = {"load_s": load_s}
    failures = []
    for name in ("nerf", "colmap"):
        root = str(CAPTURES_DIR / ("blender" if name == "nerf" else name))
        work = SMOKE_DIR / f"captures_{name}"
        argv = CAPTURE_ARGV[name] + ["--root_dir", root, "--exp_name", name]
        res = train_entry(argv, work, f"captures[{name}]")
        counts, blocks = res["counts"], res["blocks"]
        trainer = res["trainer"]
        state[("capture_train", name)] = {
            k: counts[k] for k in ("head", "pack", "exact")}
        extra = ["--grid_vis", str(work / "grid.png"), "--cam_vis",
                 str(work / "cams.png"), "--mesh", str(work / "mesh.obj")] \
            if name == "nerf" else []
        val = eval_entry(argv + ["--ckpt_path", res["ckpt"], *extra],
                         f"captures[{name}]")
        state[("capture_eval", name)] = val["launches"]
        steps = counts["step"]
        more = {}
        if name == "nerf":
            # --eval_lpips: the test line's lpips_rand, the launches of the
            # validation renders it measures, and eval in bf16 beside the
            # default f32
            state["lpips_train_launches"] = res["val_launches"]
            more["lpips"] = res["lpips"]
            if not res["lpips"] or not np.isfinite(res["lpips"]).all():
                failures.append(f"nerf: LPIPS missing or non-finite: "
                                f"{res['lpips']}")
            v16 = eval_entry(argv + ["--ckpt_path", res["ckpt"],
                                     "--compute_dtype", "bfloat16"],
                             "captures[nerf] bf16")
            state[("capture_eval_bf16", name)] = v16["launches"]
            more.update(val_psnr_bf16=float(np.mean(v16["psnr"])),
                        ms_per_view_bf16=float(np.mean(
                            v16["ms_per_view"][1:])))
            try:
                more["lpips_card_vs_cpu"] = lpips_card_vs_cpu(trainer, dev)
            except AssertionError as e:
                failures.append(str(e))
        else:
            vb = eval_entry(argv + ["--ckpt_path", res["ckpt"]],
                            "captures[colmap] baked", baked=True)
            state[("capture_baked", name)] = vb["launches"]
            more.update(baked_psnr=float(np.mean(vb["psnr"])),
                        baked_ms_per_view=float(np.mean(
                            vb["ms_per_view"][1:])),
                        bake_seconds=vb["bake_seconds"],
                        bake_voxels=vb["bake_voxels"],
                        bake_head_launches=vb["launches"],
                        baked_rounds_per_bucket=vb["rounds_per_bucket"])
            if vb["launches"] == 0:
                failures.append("colmap: the bake launched no fused-head "
                                "kernel")
            if more["baked_psnr"] <= 17.0:
                failures.append(f"colmap: baked validation PSNR "
                                f"{vb['psnr']}")
        summary[name] = {
            "cascades": trainer.cfg.cascades,
            "exp_step_factor": trainer.exp_step_factor,
            "ms_per_step": res["ms_per_step"],
            "train_psnr": blocks[-1]["psnr"],
            "val_psnr": float(np.mean(val["psnr"])),
            "ms_per_view": float(np.mean(val["ms_per_view"][1:])),
            "samples_per_view": float(np.mean(val["total_samples"])),
            "launches_per_step": {k: counts[k] / steps
                                  for k in ("head", "pack", "exact")},
            "head_launches_per_view": val["launches"]
            / len(val["ms_per_view"]), **more}
        print(f"captures[{name}] summary: {summary[name]}", flush=True)
        bad_loss = [b["loss"] for b in blocks if not np.isfinite(b["loss"])]
        if bad_loss:
            failures.append(f"{name}: non-finite losses {bad_loss}")
        if min(counts["pack"], counts["exact"], counts["head"]) == 0:
            failures.append(f"{name}: a kernel never ran in training: "
                            f"{counts}")
        if summary[name]["val_psnr"] <= 17.0 or (
                name == "nerf" and summary[name]["train_psnr"] <= 19.0):
            failures.append(f"{name}: quality bar missed: train PSNR "
                            f"{summary[name]['train_psnr']}, validation "
                            f"{val['psnr']}")
        if name == "nerf":
            written = [p.name for p in work.iterdir()]
            print(f"captures[nerf]: eval wrote {sorted(written)}; mesh "
                  f"{val.get('mesh_faces')} faces in "
                  f"{val.get('mesh_seconds', 0):.1f} s", flush=True)
            summary[name]["mesh_faces"] = val.get("mesh_faces", 0)
            if not {"grid.png", "cams.png", "mesh.obj"} <= set(written) \
                    or not val.get("mesh_faces"):
                failures.append(f"nerf: eval outputs missing or an empty "
                                f"mesh: {sorted(written)}")
        else:
            summary["card_vs_cpu_loss_rel"] = capture_card_vs_cpu(trainer,
                                                                  dev)
        del res, trainer
    state["captures_summary"] = summary
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "arnerf_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: arnerf_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)

    failed = []
    state = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
            failed.append(name)

    def build_phase():
        from arnerf_tpu_torch import build
        names = build.KERNEL_SOURCES + build.HOST_SOURCES
        seconds = build.build(names)
        print(f"build seconds (nvcc for each kernel and c++ for the image "
              f"decoder, all started together): {seconds}; already built: "
              f"{sorted(set(names) - set(seconds))}", flush=True)
        spills = []
        for name in build.KERNEL_SOURCES:
            log = build.library_path(name).with_suffix(".so.log")
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas[{name}]: {line.strip()}")
                spills += [(name, int(b)) for b in re.findall(
                    r"(\d+) bytes spill", line) if int(b)]
        if spills:
            raise AssertionError(f"ptxas reports spills: {spills}")

    def kernel_phase():
        w = _head_weights(dev)
        for dtype_name in ("bfloat16", "float32"):
            for rows in (PARITY_ROWS, MAIN_PATH_ROWS):
                nums = head_kernel_numbers(dtype_name, rows, w, dev)
                print(f"fused_head[{dtype_name}] rows {rows}: {nums}",
                      flush=True)
                state[(dtype_name, rows)] = nums
        head_gradient_check(MAIN_PATH_ROWS, w, dev)
        for mode in ("pack", "exact"):
            idx, vals, rows, n_levels = _segment_updates(mode, dev)
            nums = segment_sum_numbers(idx, vals, rows, mode == "pack",
                                       n_levels, dev)
            print(f"segment_sum[{mode}] on uniform positions: {nums}",
                  flush=True)
            state[("segment_sum", mode)] = nums

    def slice_phase():
        state["ckpt"] = write_smoke_checkpoint(dev)
        for dtype_name in ("bfloat16", "float32"):
            state[("launches", dtype_name)] = run_slice(state["ckpt"],
                                                        dtype_name)

    def reference_phase():
        reference_check(state.get("ckpt") or write_smoke_checkpoint(dev), dev)
        reference_train_step(dev)
        ray_totals_check(dev)

    phase("build", build_phase)
    phase("kernels", kernel_phase)
    phase("slice", slice_phase)
    phase("train", lambda: run_train(state))
    phase("insert", lambda: insert_phase(state, dev))
    phase("real_updates", lambda: run_real_updates(state, dev))
    phase("baked", lambda: baked_phase(state, dev))
    phase("reference", reference_phase)
    phase("captures", lambda: captures_phase(state, dev))
    try:   # measurements, not checks: their absence fails nothing
        profile_view(state.get("ckpt") or write_smoke_checkpoint(dev), dev)
        if "train_ckpt" in state:
            profile_baked_view(state["train_ckpt"], dev)
        if "trainer" in state:
            profile_train_block(state["trainer"])
        if "insert_insertor" in state:
            profile_insert_frame(state["insert_insertor"], dev)
    except Exception as e:   # noqa: BLE001 - the profiler is optional here
        print(f"profile: not measured ({type(e).__name__}: {e})", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)

    kernels = []
    train = state.get("train_launches", {})
    for dtype_name in ("bfloat16", "float32"):
        nums = state.get((dtype_name, MAIN_PATH_ROWS))
        if nums is None:
            continue
        # the eval slice runs both dtypes; training, and the train entry
        # point's validation renders after it, run bf16 only
        bf16 = dtype_name == "bfloat16"
        by_path = {"eval": state.get(("launches", dtype_name), 0),
                   "train": train.get("head", 0) if bf16 else 0,
                   "train_validation":
                       state.get("train_val_launches", 0) if bf16 else 0,
                   "insert": state.get("insert_launches", 0) if bf16 else 0,
                   # the eval entry point bakes in f32 (ARNERF_EVAL_BAKED)
                   "baked": 0 if bf16 else state.get("baked_launches", 0),
                   # the --eval_lpips run's validation renders (bf16)
                   "lpips_train":
                       state.get("lpips_train_launches", 0) if bf16 else 0}
        for name in ("nerf", "colmap"):
            # training runs bf16; eval runs f32 unless asked for bf16
            by_path[f"captures_train_{name}"] = state.get(
                ("capture_train", name), {}).get("head", 0) if bf16 else 0
            by_path[f"captures_eval_{name}"] = 0 if bf16 else state.get(
                ("capture_eval", name), 0)
        by_path["captures_eval_nerf_bf16"] = state.get(
            ("capture_eval_bf16", "nerf"), 0) if bf16 else 0
        by_path["captures_baked_colmap"] = 0 if bf16 else state.get(
            ("capture_baked", "colmap"), 0)
        kernels.append({
            "name": f"fused_field_head[{dtype_name}]", "route": "cuda",
            "source": "arnerf_tpu_torch/csrc/fused_head.cu",
            "replaces": "arnerf_tpu/ops/fused_head.py:42",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(state[(dtype_name, r)]["max_abs_err"]
                               for r in (PARITY_ROWS, MAIN_PATH_ROWS)
                               if (dtype_name, r) in state),
            **{k: nums[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "rel_frobenius")},
            "rows": nums["rows"]})
    for mode in ("pack", "exact"):
        nums = state.get(("segment_sum", mode))
        if nums is None:
            continue
        by_path = {"train": train.get(mode, 0)}
        for name in ("nerf", "colmap"):
            by_path[f"captures_train_{name}"] = state.get(
                ("capture_train", name), {}).get(mode, 0)
        kernels.append({
            "name": f"segment_sum[{mode}]", "route": "cuda",
            "source": "arnerf_tpu_torch/csrc/segment_sum.cu",
            "replaces": "arnerf_tpu/ops/segments.py:86",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{k: nums[k] for k in ("max_abs_err", "ms", "eager_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "level_major_ms")},
            "updates": nums["updates"],
            # the same numbers on one real training step's updates
            "real": state.get(("segment_sum_real", mode))})
    print(json.dumps({"kernels": kernels}), flush=True)

    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
