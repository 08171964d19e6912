#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (arnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases (all run, even after a failure; any failure exits non-zero):
  1. build     - compile every CUDA kernel from csrc/ with nvcc (sm_90a),
                 all nvcc processes started together; fails if ptxas
                 reports a spill.
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
                 renders the checkpoint at 800x800. The segment-sum kernel
                 must run in both modes and the fused head must run; train
                 PSNR must pass 19 dB and validation PSNR 17 dB.
  real_updates - the segment sum in both modes on the updates of one real
                 post-warmup training step of the trained model (captured
                 from the hash-grid backward), against its plain version,
                 timed beside index_add_ and the level-major order.
  5. reference - a 64x64 view rendered in f32, and one f32 training step at
                 a small size, on the card (kernels) and on the CPU (plain
                 versions) must agree; the compositing's per-ray totals
                 of empty rays must be exactly zero on the card.
Then torch.profiler passes over one bf16 view and one post-warmup training
block print where their time goes (measurements only; they fail nothing).
Prints the card's name and power limit, then one JSON line of per-kernel
numbers, then the result line {"ok": true, "device": {...}}.
"""

import json
import os
import re
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
TRAIN_ARGV = ["--dataset_name", "synthetic", "--downsample", "3.125",
              "--num_epochs", "1", "--batch_size", "8192",
              "--exp_name", "smoke"]


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


def run_train(state):
    """The train entry point for one 1,000-step epoch at full width, then
    the eval entry point on its checkpoint at 800x800."""
    import numpy as np
    import torch
    from arnerf_tpu_torch import eval as port_eval
    from arnerf_tpu_torch import train as port_train
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    work = SMOKE_DIR / "train"
    work.mkdir(parents=True, exist_ok=True)
    counts = {}

    def on_block(step, metrics):    # the counters as training leaves them
        counts.update(step=step, head=fh.launches, **seg.launches)
        counts["last"] = {k: float(v) for k, v in metrics.items()}

    cwd = os.getcwd()
    os.chdir(work)
    try:
        fh.reset_launches()
        seg.reset_launches()
        t0 = time.perf_counter()
        res = port_train.main(TRAIN_ARGV, callback=on_block)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        # training's launches stop at its last block; the entry point's
        # test-split validation renders after it
        state["train_launches"] = {k: counts[k]
                                   for k in ("head", "pack", "exact")}
        state["train_val_launches"] = fh.launches - counts["head"]
        ckpt = str(work / res["ckpt_dir"] / "epoch=0.npz")
    finally:
        os.chdir(cwd)
    trainer = res["trainer"]
    state["trainer"] = trainer
    steps = counts["step"]
    tc = trainer.tc
    anneal = tc.stoch_anneal_frac * tc.total_steps
    ms = {"warmup": [], "stochastic": [], "exact": []}
    for first, t, warmup in trainer.block_times:
        kind = "warmup" if warmup else \
            "exact" if first >= anneal else "stochastic"
        ms[kind].append(1e3 * t / tc.update_interval)
    post = ms["stochastic"] + ms["exact"]
    last = counts.pop("last")
    print(f"train: {steps} steps in {train_s:.1f} s (entry point, incl. "
          f"data and validation); median ms/step "
          f"{ {k: float(np.median(v)) for k, v in ms.items() if v} }, after "
          f"warmup {np.median(post):.2f}; last block {last}", flush=True)
    print(f"train: per-block ms/step "
          f"{ {k: [round(x, 2) for x in v] for k, v in ms.items()} }",
          flush=True)
    print(f"train: launches per step segment_sum[pack] "
          f"{counts['pack'] / steps} segment_sum[exact] "
          f"{counts['exact'] / steps} fused_head {counts['head'] / steps} "
          f"(totals {counts})", flush=True)
    print(f"train: test split at 400x400 PSNR {res['psnr']} SSIM "
          f"{res['ssim']} fused-head launches "
          f"{state['train_val_launches']}", flush=True)
    fh.reset_launches()
    val = port_eval.main(["--dataset_name", "synthetic", "--downsample",
                          "6.25", "--ckpt_path", ckpt])
    print(f"train: checkpoint through eval at 800x800: PSNR {val['psnr']} "
          f"FPS {val['fps']} samples {val['total_samples']} fused-head "
          f"launches {fh.launches}", flush=True)
    state["train_summary"] = {"ms_per_step": float(np.median(post)),
                              "train_psnr": last["psnr"],
                              "val_psnr": float(np.mean(val["psnr"]))}
    if not np.isfinite(last["loss"]):
        raise AssertionError(f"non-finite loss {last['loss']}")
    if min(counts["pack"], counts["exact"], counts["head"]) == 0:
        raise AssertionError(f"a kernel never ran in training: {counts}")
    if last["psnr"] <= 19.0 or float(np.mean(val["psnr"])) <= 17.0:
        raise AssertionError(f"quality bar missed: train PSNR "
                             f"{last['psnr']}, validation {val['psnr']}")


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


def reference_train_step(dev):
    """One f32 training step at a small size (4 levels, 2^12 table, 32^3
    grid, 512 rays, exact corners, pooled sort marching): the card (the
    segment-sum kernel) against the CPU (plain versions) on the same
    inputs. Sample counts must be equal; the loss agrees to 1e-5 and each
    gradient leaf to 1e-4 of its largest entry (sum order: atomics,
    cuBLAS)."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                     SyntheticDataset,
                                                     analytic_occupancy)
    from arnerf_tpu_torch.models import NGPConfig, grid_state_init, ngp_init
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.training import trainer as tr
    from arnerf_tpu_torch.training.ckpt import tree_leaves
    cfg = NGPConfig(scale=0.5, grid_size=32, n_levels=4, log2_hashmap_size=12,
                    base_resolution=4)
    tc = tr.TrainConfig(batch_size=512, seg_cap=8)
    ds = SyntheticDataset(split="train", read_meta=False,
                          config=SyntheticConfig(img_wh=(48, 48)))
    rng = np.random.default_rng(0)
    img, pix = rng.integers(0, len(ds.poses), 512), rng.integers(0, 48 * 48,
                                                                  512)
    ro, rd = get_rays(torch.as_tensor(ds.directions[pix]),
                      torch.as_tensor(ds.poses[img]))
    gt = torch.as_tensor(rng.random((512, 3)), dtype=torch.float32)
    noise = torch.as_tensor(rng.random(512), dtype=torch.float32)
    occ = analytic_occupancy(0.5, 32, 1)
    out = {}
    for d in (dev, torch.device("cpu")):
        params = ngp_init(cfg, torch.Generator().manual_seed(3), d)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        state = grid_state_init(cfg, d)._replace(occ_flat=occ.to(d))
        seg.reset_launches()
        loss, res = tr.step_loss(params, state, ro.to(d), rd.to(d), gt.to(d),
                                 noise=noise.to(d), seed=None, rgb_bg=None,
                                 cfg=cfg, tc=tc, exp_step_factor=0.0,
                                 seg_cap=8)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out[d.type] = (float(loss.detach()), [g.cpu() for g in grads],
                       int(res["rm_samples"]), res["counts"].cpu(),
                       dict(seg.launches))
    (lg, gg, rg, cg, kl), (lc, gc, rc, cc, _) = out["cuda"], out["cpu"]
    errs = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(gg, gc)]
    print(f"reference: one f32 training step, card vs CPU: loss {lg} vs "
          f"{lc}, gradient errors relative to each leaf's largest entry "
          f"{errs}, samples {rg} vs {rc}, card segment_sum launches {kl}",
          flush=True)
    if rg != rc or not torch.equal(cg, cc):
        raise AssertionError("card and CPU sample sets differ")
    if abs(lg - lc) > 1e-5 * abs(lc) or max(errs) > 1e-4:
        raise AssertionError("card and CPU training steps disagree")
    if kl["exact"] != 1:
        raise AssertionError(f"the card's step did not launch the exact "
                             f"segment sum once: {kl}")


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
        seconds = build.build()
        print(f"build seconds (all nvcc started together): {seconds}; "
              f"already built: {sorted(set(build.KERNEL_SOURCES) - set(seconds))}",
              flush=True)
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
    phase("real_updates", lambda: run_real_updates(state, dev))
    phase("reference", reference_phase)
    try:   # measurements, not checks: their absence fails nothing
        profile_view(state.get("ckpt") or write_smoke_checkpoint(dev), dev)
        if "trainer" in state:
            profile_train_block(state["trainer"])
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
                       state.get("train_val_launches", 0) if bf16 else 0}
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
        kernels.append({
            "name": f"segment_sum[{mode}]", "route": "cuda",
            "source": "arnerf_tpu_torch/csrc/segment_sum.cu",
            "replaces": "arnerf_tpu/ops/segments.py:86",
            "launches": train.get(mode, 0),
            "launches_by_path": {"train": train.get(mode, 0)},
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
