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
                 PSNR must pass 19 dB and validation PSNR 17 dB. The
                 training callback also saves a checkpoint at step 512
                 for the viewer's live preview.
  parallel - multi-GPU training on the one card: in subprocesses with
                 torchrun's environment for a world of 1 over NCCL (this
                 process holds no process group), the train entry point at
                 the train phase's size for 256 steps (the data parallel
                 path), and a helper training the same configuration with
                 no mesh, data parallel, and with the hash table sharded on
                 a 1 x 1 mesh (NeRFTrainer(shard_table=True): all-gather
                 and reduce-scatter on the card), in turns. Both kernels
                 (the segment sum in both modes) must launch on each path,
                 the loss fall, the parameters stay finite, and after the
                 first block the data parallel and sharded parameters must
                 match the unjoined trainer's to twice the run-to-run floor
                 (a second unjoined trainer) plus 1e-2 of the block's move;
                 `--num_gpus 2` must fail, naming the one visible GPU.
                 Prints ms/step beside the unjoined trainer's and the
                 collective bytes per block.
  tools    - `python -m arnerf_tpu_torch.insert.pretabulate_fh`'s main
                 writes the SG F table (its seconds printed); the insert
                 phase's first SSDF load must then read it, not compute it
                 (counted, checked by envfit). Then
                 `arnerf_tpu_torch.insert.train_brdf` for 300 steps on the
                 card into the work directory (batch 512 x 4096 sphere
                 directions from the device threefry): the loss must fall;
                 ms/step printed.
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
                 Then ARNERF_INSERT_BAKED=1 on that prep's files: the bake
                 (192^3, 16 directions), the same frames, then a shadow
                 field and INSERT_FRAMES SH frames; the bake must launch
                 the fused head, no frame may, the segment sum never; every
                 frame but the saved one through the fused frame; 64x64
                 f32 card vs CPU on the CPU's 64^3 bake: the fast SH probe
                 to 1e-3, an SH (shadow field) frame to 1e-4 at all but
                 RENDER_FLIP_PIXELS pixels, an SG (self shadow, SSDF) frame
                 likewise off the object and its shadow, and to 5e-3, as
                 the network SG frame, under them.
  envfit   - the amortised SG fitter on the insert phase's network
                 insertor: generate_envmaps at its default 512 maps (a
                 cubemap probe through the network field per map: the fused
                 head must launch in every probe, the segment sum never;
                 s per probe printed), then EnvTrainer at full width (32
                 SGs, 128x128 maps, batch 16, full f32) for 100 epochs with
                 checkpoints every 50 and a second train() that must resume
                 at epoch 100 and go on to 200; the loss on 16 maps must
                 fall; ms per step and eval ms printed; one step from the
                 default weights on four batches (noise, SG renders, those
                 at 8 bits, the generated maps), on the CPU and on the card,
                 each held against float64 on the CPU given its own pool and
                 ReLU decisions (envfit_precision: the loss to 1e-5, each
                 gradient leaf to ENVFIT_GRAD_TOL relative, Frobenius), and
                 the same step with TF32 allowed must fail that tolerance.
  resume   - ARNERF_AUTO_RESUME=1: the train entry point at the train
                 phase's configuration for 600 steps in a subprocess
                 (chip_smoke.py --resume-worker), SIGKILLed once its
                 snapshot holds step 400; rerun, it must print the resume
                 at 400, finish at 600, remove the snapshot, keep finite
                 parameters and launch both kernels, its first block's
                 loss within 2x the killed run's last logged loss.
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
                 within 1) and the 4 test views at 64x64, trilinear and
                 stochastic, of the CPU's bake on both (the same rounds;
                 1e-4 at all but RENDER_FLIP_PIXELS pixels a view, where a
                 threshold decision may flip on an ulp).
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
                 baked eval (the multi-cascade bake and renderer, > 17
                 dB, fused-head launches in the bake), both at 620x412.
                 Both kernels must run on both training paths. One f32
                 training step of the trained scale-16 model must agree
                 card vs CPU: the loss to 1e-5, each gradient leaf to 1e-3
                 of its largest entry or to twice the CPU's own departure
                 when its rays move by 1e-7 (step_card_vs_cpu).
  hdr      - the HDR path. Every OpenEXR fixture of tests/data/exr/
                 through the port's reader: the supported ones (NONE,
                 RLE, ZIPS, ZIP, PIZ; HALF and FLOAT; RGB and RGBA; an
                 offset data window, decreasing line order; PIZ's short
                 last block, raw block and 16-bit wavelet) equal to the
                 values written, the others refused; the PIZ decode rate
                 printed. Then a
                 colmap_exr capture (64 HALF ZIP views at 800x600, HDR
                 radiance up to ~3.8 over a background of 1) trained with
                 `--use_EXR --loss_func log` for 1,000 steps at the
                 defaults (full width), one block traced for its idle
                 share, eval on its checkpoint, and one f32 step card vs
                 CPU (loss 1e-5, leaves 1e-4); an HDR-NeRF capture (35
                 views at 200x200, five exposures) trained with
                 `--use_exposure` (480 steps; the unit-exposure anchor
                 printed); a myblender capture (32 views at 400x300)
                 trained with `--use_EXR --optimize_ext` (320 steps; the
                 pose deltas must move and stay under 1e-3); and the
                 insertion server on the --use_EXR checkpoint at 200x150
                 (the AR smoke's prep, 4 object moves, a saved frame whose
                 EXR, read back, must be finite and pass 1). Each training
                 must lower its loss; both kernels must run in training
                 and the fused head in the insertion.
  viewer   - `python -m arnerf_tpu_torch.show_gui` headless (no DISPLAY) on
                 the train phase's checkpoint at 800x800, as a subprocess,
                 on the network frame and with ARNERF_GUI_BAKED=1 (256^3
                 bake, display frames): each exits 0 and prints its FPS
                 line, the baked one its bake line. The live preview: a
                 baked NGPGUI on the train phase's step-512 checkpoint,
                 the final checkpoint copied over it, refresh_bake once
                 (a delta within its budget, frac < 1) and frames again.
                 Card against CPU: a 64x64 network frame (1e-3, equal
                 samples), the live bake's display frame at 64x64 from one
                 key (at most RENDER_FLIP_PIXELS pixels more than one level
                 apart, rounds equal), and an exact-corner delta bake at
                 64^3 from the step-512 to the final checkpoint (stats and
                 snapshots equal, rows to 1e-4 of their largest entry;
                 DELTA_CHECK_K deltas on the card reach a fresh full bake to
                 1e-4). One frame of each HDR checkpoint, finite in [0, 1].
                 The fused head must launch on the network frames, the
                 bakes and the delta.
Then torch.profiler passes over one bf16 view, one baked view, one
post-warmup training block and one network and one baked AR frame print
where their time goes;
the baked view's pass bakes with exact corners and prints that bake's
seconds and its PSNR on the 4 views; then one network and one baked viewer
frame (measurements only; they fail nothing).
Prints the card's name and power limit, then one JSON line of per-kernel
numbers, then the result line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --multi-gpu    # four cards: multi_gpu_main

measures the train entry point on the cards of one host (1 rank, 4 data
parallel ranks, 2 x 2 with the table sharded) instead.

    python3 chip_smoke.py --step-census [N]    # one card: step_census_main

trains the captures phase's COLMAP model and holds its card-vs-CPU step
on N ray sets (20 by default) instead of one.
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
INSERT_BAKE_CHECK_RES = 64      # card-vs-CPU baked AR frames (B^3 voxels)
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
# the colmap eval entry point's repeats (network and baked) of the test
# views its training validated at full size run at 620x412
COLMAP_EVAL_ARGV = ["--downsample", "0.5"]
BAKE_DIRS = 32                  # bake_ngp's quadrature directions
BAKE_CHECK_RES = 64             # card-vs-CPU bake (B^3 voxels)
RENDER_FLIP_PIXELS = 4          # of a 64x64 view (baked_card_vs_cpu)
EXR_FIXTURES = ROOT / "tests" / "data" / "exr"
HDR_DIR = SMOKE_DIR / "hdr"
HDR_EXR_VIEWS, HDR_EXR_WH = 64, (800, 600)   # colmap_exr: 56 train, 8 test
HDR_INSERT_FRAMES = 4           # object moves of the HDR insertion
HDR_ARGV = {
    # raw HDR radiance with the reference's HDR log loss, one epoch
    "exr": ["--dataset_name", "colmap_exr", "--use_EXR", "--loss_func",
            "log", "--num_epochs", "1", "--batch_size", "8192"],
    # HDR-NeRF's tonemapper heads on five exposures; cut to 480 steps
    "exposure": ["--dataset_name", "colmap", "--use_exposure",
                 "--num_epochs", "1", "--steps_per_epoch", "480",
                 "--batch_size", "8192"],
    # pose refinement on raw HDR radiance; cut to 320 steps
    "pose": ["--dataset_name", "myblender", "--use_EXR", "--optimize_ext",
             "--num_epochs", "1", "--steps_per_epoch", "320",
             "--batch_size", "8192"]}
VIEWER_DIR = SMOKE_DIR / "viewer"
GUI_ARGV = ["--dataset_name", "synthetic", "--downsample", "6.25"]  # 800^2
MID_STEP = 512                  # the train phase's mid-run checkpoint
DELTA_CHECK_K = 4               # refresh_k of the card-vs-CPU delta check
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


def train_entry(argv, work, label, save_at=None):
    """The train entry point with `argv` in `work`, every launch counter
    set to 0 just before: returns its result, the counters at its last
    training block, each block's metrics and the launches of its test-split
    validation. save_at: a step after which the callback also saves a
    checkpoint (`mid_ckpt`), as a training run watched by the viewer does."""
    import numpy as np
    import torch
    from arnerf_tpu_torch import train as port_train
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    work.mkdir(parents=True, exist_ok=True)
    counts, blocks = {}, []

    mid_ckpt = work / "mid" / f"step={save_at}.npz"

    def on_block(step, metrics, trainer):   # the counters as training
        counts.update(step=step, head=fh.launches, **seg.launches)
        blocks.append({k: float(v) for k, v in metrics.items()})
        if step == save_at:
            mid_ckpt.parent.mkdir(parents=True, exist_ok=True)
            trainer.save(mid_ckpt)

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
        if save_at is not None:
            res["mid_ckpt"] = str(mid_ckpt)
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
    res = train_entry(TRAIN_ARGV, SMOKE_DIR / "train", "train",
                      save_at=MID_STEP)
    counts, last = res["counts"], res["blocks"][-1]
    state["train_launches"] = {k: counts[k] for k in ("head", "pack", "exact")}
    state["train_val_launches"] = res["val_launches"]
    state["train_ckpt"] = res["ckpt"]
    state["train_mid_ckpt"] = res["mid_ckpt"]
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
    bake renders the 4 test views at 64x64 on both, trilinear and
    stochastic (bricks) from the same key: rounds equal, and rgb, opacity
    and depth to 1e-4 at every pixel but at most RENDER_FLIP_PIXELS a
    view. Those few may flip: the renderer takes discrete decisions on
    float sums and exp (a bucket's colour voxel rounded from its mean
    depth, a sample's opacity bucket, its inclusion above T_threshold),
    and there the card's and the CPU's values differ by an ulp."""
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
        errs[interp] = []
        for pose in ds.poses:
            outs, stats = {}, {}
            for (side, d), bk in zip(sides, (moved, c)):
                ro, rd = get_rays(torch.as_tensor(ds.directions, device=d),
                                  torch.as_tensor(pose, device=d))
                stats[side] = {}
                outs[side] = render_baked(bk, None, ro, rd, cfg,
                                          key=threefry.prng_key(7),
                                          interp=interp, img_wh=(64, 64),
                                          stats=stats[side])
            if not all(torch.isfinite(outs["card"][k]).all()
                       for k in ("rgb", "opacity", "depth")):
                raise AssertionError(f"baked {interp}: non-finite render")
            # per pixel: the largest error of rgb, opacity and depth
            px = torch.stack([(outs["card"][k].cpu() - outs["cpu"][k])
                              .abs().reshape(64 * 64, -1).amax(dim=1)
                              for k in ("rgb", "opacity", "depth")], dim=1)
            flips = px.amax(dim=1) > 1e-4
            errs[interp].append({
                "max": [float(x) for x in px[~flips].amax(dim=0)]
                if not flips.all() else None,
                "flipped": int(flips.sum()),
                "flipped_max": float(px[flips].max()) if flips.any()
                else 0.0,
                "rounds": (stats["card"]["rounds"], stats["cpu"]["rounds"])})
    print(f"baked: card vs CPU renders of the 4 test views at 64x64 of the "
          f"CPU's bake (per view: the largest rgb, opacity and depth error "
          f"of the pixels within 1e-4, the pixels over it and their "
          f"largest error, rounds): {errs}", flush=True)
    if rows_err > 1e-4 or max(code_err.values()) > 1 or not same_index:
        raise AssertionError("card and CPU bakes disagree")
    for interp, views in errs.items():
        for e in views:
            if e["flipped"] > RENDER_FLIP_PIXELS \
                    or e["rounds"][0] != e["rounds"][1]:
                raise AssertionError(f"card and CPU baked renders disagree "
                                     f"({interp}): {e}")
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


def _busy(prof, spans=()):
    """A trace's device events (less the host spans' device ranges) and
    their summed time in ms."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in spans]
    return kernels, sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def block_idle_share(trainer):
    """One post-training block traced on the device: (idle share = 1 -
    kernel-time sum / CUDA-event wall, wall ms), or (None, wall ms) when
    the trace holds no device events."""
    from torch.profiler import ProfilerActivity
    while trainer.step % trainer.tc.update_interval:   # align to a block
        trainer.train_step()
    trainer.train_block()
    wall_ms, prof = _timed_block(trainer, [ProfilerActivity.CUDA])
    kernels, busy_ms = _busy(prof)
    return (1 - busy_ms / wall_ms if kernels else None), wall_ms


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
    plain_ms, _ = _timed_block(trainer)
    dev_wall_ms, prof = _timed_block(trainer, [ProfilerActivity.CUDA])
    dev_kernels, dev_busy_ms = _busy(prof, spans)
    wall_ms, prof = _timed_block(trainer, [ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
    kernels, busy_ms = _busy(prof, spans)
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
    (plain versions). The loss agrees to 1e-5; the sample totals differ by
    at most sample_tol of the CPU's, and with sample_tol 0 every ray's
    count is equal. Each gradient leaf agrees to grad_tol of its largest
    entry (sum order: atomics, cuBLAS). Under exp stepping
    (exp_step_factor > 0) the card's and the CPU's float32 exp and log
    differ by an ulp, so every sample lies a rounding apart (5e-7 of t in
    H100 runs), and a trained model's gradient jumps where that moves a
    ReLU input across 0 or a sample across a cell. On the scale-16 COLMAP
    model such a jump moves the CPU's own gradients past 1e-3 of a leaf's
    largest entry in some sets of 512 rays when its rays move by 1e-7
    (`--step-census` prints it for many sets). So there the tolerance is
    grad_tol or twice the CPU's own floor, whichever is larger: the
    largest departure of its gradients when rays_o or rays_d is scaled by
    1 +- 1e-7. Returns the loss's relative difference."""
    import torch
    from arnerf_tpu_torch.models import grid_state_init
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.training import trainer as tr
    from arnerf_tpu_torch.training.ckpt import tree_leaves

    def step(d, o_scale=1.0, d_scale=1.0):
        p = _tree_to(params, d)
        state = grid_state_init(cfg, d)._replace(occ_flat=occ.to(d))
        seg.reset_launches()
        loss, res = tr.step_loss(p, state, (ro * o_scale).to(d),
                                 (rd * d_scale).to(d), gt.to(d),
                                 noise=noise.to(d), seed=None, rgb_bg=None,
                                 cfg=cfg, tc=tc,
                                 exp_step_factor=exp_step_factor,
                                 seg_cap=tc.seg_cap)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return (float(loss.detach()), [g.cpu() for g in grads],
                int(res["rm_samples"]), res["counts"].cpu(),
                dict(seg.launches))

    def grad_errs(ga, gb):
        return [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(ga, gb)]

    cpu = torch.device("cpu")
    lg, gg, rg, cg, kl = step(dev)
    lc, gc, rc, cc, _ = step(cpu)
    errs = grad_errs(gg, gc)
    floor = 0.0
    if exp_step_factor > 0:
        floor = max(max(grad_errs(step(cpu, *scales)[1], gc))
                    for scales in ((1 + 1e-7, 1), (1 - 1e-7, 1),
                                   (1, 1 + 1e-7), (1, 1 - 1e-7)))
    tol = max(grad_tol, 2 * floor)
    rel = abs(lg - lc) / abs(lc)
    rays_off = int((cg != cc).sum())
    print(f"{label}: one f32 training step (scale {cfg.scale}, "
          f"{cfg.cascades} cascades), card vs CPU: loss {lg} vs {lc} "
          f"(relative {rel:.3g}), gradient errors relative to each leaf's "
          f"largest entry {errs} (the CPU's own floor {floor:.3g}, "
          f"tolerance {tol:.3g}), samples {rg} vs {rc} ({rays_off} rays' "
          f"counts differ), card segment_sum launches {kl}", flush=True)
    if abs(rg - rc) > sample_tol * rc or (sample_tol == 0 and rays_off):
        raise AssertionError(f"{label}: card and CPU sample sets differ")
    if rel > 1e-5 or max(errs) > tol:
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


def _insert_hparams(ckpt, downsample, device, compute_dtype="auto",
                    scene=("--dataset_name", "synthetic")):
    from arnerf_tpu_torch.opt import get_opts
    return get_opts([*scene, "--downsample", str(downsample), "--ckpt_path",
                     ckpt, "--exp_name", "smoke", "--device", device,
                     "--compute_dtype", compute_dtype])


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


def _shadow_field_volume(path, seed=0):
    """A seeded shadow-field export in the viewer's text layout (30^3
    cells, 9 SH coefficients each)."""
    import numpy as np
    np.savetxt(path, np.random.default_rng(seed).normal(
        2.0, 0.3, (30 ** 3, 9)), fmt="%.4f")


def run_insert(ckpt, dev, downsample=6.25, frames=INSERT_FRAMES,
               probe_points=INSERT_PROBE_POINTS, radius=0.1, min_plane=1e5,
               scene=("--dataset_name", "synthetic"),
               work=SMOKE_DIR / "insert", center=(0.22, 0.17, 0.12),
               baked=False):
    """The insertion server's path on `dev` for the scene's flags `scene`:
    the prep (insertor, surface cache and point cloud, planes, probe
    precompute cut to `probe_points`, 200 global-SH iterations) and then
    NGPServer behind a real socket with a viewer that sends the camera, the
    SSDF volume and `frames` frames of object moves (actions 1, 3, 6), one
    shadow-map frame and one saved frame, under `work`; the object, a
    sphere of `radius`, moves from `center`. `baked`: ARNERF_INSERT_BAKED=1
    on the prep of an earlier run in `work` (its surface cache, point cloud
    and global-SH checkpoint loaded), then the bake ("bake" stage), the
    same frames, a shadow field (action 8: the SH pipeline) and `frames`
    SH object moves. Returns the measurements; checks nothing itself."""
    import struct
    import threading
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert import main as im
    from arnerf_tpu_torch.insert.global_light import GlobalLightEstimator
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.insert.insert_models import load_mat_sh_ckpt
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    if not baked:
        shutil.rmtree(work / "insert", ignore_errors=True)
    sh_frames = frames if baked else 0
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
        os.environ["ARNERF_INSERT_BAKED"] = "1" if baked else "0"
        try:
            ins = stage("insertor", lambda: im.NGPInsertor(
                _insert_hparams(ckpt, downsample, dev.type, scene=scene)))
        finally:
            del os.environ["ARNERF_INSERT_BAKED"]
        stage("surface_and_point_cloud", ins.generate_point_cloud)
        if baked:
            results = os.path.join(ins.gen_path, "results")
            shutil.rmtree(results)       # the network run's saved frame
            os.makedirs(results)
            gsh, _ = load_mat_sh_ckpt(os.path.join(
                ins.gen_path, "mat_sh_000199.npz"), dev)
            ins.global_sh = gsh["global_sh"].reshape(1, 9, 3)
            stage("bake", ins._get_baked)
        else:
            gle = stage("planes", lambda: GlobalLightEstimator(ins.gen_path))
            stage("planes", lambda: gle.detect_planar_patch(min_plane))
            n_plane = len(gle.t_pts)
            keep = np.random.default_rng(0).permutation(n_plane)[
                :probe_points]
            gle.t_pts, gle.t_rgbs, gle.t_normal = (
                gle.t_pts[keep], gle.t_rgbs[keep], gle.t_normal[keep])
            print(f"insert: {n_plane} planar points; the probe precompute is "
                  f"cut to {len(keep)} points x 2048 rays (the reference's "
                  f"pts_use 2e6 would take hours)", flush=True)
            stage("probe_precompute", lambda: gle.save_results(ins))
            stage("global_sh_fit", lambda: ins.fit_global_sh(gle))
        res["prep_samples"] = sum(samples)
        res["global_sh_dc"] = ins.global_sh[0, 0].tolist()

        # serving: NGPServer in a thread, this thread the viewer
        _ssdf_volume(work / "smoke_mesh.tar")
        os.environ["VIEWER_SG_PATH"] = str(work)
        if sh_frames:
            _shadow_field_volume(work / "smoke_sf.txt")
            os.environ["VIEWER_SF_PATH"] = str(work)
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
        fused = []
        frame_fn = ins._frame_fused_fn
        ins._frame_fused_fn = lambda *a: fused.append(1) or frame_fn(*a)
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
            c = (center[0] + 0.004 * i, center[1], center[2] - 0.003 * i)
            bbox, raster = sphere_raster(pose, ins.K, H, W, c, radius)
            n0, s0 = fh.launches, len(samples)
            t0 = time.perf_counter()
            viewer.send(1, struct.pack("ifff", mode, *c) + rot)
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
        if sh_frames:
            viewer.send(8, b"smoke_sf")
            for i in range(sh_frames):
                frame(frames + 2 + i, 1)
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
        res["sh_frames"] = sh_frames
        res["fused_frames"] = len(fused)
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


def profile_insert_frame(ins, dev, label="network"):
    """Where one serving frame's time goes (probe + SG fit, object shade,
    dirty-rect render, SSDF shadow), called directly on the insertor the
    server used (`label`: its path): wall time, device busy time, idle
    share, top kernels."""
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
             "field", "composite", "cull", "prelude", "color")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in spans]
    if not kernels:
        print(f"insert profile, {label}: wall {wall_ms:.1f} ms; device "
              f"time not measured (no device events)", flush=True)
        return None
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"insert profile, {label} (one frame: probe + SG fit + shade + "
          f"rect render + SSDF shadow, {ins.W}x{ins.H}): wall "
          f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), "
          f"{len(kernels)} device kernels/copies", flush=True)
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            print(f"  span {e.key}: host {e.cpu_time_total / 1e3:.1f} ms, "
                  f"device {e.device_time_total / 1e3:.1f} ms (kernel sum), "
                  f"calls {e.count}")
    _print_kernels(kernels, 12)


def insert_phase(state, dev):
    """The AR insertion server at 800x800 from the train phase's checkpoint
    (or the random-weights one): the network path, then the baked field on
    its prep (run even when the network part fails)."""
    ckpt = state.get("train_ckpt") or state.get("ckpt") \
        or write_smoke_checkpoint(dev)
    try:
        insert_network(state, dev, ckpt)
    finally:
        insert_baked(state, dev, ckpt)


def insert_network(state, dev, ckpt):
    """run_insert on the card, with its checks, then the card-vs-CPU frame
    check at 64x64."""
    import numpy as np
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


def insert_baked(state, dev, ckpt):
    """ARNERF_INSERT_BAKED=1: run_insert on the network run's prep (its
    files loaded), the bake at ARNERF_INSERT_BAKE_RES's default, then the
    same frames, and INSERT_FRAMES SH frames on a shadow field. The bake
    must launch the fused head, a frame never; the segment sum never runs;
    every frame but the saved one goes through _try_render_insert_fused;
    frames are 800x800 and finite; the saved files are there. Then
    insert_baked_card_vs_cpu."""
    import numpy as np
    res = run_insert(ckpt, dev, baked=True)
    ins = res["insertor"]
    state["insert_baked_launches"] = res["head_launches"]
    state["insert_baked_insertor"] = ins
    n, m = res["regular_frames"], res["sh_frames"]
    a1, a6 = (np.asarray(res["action_ms"][a]) for a in (1, 6))
    fit, trip = np.asarray(res["sg_fit_ms"]), np.asarray(res["frame_ms"])
    sg, sh = slice(1, n), slice(n + 3, n + 2 + m)   # after their first
    n_frames = len(res["frames"])
    summary = {
        "bake_s": res["prep_s"]["bake"],
        "bake_launches": res["launches"]["bake"],
        "bake_voxels": int(ins._baked.rows_q.shape[0]) - 1,
        "bake_res": ins._baked.resolution,
        "sg_action1_ms": float(np.median(a1[sg])),
        "sg_fit_ms": float(np.median(fit[sg])),
        "sg_action6_ms": float(np.median(a6[sg])),
        "sg_round_trip_ms": float(np.median(trip[sg])),
        "sh_action1_ms": float(np.median(a1[sh])),
        "sh_action6_ms": float(np.median(a6[sh])),
        "sh_round_trip_ms": float(np.median(trip[sh])),
        "fused_frames": res["fused_frames"], "frames": n_frames,
        "network": state.get("insert_summary")}
    print(f"insert baked: prep seconds {res['prep_s']}; fused-head launches "
          f"{res['launches']}; serving (ms; first frames are warm-up): "
          f"action 1 {a1.tolist()}; SG fit {fit.tolist()}; action 6 "
          f"{a6.tolist()}; round trip {trip.tolist()}; fused-head launches "
          f"per frame {res['frame_launches']}; segment_sum launches "
          f"{res['segment_sum_launches']}; saved {res['saved']}", flush=True)
    print(f"insert baked summary (medians after warm-up; {n - 1} SG frames "
          f"with SSDF shadow, {m - 1} SH frames with the shadow field): "
          f"{summary}", flush=True)
    state["insert_baked_summary"] = summary
    if res["launches"]["bake"] == 0:
        raise AssertionError("the bake launched no fused-head kernel")
    if max(res["frame_launches"]) != 0:
        raise AssertionError(f"a baked frame launched the fused head: "
                             f"{res['frame_launches']}")
    if any(res["segment_sum_launches"].values()):
        raise AssertionError(f"the segment sum ran in the baked insert "
                             f"path: {res['segment_sum_launches']}")
    if res["fused_frames"] != n_frames - 1 or m < 2:
        raise AssertionError(f"{res['fused_frames']} of {n_frames} frames "
                             f"through the fused frame ({m} SH)")
    if not {"0_smoke.png", "0_smoke.exr", "0_info.npz"} <= set(res["saved"]):
        raise AssertionError(f"the saved frame is missing: {res['saved']}")
    for f in res["frames"]:
        if f.shape != (800, 800, 3) or not np.isfinite(f).all():
            raise AssertionError(f"bad baked frame: {f.shape}, finite "
                                 f"{np.isfinite(f).all()}")
    summary["card_vs_cpu"] = insert_baked_card_vs_cpu(ckpt, ins, dev)


def insert_baked_card_vs_cpu(ckpt, ins_card, dev, downsample=0.5):
    """Baked AR frames at 64x64 in f32 on the CPU and on the card: the
    CPU's bake (exact corners, INSERT_BAKE_CHECK_RES^3) moved to the card,
    the same light, volumes and object raster, the same key. The fast SH
    probe's coefficients to INSERT_TOL[0]; an SH frame (neural BRDF,
    shadow field) to 1e-4 at all but RENDER_FLIP_PIXELS pixels (a
    threshold decision of the renderer may flip on an ulp); an SG frame
    (self shadow, SSDF shadow) likewise at the pixels off the object and
    its shadow (the baked rect alone), and to INSERT_TOL[1], as the
    network SG frame, at the object's pixels (depth > 1e-6) and the
    pixels that the SSDF shadow darkens by more than 1e-5 on either
    device, where the SG lobes' conditioning acts. Both frames go through
    the fused frame. Prints each region's pixels, its pixels over 1e-4
    and its largest error."""
    import dataclasses
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert import main as im
    from arnerf_tpu_torch.insert.envfit import trans_raw_sg
    from arnerf_tpu_torch.ops import threefry
    from arnerf_tpu_torch.rendering_baked import BakedField
    work = SMOKE_DIR / "insert"
    cwd = os.getcwd()
    os.chdir(work)
    os.environ["ARNERF_INSERT_BAKED"] = "1"
    os.environ["ARNERF_INSERT_BAKE_RES"] = str(INSERT_BAKE_CHECK_RES)
    try:
        outs, fused, bake, shadowed = [], [], None, []
        for d in (torch.device("cpu"), dev):
            ins = im.NGPInsertor(_insert_hparams(ckpt, downsample, d.type,
                                                 "float32"))
            ins.cfg = dataclasses.replace(ins.cfg, fused_head=True)
            if bake is None:
                t0 = time.perf_counter()
                bake = ins._get_baked()
                bake_s = time.perf_counter() - t0
            else:
                ins._baked = BakedField(**{
                    k: v.to(d) if torch.is_tensor(v) else v
                    for k, v in vars(bake).items()})
            ins.global_sh = ins_card.global_sh.to(d)
            ins.set_sg_shadow(str(work / "smoke_mesh.tar"))
            ins.set_sf(os.path.join(ins_card.gen_path, "model_data",
                                    "smoke_sf.npz"))
            frame_fn = ins._frame_fused_fn
            ins._frame_fused_fn = \
                lambda *a, f=frame_fn: fused.append(1) or f(*a)
            pose = ins.dataset.poses[0]
            center = (0.22, 0.17, 0.12)
            bbox, raster = sphere_raster(pose, ins.K, ins.H, ins.W, center,
                                         0.1)
            raster = np.ascontiguousarray(raster[::-1])
            kw = dict(model_bbox=bbox, model_bbox_last=None,
                      model_radius=0.1, model_pos=center,
                      model_rot_inv=np.eye(3, dtype=np.float32),
                      gen_shadow=1)
            ins.key = threefry.prng_key(7)
            sh = ins.generate_probe(list(center), sh_probe=True)
            rgb_sh = ins.render_insert_object(
                raster[..., :3], raster[..., 3], pose, sh, 0.5, 0.4,
                use_sg_base=False, sg_use_self_shadow=False, **kw)
            rgb_sg = ins.render_insert_object(
                raster[..., :3], raster[..., 3], pose,
                trans_raw_sg(ins_card.env_opt.lgt_sgs.to(d)), **kw)
            # last_rgb is the frame before the shadow (LDR: no tonemap)
            shadowed.append(np.abs(
                rgb_sg - ins.last_rgb.cpu().numpy()).max(axis=-1) > 1e-5)
            outs.append((sh.cpu().numpy(), rgb_sh, rgb_sg))
    finally:
        os.chdir(cwd)
        del os.environ["ARNERF_INSERT_BAKED"]
        del os.environ["ARNERF_INSERT_BAKE_RES"]
    (sh_c, *frames_c), (sh_g, *frames_g) = outs
    res = {"bake_res": INSERT_BAKE_CHECK_RES, "cpu_bake_s": bake_s,
           "voxels": int(bake.rows_q.shape[0]) - 1,
           "probe_err": float(np.abs(sh_g - sh_c).max()), "frames": {}}
    (hs, ws), (hl, wl) = bbox
    on_object = np.zeros(shadowed[0].shape, bool)
    on_object[hs:hl, ws:wl] = raster[..., 3] > 1e-6
    in_shadow = (shadowed[0] | shadowed[1]) & ~on_object
    regions = {"sh": {"all": np.ones_like(on_object)},
               "sg": {"object": on_object, "shadow": in_shadow,
                      "rest": ~(on_object | in_shadow)}}
    for name, g, c in zip(("sh", "sg"), frames_g, frames_c):
        if not np.isfinite(g).all():
            raise AssertionError(f"non-finite baked card frame ({name})")
        px = np.abs(g - c).max(axis=-1)
        res["frames"][name] = {
            region: {"pixels": int(m.sum()),
                     "over_1e-4": int((px[m] > 1e-4).sum()),
                     "max_err": float(px[m].max()) if m.any() else 0.0}
            for region, m in regions[name].items()}
    print(f"insert baked: card vs CPU at 64x64 f32 on the CPU's bake: {res}; "
          f"fused frames {len(fused)} of 4", flush=True)
    if len(fused) != 4:
        raise AssertionError("a card-vs-CPU frame missed the fused frame")
    sh, sg = res["frames"]["sh"], res["frames"]["sg"]
    if res["probe_err"] > INSERT_TOL[0] \
            or sh["all"]["over_1e-4"] > RENDER_FLIP_PIXELS \
            or sg["rest"]["over_1e-4"] > RENDER_FLIP_PIXELS \
            or max(sg["object"]["max_err"],
                   sg["shadow"]["max_err"]) > INSERT_TOL[1]:
        raise AssertionError("card and CPU baked AR frames disagree")
    return res


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


def capture_card_vs_cpu(trainer, dev, label="captures", sample_tol=1e-4,
                        grad_tol=1e-3, seed=1):
    """step_card_vs_cpu on a trained model: its weights and occupancy, 512
    rays of its training views, f32, exact corners. On the scale-16
    COLMAP model (the defaults) exp stepping places samples with exp and
    log, and the cascade of a sample comes from log2; the card's and the
    CPU's float32 versions of these may differ by an ulp, which moves a
    sample across a cell or cascade boundary now and then (2 of 193,514
    in an H100 run). So there the sample totals may differ by 1e-4 of the
    total and each gradient leaf by 1e-3 of its largest entry, or by twice
    the CPU's own floor (step_card_vs_cpu); the loss is held to 1e-5 as at
    scale 0.5."""
    import dataclasses
    import numpy as np
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    rng = np.random.default_rng(seed)
    images = trainer.images.cpu().numpy()
    img = rng.integers(0, len(images), 512)
    pix = rng.integers(0, images.shape[1], 512)
    ro, rd = get_rays(torch.as_tensor(trainer.dataset.directions[pix]),
                      torch.as_tensor(trainer.dataset.poses[img]))
    cfg = dataclasses.replace(trainer.cfg, compute_dtype="float32",
                              stoch_corners=False)
    tc = dataclasses.replace(trainer.tc, batch_size=512)
    return step_card_vs_cpu(
        label, cfg, tc, trainer.params, trainer.grid_state.occ_flat,
        ro, rd, torch.as_tensor(images[img, pix, :3]),
        torch.as_tensor(rng.random(512), dtype=torch.float32),
        trainer.exp_step_factor, dev, sample_tol=sample_tol,
        grad_tol=grad_tol)


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
        eval_argv = argv + (COLMAP_EVAL_ARGV if name == "colmap" else [])
        val = eval_entry(eval_argv + ["--ckpt_path", res["ckpt"], *extra],
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
            vb = eval_entry(eval_argv + ["--ckpt_path", res["ckpt"]],
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


def exr_fixture_check():
    """Every fixture of tests/data/exr/ through the port's OpenEXR reader:
    the supported ones must hold their values exactly (expected.npy,
    expected_piz.npy for the PIZ files, or a .npy of the file's own name:
    FLOAT channels the generator's values, HALF channels those rounded to
    HALF), the unsupported ones must raise. Prints the PIZ files' decode
    rate (float32 output bytes per second, each file read 20 times)."""
    import numpy as np
    from arnerf_tpu_torch.image_io import read_exr
    expected = {"": np.load(EXR_FIXTURES / "expected.npy"),
                "piz": np.load(EXR_FIXTURES / "expected_piz.npy")}
    worst, read, refused = 0.0, [], []
    for path in sorted(EXR_FIXTURES.glob("*.exr")):
        if path.name.startswith("unsupported_"):
            try:
                read_exr(str(path))
            except ValueError as e:
                refused.append(str(e).split(": ", 1)[1][:40])
                continue
            raise AssertionError(f"{path.name}: read, but must be refused")
        own = path.with_suffix(".npy")
        codec, kind, chans = path.stem.split("_")[:3]
        values = expected["piz" if codec == "piz" else ""]
        if own.exists():
            want = np.load(own)
        else:
            want = (np.concatenate([values[1][..., :2], values[0][..., 2:]],
                                   -1) if kind == "mixed"
                    else values[0 if kind == "float" else 1])
            want = want if "rgba" in chans else want[..., :3]
        img = read_exr(str(path))
        if img.shape != want.shape:
            raise AssertionError(f"{path.name}: shape {img.shape}, expected "
                                 f"{want.shape}")
        worst = max(worst, float(np.abs(img - want).max()))
        read.append(path.name)
    piz = sorted(str(p) for p in EXR_FIXTURES.glob("piz_*.exr"))
    t0 = time.perf_counter()
    nbytes = sum(read_exr(p).nbytes for _ in range(20) for p in piz)
    rate = nbytes / (time.perf_counter() - t0) / 1e6
    print(f"hdr: {len(read)} EXR fixtures decoded ({len(piz)} PIZ), max abs "
          f"error {worst}; {len(refused)} refused: {refused}; PIZ fixtures "
          f"decode at {rate:.1f} MB/s of float32 output (one thread, "
          f"files of 2-20 KB)", flush=True)
    if worst != 0.0 or len(read) < 28 or len(piz) < 9 or len(refused) < 10:
        raise AssertionError("the OpenEXR fixtures did not decode as "
                             "written")
    return rate


def _loss_fell(blocks):
    """The first and last block losses; fails if not finite or not
    lower at the end."""
    import numpy as np
    first, last = blocks[0]["loss"], blocks[-1]["loss"]
    if not all(np.isfinite(b["loss"]) for b in blocks) or last >= first:
        raise AssertionError(f"training did not converge: block losses "
                             f"{[b['loss'] for b in blocks]}")
    return first, last


def hdr_phase(state, dev):
    """The HDR path: the EXR fixtures; a colmap_exr capture trained with
    --use_EXR --loss_func log and evaluated; an HDR-NeRF capture trained
    with --use_exposure; a myblender capture trained with --optimize_ext;
    one HDR step card vs CPU; and the insertion server on the --use_EXR
    checkpoint with its saved EXR read back."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.datasets import captures
    from arnerf_tpu_torch.image_io import read_exr
    from arnerf_tpu_torch.models.ngp import ngp_log_radiance_to_rgb
    exr_fixture_check()
    shutil.rmtree(HDR_DIR, ignore_errors=True)
    HDR_DIR.mkdir(parents=True)
    summary, counts, failures = {}, {"head": 0, "pack": 0, "exact": 0}, []

    def train(name, root):
        res = train_entry(HDR_ARGV[name] + ["--root_dir", str(root),
                                            "--exp_name", name],
                          HDR_DIR / f"train_{name}", f"hdr[{name}]")
        for k in counts:
            counts[k] += res["counts"][k]
        state.setdefault("hdr_val_launches", 0)
        state["hdr_val_launches"] += res["val_launches"]
        try:
            first, last = _loss_fell(res["blocks"])
        except AssertionError as e:
            failures.append(f"{name}: {e}")
            first = last = float("nan")
        summary[name] = {"steps": res["counts"]["step"],
                         "ms_per_step": res["ms_per_step"],
                         "train_psnr": res["blocks"][-1]["psnr"],
                         "val_psnr": float(np.mean(res["psnr"])),
                         "first_loss": first, "last_loss": last,
                         "launches": {k: res["counts"][k] for k in counts}}
        return res

    t0 = time.perf_counter()
    exr_root = HDR_DIR / "colmap_exr"
    written = captures.write_colmap_exr_capture(
        str(exr_root), n_views=HDR_EXR_VIEWS, wh=HDR_EXR_WH, focal=700.0,
        device=dev)
    hi = float(np.mean([np.mean(img > 1) for img in written]))
    print(f"hdr: colmap_exr capture of {HDR_EXR_VIEWS} views at "
          f"{HDR_EXR_WH} in {time.perf_counter() - t0:.1f} s (HALF ZIP); "
          f"{hi:.3f} of the values above 1, max "
          f"{max(float(i.max()) for i in written):.3f}", flush=True)
    del written
    res = train("exr", exr_root)
    trainer = res["trainer"]
    idle, wall = block_idle_share(trainer)
    summary["exr"]["idle_share"], summary["exr"]["block_ms"] = idle, wall
    val = eval_entry(HDR_ARGV["exr"] + ["--root_dir", str(exr_root),
                                        "--ckpt_path", res["ckpt"]],
                     "hdr[exr]")
    state["hdr_eval_launches"] = val["launches"]
    summary["exr"].update(eval_psnr=float(np.mean(val["psnr"])),
                          eval_ms_per_view=float(np.mean(
                              val["ms_per_view"][1:])))
    print(f"hdr[exr]: one post-training block traced on the device: wall "
          f"{wall:.1f} ms, idle share {idle}", flush=True)
    summary["card_vs_cpu_loss_rel"] = capture_card_vs_cpu(
        trainer, dev, "hdr", sample_tol=0, grad_tol=1e-4)
    exr_ckpt = res["ckpt"]
    state["hdr_ckpts"] = {"exr": exr_ckpt}
    del res, trainer

    root, _ = captures.write_hdr_nerf_capture(str(HDR_DIR), wh=(200, 200),
                                              focal=175.0, device=dev)
    res = train("exposure", root)
    state["hdr_ckpts"]["exposure"] = res["ckpt"]
    tr = res["trainer"]
    with torch.no_grad():
        unit = ngp_log_radiance_to_rgb(
            tr.model_params, torch.zeros((1, 3), device=dev),
            exposure=torch.ones((1, 1), device=dev))
        anchor = float(torch.mean(0.5 * (unit - tr.tc.unit_exposure_rgb)
                                  ** 2))
    summary["exposure"].update(anchor_loss=anchor,
                               unit_rgb=unit[0].tolist(),
                               exposures=sorted(set(
                                   tr.images[:, 0, 3].tolist())))
    print(f"hdr[exposure]: unit-exposure anchor loss {anchor:.3g} (unit "
          f"rgb {unit[0].tolist()}, target {tr.tc.unit_exposure_rgb})",
          flush=True)
    if not np.isfinite(anchor):
        failures.append(f"exposure: anchor loss {anchor}")
    del res, tr

    myb = HDR_DIR / "myblender"
    captures.write_myblender_capture(str(myb), n_views=32, wh=(400, 300),
                                     focal=350.0, device=dev)
    res = train("pose", myb)
    state["hdr_ckpts"]["pose"] = res["ckpt"]
    deltas = res["trainer"].params["pose_deltas"]
    moved = {k: float(v.detach().abs().max()) for k, v in deltas.items()}
    summary["pose"]["moved"] = moved
    print(f"hdr[pose]: pose deltas moved by at most {moved}", flush=True)
    if not all(0 < m < 1e-3 for m in moved.values()):
        failures.append(f"pose: deltas moved {moved}, not in (0, 1e-3)")
    del res, deltas

    if counts["head"] == 0 or counts["pack"] + counts["exact"] == 0:
        failures.append(f"a kernel never ran in HDR training: {counts}")
    state["hdr_train_launches"] = counts

    ins = run_insert(exr_ckpt, dev, downsample=0.25,
                     frames=HDR_INSERT_FRAMES,
                     center=(0.05, 0.0, 0.05),
                     scene=("--dataset_name", "colmap_exr", "--root_dir",
                            str(exr_root), "--use_EXR"),
                     work=HDR_DIR / "insert")
    state["hdr_insert_launches"] = ins["head_launches"]
    saved = HDR_DIR / "insert" / ins["insertor"].gen_path / "results" \
        / "0_smoke.exr"
    back = read_exr(str(saved)) if saved.exists() else None
    summary["insert"] = {
        "hw": ins["hw"], "prep_s": ins["prep_s"],
        "action6_ms": ins["action_ms"][6], "round_trip_ms": ins["frame_ms"],
        "launches_per_frame": ins["frame_launches"],
        "saved_exr_max": None if back is None else float(back.max())}
    print(f"hdr[insert]: {summary['insert']}; fused-head launches "
          f"{ins['head_launches']}, segment_sum {ins['segment_sum_launches']}"
          f"; saved {ins['saved']}", flush=True)
    if ins["head_launches"] == 0 or min(ins["frame_launches"]) == 0:
        failures.append("the fused head did not run in HDR insertion")
    if back is None or back.shape != tuple(ins["hw"]) + (3,) \
            or not np.isfinite(back).all() or float(back.max()) <= 1.0:
        failures.append(f"the saved HDR frame is missing, not finite or "
                        f"not above 1: {None if back is None else back.shape}")
    for f in ins["frames"]:
        if not np.isfinite(f).all():
            failures.append("a non-finite HDR frame")
            break
    del ins
    state["hdr_summary"] = summary
    print(f"hdr summary: {summary}", flush=True)
    if failures:
        raise AssertionError("; ".join(failures))

def gui_entry(ckpt, baked):
    """`python -m arnerf_tpu_torch.show_gui` headless (no DISPLAY) on
    `ckpt` at 800x800, network or ARNERF_GUI_BAKED=1, as a subprocess:
    its exit code, FPS line, bake line and fused-head launches."""
    env = {k: v for k, v in os.environ.items() if k != "DISPLAY"}
    env["ARNERF_GUI_BAKED"] = "1" if baked else "0"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "arnerf_tpu_torch.show_gui", *GUI_ARGV,
         "--ckpt_path", ckpt], cwd=VIEWER_DIR, env=env, capture_output=True,
        text=True, timeout=300)
    seconds = time.perf_counter() - t0
    label = "baked" if baked else "network"
    for line in proc.stdout.splitlines():
        print(f"  show_gui[{label}]: {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"show_gui[{label}] exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    fps = re.search(r"headless orbit: ([\d.]+) FPS at (\d+)x(\d+), "
                    r"([\d.]+) samples/ray", proc.stdout)
    launches = re.search(r"fused-head launches: (\d+) in (\d+) frames, "
                         r"(\d+) before them", proc.stdout)
    bake = re.search(r"baked field in ([\d.]+)s", proc.stdout)
    if fps is None or launches is None or (baked and bake is None):
        raise AssertionError(f"show_gui[{label}]: missing output lines")
    frames = int(launches.group(2))
    return {"fps": float(fps.group(1)),
            "wh": (int(fps.group(2)), int(fps.group(3))),
            "samples_per_ray": float(fps.group(4)),
            "frame_launches": int(launches.group(1)), "frames": frames,
            "frame_launches_per_frame": int(launches.group(1)) / frames,
            "launches_before_frames": int(launches.group(3)),
            "bake_s": float(bake.group(1)) if bake else None,
            "process_s": seconds}


def _gui(ckpt, dev, width=None, extra=(), baked=False):
    """An NGPGUI on `ckpt` on `dev` with GUI_ARGV's synthetic view, or that
    view cut to `width` pixels wide (K scaled as --low_resolution does)."""
    import numpy as np
    from arnerf_tpu_torch.datasets.synthetic import SyntheticDataset
    from arnerf_tpu_torch.opt import get_opts
    from arnerf_tpu_torch.show_gui import NGPGUI
    hp = get_opts(GUI_ARGV + ["--ckpt_path", ckpt, "--device", str(dev),
                              *extra])
    ds = SyntheticDataset(downsample=hp.downsample, read_meta=False)
    low = ds.img_wh[0] / width if width else 1.0
    K = np.asarray(ds.K, np.float32).copy()
    K[:2] /= low
    wh = (int(ds.img_wh[0] / low), int(ds.img_wh[1] / low))
    return NGPGUI(hp, K, wh, baked=baked)


def _frames(gui, n):
    """n orbiting frames: their ms (wall, to the image on the host)."""
    import numpy as np
    ms = []
    for _ in range(n):
        gui.cam.orbit(30, 0)
        img = gui.render_cam(gui.cam)
        if not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
            raise AssertionError("a viewer frame is not finite in [0, 1]")
        ms.append(1e3 * gui.dt)
    return ms


def live_preview(state, dev):
    """A baked viewer on the train phase's mid-run checkpoint; the final
    checkpoint then takes its place, as the concurrent training run would
    write it, and refresh_bake re-bakes a bounded delta."""
    import numpy as np
    from arnerf_tpu_torch.ops import fused_head as fh
    live = VIEWER_DIR / "live.npz"
    shutil.copyfile(state["train_mid_ckpt"], live)
    fh.reset_launches()
    gui = _gui(str(live), dev, baked=True)
    bake_launches = fh.launches
    before_ms = _frames(gui, 4)
    prev = gui.baked
    t_old = os.path.getmtime(live)
    shutil.copyfile(state["train_ckpt"], live)
    t_new = max(time.time(), t_old + 1.0)
    os.utime(live, (t_new, t_new))
    fh.reset_launches()
    advanced = gui.refresh_bake()
    delta_launches = fh.launches
    stats = dict(gui.delta_stats or {})
    after_ms = _frames(gui, 4)
    # the most a budgeted delta may re-bake: each moved cell's voxels
    # dilated by one voxel, the refresh stripe's voxels, and the voxels
    # entering the occupancy
    cfg, B = gui.cfg, gui.baked.resolution
    G = cfg.grid_size
    f = B // G
    occ = int(gui.grid_state.occ_flat.sum())
    budget = max(1024, occ // 16)
    stripe = -(-G ** 3 // 16)
    entering = int((gui.baked.src_mask & ~prev.src_mask).sum())
    bound = budget * (f + 2) ** 3 + stripe * f ** 3 + entering
    res = {"bake_s": gui.bake_seconds, "bake_launches": bake_launches,
           "delta_s": stats.get("seconds"), "delta_launches": delta_launches,
           "stats": stats, "bound": bound, "budget_cells": budget,
           "frame_ms_before": before_ms, "frame_ms_after": after_ms,
           "advanced": advanced, "again": gui.refresh_bake()}
    print(f"viewer: live preview {res}", flush=True)
    if not advanced or res["again"]:
        raise AssertionError("refresh_bake did not advance once and only "
                             "once on the new checkpoint")
    if not 0 < stats["n_changed"] <= bound or not stats["frac"] < 1:
        raise AssertionError(f"the delta is not bounded: {stats}, bound "
                             f"{bound} voxels")
    if not np.isfinite(gui.baked.rows[:, 0].sum().item()):
        raise AssertionError("the delta bake is not finite")
    state["viewer_gui"] = gui
    return res


def viewer_card_vs_cpu(state, dev):
    """Card against CPU: a 64x64 network frame of the final checkpoint;
    the live viewer's bake copied to the CPU through baked_frame_display_fn
    at 64x64 from one key; and a 64^3 exact-corner delta bake from the
    mid-run to the final checkpoint under the viewer's budget, then
    DELTA_CHECK_K deltas on the card (the refresh stripes cover every
    cell) against a fresh full bake."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.datasets.ray_utils import (get_ray_directions,
                                                     get_rays)
    from arnerf_tpu_torch.models import grid_state_init
    from arnerf_tpu_torch.ops import threefry
    from arnerf_tpu_torch.rendering_baked import (BakedField,
                                                  baked_frame_display_fn,
                                                  bake_ngp, bake_ngp_delta)
    from arnerf_tpu_torch.training.ckpt import load_ckpt
    cpu = torch.device("cpu")
    out = {}
    # network frame, f32: as reference_check
    imgs, samples = {}, {}
    sides = (("card", dev), ("cpu", cpu))
    for side, d in sides:
        g = _gui(state["train_ckpt"], d, width=64)
        g.cam.orbit(200, -60)
        imgs[side] = g.render_cam(g.cam)
        samples[side] = g.mean_samples
    err = float(np.abs(imgs["card"] - imgs["cpu"]).max())
    out["network"] = {"max_abs_err": err, "samples_per_ray": samples,
                      "mean": float(imgs["cpu"].mean())}
    if err > 1e-3 or samples["card"] != samples["cpu"] \
            or samples["cpu"] == 0:
        raise AssertionError(f"viewer network frame card vs CPU: {out}")
    # display frame of the live bake, 64x64, one key, both devices
    gui = state["viewer_gui"]
    card = gui.baked
    host = BakedField(**{k: v.to(cpu) if torch.is_tensor(v) else v
                         for k, v in vars(card).items()})
    cam = gui.cam
    K = np.asarray(cam.K, np.float32).copy()
    K[:2] *= 64 / cam.W
    pose = torch.as_tensor(np.asarray(cam.pose[:3], np.float32))
    u8, stats = {}, {}
    for (side, d), bk in zip(sides, (card, host)):
        dirs = torch.as_tensor(get_ray_directions(64, 64, K), device=d)
        ro, rd = get_rays(dirs, pose.to(d))
        stats[side] = {}
        u8[side] = baked_frame_display_fn(
            bk, ro, rd, T_threshold=1e-2, color_window=4, img_wh=(64, 64),
            white_bg=0.0)(threefry.prng_key(3), stats=stats[side]) \
            .cpu().int()
    px = (u8["card"] - u8["cpu"]).abs().amax(dim=1)
    flips = int((px > 1).sum())
    out["display"] = {"flipped": flips, "max_level_diff": int(px.max()),
                      "rounds": (stats["card"]["rounds"],
                                 stats["cpu"]["rounds"]),
                      "lit_pixels": int((u8["cpu"].amax(dim=1) > 0).sum())}
    if flips > RENDER_FLIP_PIXELS or stats["card"]["rounds"] \
            != stats["cpu"]["rounds"] or out["display"]["lit_pixels"] == 0:
        raise AssertionError(f"viewer display frame card vs CPU: {out}")
    # the delta bake, exact corners, 64^3, the viewer's model (f32)
    cfg = gui.cfg
    bakes = {}
    for side, d in sides:
        p0, s0, _ = load_ckpt(state["train_mid_ckpt"],
                              grid_template=grid_state_init(cfg, d), device=d)
        p1, s1, _ = load_ckpt(state["train_ckpt"],
                              grid_template=grid_state_init(cfg, d), device=d)
        prev = bake_ngp(p0, s0, cfg, resolution=BAKE_CHECK_RES, stoch=False)
        st = {}
        budget = max(1024, int(s1.occ_flat.sum()) // 16)   # the viewer's
        t0 = time.perf_counter()
        delta = bake_ngp_delta(p1, s1, cfg, prev, refresh_k=DELTA_CHECK_K,
                               stoch=False, stats=st, budget_cells=budget)
        torch.cuda.synchronize()
        bakes[side] = (delta, st, time.perf_counter() - t0, p1, s1)
    (g, g_st, g_s, p1, s1), (c, c_st, c_s, _, _) = bakes["card"], bakes["cpu"]
    rows_err = float((g.rows.cpu() - c.rows).abs().max() / c.rows.abs().max())
    same_snap = all(np.array_equal(getattr(g, k), getattr(c, k))
                    for k in ("src_density", "src_occ", "src_mask")) \
        and g.bake_phase == c.bake_phase
    cur = g
    for _ in range(DELTA_CHECK_K - 1):
        cur = bake_ngp_delta(p1, s1, cfg, cur, refresh_k=DELTA_CHECK_K,
                             stoch=False, budget_cells=budget)
    full = bake_ngp(p1, s1, cfg, resolution=BAKE_CHECK_RES, stoch=False)
    conv_err = float((cur.rows - full.rows).abs().max()
                     / full.rows.abs().max())
    out["delta"] = {"stats": g_st, "stats_equal": g_st == c_st,
                    "snapshots_equal": same_snap, "rows_err": rows_err,
                    "seconds": {"card": g_s, "cpu": c_s},
                    "converged_err": conv_err}
    print(f"viewer: card vs CPU {out}", flush=True)
    if g_st != c_st or not same_snap or rows_err > 1e-4 \
            or conv_err > 1e-4 or not 0 < g_st["n_changed"]:
        raise AssertionError(f"viewer delta bake card vs CPU: {out}")
    return out


def viewer_hdr_frames(state, dev):
    """One render_cam on each HDR checkpoint of the hdr phase (the
    --use_exposure model at exposures 1 and 8) at 200x200."""
    import numpy as np
    flags = {"exr": ["--dataset_name", "colmap_exr", "--use_EXR"],
             "exposure": ["--dataset_name", "colmap", "--use_exposure"],
             "pose": ["--dataset_name", "myblender", "--use_EXR"]}
    out = {}
    for name, ckpt in state["hdr_ckpts"].items():
        for exposure in ((1.0, 8.0) if name == "exposure" else (1.0,)):
            gui = _gui(ckpt, dev, width=200, extra=flags[name])
            gui.exposure = exposure
            img = gui.render_cam(gui.cam)
            out[f"{name}@{exposure:g}"] = {
                "mean": float(img.mean()), "max": float(img.max()),
                "ms": 1e3 * gui.dt}
            if not np.isfinite(img).all() or img.min() < 0 or img.max() > 1:
                raise AssertionError(f"HDR frame {name}: not in [0, 1]")
    print(f"viewer: HDR frames {out}", flush=True)
    return out


def viewer_phase(state, dev):
    """The viewer on the train phase's checkpoint at 800x800: the entry
    point headless on the network and the baked frame; the live preview's
    delta bake; card against CPU; the HDR checkpoints' frames."""
    shutil.rmtree(VIEWER_DIR, ignore_errors=True)
    VIEWER_DIR.mkdir(parents=True)
    ckpt = state["train_ckpt"]
    net = gui_entry(ckpt, baked=False)
    baked = gui_entry(ckpt, baked=True)
    live = live_preview(state, dev)
    launches = {"gui_network": net["frame_launches"],
                "gui_bake": baked["launches_before_frames"]
                + live["bake_launches"],
                "gui_delta": live["delta_launches"]}
    state["viewer_launches"] = launches
    summary = {"network": net, "baked": baked, "live": live,
               "launches": launches}
    state["viewer_summary"] = summary
    print(f"viewer summary: {summary}", flush=True)
    if min(launches.values()) == 0 or baked["frame_launches"] != 0:
        raise AssertionError(f"fused-head launches per path: {launches}, "
                             f"baked frames {baked['frame_launches']}")
    if net["wh"] != (800, 800) or baked["wh"] != (800, 800):
        raise AssertionError("the viewer did not render 800x800 frames")
    summary["card_vs_cpu"] = viewer_card_vs_cpu(state, dev)
    if "hdr_ckpts" in state:
        summary["hdr"] = viewer_hdr_frames(state, dev)
    else:
        raise AssertionError("no HDR checkpoints: the hdr phase failed")


def profile_gui_frames(state, dev):
    """One 800x800 viewer frame of each kind traced on the device: the
    network frame and the baked display frame; wall (to the image on the
    host), device busy and idle share."""
    from torch.profiler import ProfilerActivity, profile
    guis = {"network": _gui(state["train_ckpt"], dev),
            "baked": state["viewer_gui"]}
    for name, gui in guis.items():
        gui.render_cam(gui.cam)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gui.render_cam(gui.cam)
        kernels, busy_ms = _busy(prof, ("cull", "prelude", "march", "color",
                                        "first_hit", "field", "composite"))
        wall_ms = 1e3 * gui.dt
        share = f"{1 - busy_ms / wall_ms:.3f}" if kernels else "not measured"
        print(f"profile[gui {name}]: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms, idle share {share}, {len(kernels)} device "
              f"kernels/copies", flush=True)


PARALLEL_DIR = SMOKE_DIR / "parallel"
PARALLEL_STEPS = 256            # 16 blocks, all in the grid warmup
PARALLEL_ARGV = ["--dataset_name", "synthetic", "--downsample", "3.125",
                 "--num_epochs", "1", "--steps_per_epoch",
                 str(PARALLEL_STEPS), "--batch_size", "8192",
                 "--exp_name", "dp"]
# DP (and the 1 x 1 sharded table) against one process after the first
# block, per leaf: |a - b| / |b - b0| (Frobenius; b0 the initial leaf).
# A world of one joins exactly, but the segment sum's atomics (and the
# composite's scatters) reorder float sums between any two runs, and Adam's
# eps = 1e-15 turns a reordered near-zero gradient into a +-lr step: two
# trainers without a mesh and with the same seeds differ by 3-4 % of the
# table's move on an H100. So each leaf may depart by twice that floor,
# measured in the same run, plus PARALLEL_TOL.
PARALLEL_TOL = 1e-2


def _parallel_run(args, work, timeout):
    """`python chip_smoke.py --parallel-worker args...` as rank 0 of a
    world of 1 (torchrun's environment set by hand, a free port), in
    `work`; returns the JSON it wrote."""
    from arnerf_tpu_torch.parallel.launch import rank_env
    work.mkdir(parents=True, exist_ok=True)
    out = work / "result.json"
    out.unlink(missing_ok=True)
    env = rank_env(0, 1, _free_port(),
                   dict(os.environ, PYTHONPATH=str(ROOT)))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-worker",
         args[0], str(out), *args[1:]], cwd=work, env=env,
        capture_output=True, text=True, timeout=timeout)
    (work / "stdout.log").write_text(proc.stdout)
    (work / "stderr.log").write_text(proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"parallel worker {args[0]} exited with "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(out.read_text())


def _median_ms_per_step(seconds):
    """Median ms/step over 16-step blocks' host seconds."""
    import numpy as np
    return float(np.median([1e3 * t / 16 for t in seconds]))


def _parallel_entry(out, argv):
    """One rank of the train entry point under torchrun's environment (here
    a world of 1: the data parallel path over NCCL; several ranks under
    --multi-gpu): the launch counters from 0 just before,
    read after training and after its validation; rank 0 writes `out`."""
    import numpy as np
    import torch
    from arnerf_tpu_torch import train as port_train
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.parallel.accounting import block_collective_report
    from arnerf_tpu_torch.training.ckpt import tree_leaves
    counts, losses = {}, []

    def on_block(step, metrics, trainer):
        counts.update(head=fh.launches, **seg.launches)
        losses.append(float(metrics["loss"]))

    fh.reset_launches()
    seg.reset_launches()
    t0 = time.perf_counter()
    res = port_train.main(argv, callback=on_block)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    trainer = res["trainer"]
    if trainer.rank != 0:
        return
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(trainer.params) + trainer.opt.mu)
    out.write_text(json.dumps({
        "counts": counts, "val_launches": fh.launches - counts["head"],
        "losses": losses, "psnr": res["psnr"], "finite": finite,
        "seconds": time.perf_counter() - t0,
        # the first block's first-use costs left out
        "ms_per_step": _median_ms_per_step(
            [t for _, t, _ in trainer.block_times[1:]]),
        "mesh": [trainer.mesh.n_dp, trainer.mesh.n_mp],
        "collectives": block_collective_report(trainer)}))


def _parallel_sharded(out):
    """The entry point's configuration in trainers of one process: none on
    a mesh, data parallel on a 1-rank mesh, and the row-sharded table
    forced on a 1 x 1 mesh (the entry point routes n_mp = 1 to data
    parallel, as JAX does). After the first block the two on a mesh are
    held against the first, beside a second trainer without a mesh (the
    run-to-run floor); then the three take their other blocks in turns,
    one block each, so that their times share the card's state."""
    import torch
    from arnerf_tpu_torch.datasets import dataset_dict, loader_kwargs
    from arnerf_tpu_torch.opt import get_opts, model_config
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.parallel import (init_distributed, make_mesh,
                                           make_mesh_2d)
    from arnerf_tpu_torch.parallel.accounting import block_collective_report
    from arnerf_tpu_torch.training.ckpt import tree_leaves
    from arnerf_tpu_torch.training.trainer import NeRFTrainer, TrainConfig
    dev = init_distributed(torch.device("cuda"))
    hp = get_opts(PARALLEL_ARGV)
    ds = dataset_dict["synthetic"](split="train",
                                   **loader_kwargs(hp, dev))
    cfg = model_config(hp, dev, stoch_corners=True)
    tc = TrainConfig(batch_size=hp.batch_size, num_epochs=1,
                     steps_per_epoch=PARALLEL_STEPS)
    trainers = {
        "one": NeRFTrainer(cfg, tc, ds, device=dev),
        "dp": NeRFTrainer(cfg, tc, ds, device=dev, mesh=make_mesh(1)),
        "tp": NeRFTrainer(cfg, tc, ds, device=dev,
                          mesh=make_mesh_2d(1, 1), shard_table=True)}
    again = NeRFTrainer(cfg, tc, ds, device=dev)
    init = [p.detach().clone() for p in tree_leaves(again.params)]
    res = {"losses": {}, "ms_per_step": {}, "counts": {},
           "first_block": {}, "collectives": {}, "finite": {}}
    seconds = {name: [] for name in trainers}

    def block(name, tr, timed):
        fh.reset_launches()
        seg.reset_launches()
        tb = time.perf_counter()
        res["losses"].setdefault(name, []).append(
            float(tr.train_block()["loss"]))
        if timed:
            seconds[name].append(time.perf_counter() - tb)
        c = res["counts"].setdefault(name, {"head": 0, "pack": 0,
                                            "exact": 0})
        for k, v in {"head": fh.launches, **seg.launches}.items():
            c[k] += v

    for name, tr in trainers.items():
        tr.on_train_start()
        block(name, tr, timed=False)
    again.on_train_start()
    again.train_block()
    ref = tree_leaves(trainers["one"].params)
    for name, tr in (("floor", again), ("dp", trainers["dp"]),
                     ("tp", trainers["tp"])):
        rel = []
        for a, b, b0 in zip(tree_leaves(tr.params), ref, init):
            moved = float(torch.linalg.vector_norm(b - b0))
            rel.append(float(torch.linalg.vector_norm(a - b))
                       / max(moved, 1e-30))
        res["first_block"][name] = rel
    del again
    while trainers["one"].step < PARALLEL_STEPS:
        for name, tr in trainers.items():
            block(name, tr, timed=True)
    torch.cuda.synchronize()
    for name, tr in trainers.items():
        res["ms_per_step"][name] = _median_ms_per_step(seconds[name])
        res["finite"][name] = all(bool(torch.isfinite(p).all())
                                  for p in tree_leaves(tr.params))
        if tr.mesh is not None:
            res["collectives"][name] = block_collective_report(tr)
    out.write_text(json.dumps(res))


def parallel_worker(argv) -> int:
    """chip_smoke.py --parallel-worker {entry,sharded} <out.json> [argv]:
    one rank, run by parallel_phase."""
    import torch.distributed as dist
    kind, out = argv[0], Path(argv[1])
    if kind == "entry":
        _parallel_entry(out, argv[2:])     # the entry point ends its group
    else:
        _parallel_sharded(out)
        dist.destroy_process_group()
    return 0


MULTI_GPU_LAYOUTS = ((1, 1), (4, 1), (4, 2))    # (ranks, model_parallel)


def multi_gpu_main() -> int:
    """chip_smoke.py --multi-gpu: the train entry point on the cards of one
    host (four), as 1 rank, as 4 data parallel ranks and as 2 x 2 ranks
    with the table sharded, each rank a process on its own card over NCCL
    (parallel/launch.py sets torchrun's variables), at the parallel phase's
    configuration (PARALLEL_ARGV, 256 steps, batch 8192 a rank). Prints one
    JSON line a layout from rank 0 (ms/step over blocks 2-16, collective
    bytes per block, launches, block losses, test PSNR), then the cards'
    name and power limit. A measurement, run apart from the smoke."""
    import tempfile
    from arnerf_tpu_torch.parallel.launch import launch
    for n, mp in MULTI_GPU_LAYOUTS:
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "result.json"
            os.chdir(tmp)           # the ranks write their outputs here
            try:
                launch([str(ROOT / "chip_smoke.py"), "--parallel-worker",
                        "entry", str(out), *PARALLEL_ARGV, "--num_gpus",
                        str(n), "--model_parallel", str(mp),
                        "--no_save_test"], n, timeout=900)
            finally:
                os.chdir(ROOT)
            res = json.loads(out.read_text())
        print(json.dumps({"ranks": n, "model_parallel": mp, **res}),
              flush=True)
    print(card_line(), flush=True)
    return 0


def step_census_main(n_sets: int) -> int:
    """chip_smoke.py --step-census [N]: the captures phase's COLMAP model
    trained as there, then its card-vs-CPU step (capture_card_vs_cpu) on
    N ray sets instead of one; each line gives the errors, the CPU's own
    floor and the tolerance. Exits non-zero if any set disagrees. A
    measurement, run apart from the smoke."""
    import torch
    from arnerf_tpu_torch import build
    from arnerf_tpu_torch.datasets.captures import write_colmap_capture
    dev = torch.device("cuda")
    build.build(build.KERNEL_SOURCES + build.HOST_SOURCES)
    root = CAPTURES_DIR / "colmap"
    shutil.rmtree(root, ignore_errors=True)
    write_colmap_capture(str(root), n_views=COLMAP_VIEWS, wh=COLMAP_WH,
                         device=dev)
    res = train_entry(CAPTURE_ARGV["colmap"] + ["--root_dir", str(root),
                                                "--exp_name", "census"],
                      SMOKE_DIR / "census", "census")
    failed = []
    for seed in range(1, n_sets + 1):
        try:
            capture_card_vs_cpu(res["trainer"], dev, f"census[{seed}]",
                                seed=seed)
        except AssertionError as e:
            failed.append(str(e))
    print(f"census: {n_sets - len(failed)} of {n_sets} ray sets agree; "
          f"{failed}", flush=True)
    print(card_line(), flush=True)
    return 1 if failed else 0


TOOLS_DIR = SMOKE_DIR / "tools"
BRDF_STEPS = 300                # train_brdf on the card
ENVFIT_MAPS = 512               # generate_envmaps' default
ENVFIT_EPOCHS = (100, 200)      # two train() calls: the second resumes
RESUME_DIR = SMOKE_DIR / "resume"
RESUME_STEPS, RESUME_KILL_AT = 600, 400   # 400: the 25-block snapshot
RESUME_ARGV = TRAIN_ARGV[:-2] + ["--steps_per_epoch", str(RESUME_STEPS),
                                 "--exp_name", "resume", "--no_save_test"]
# one fitter step from the same weights and batch on the CPU and the card,
# each held against the same step in float64 on the CPU given its own pool
# and ReLU decisions (envfit_precision): full f32 sums keep the loss within
# ~2e-7 and every gradient leaf within ~2e-6 (relative, Frobenius) on the
# H100 and the CPU alike, while TF32 convolutions are 1e-3 to 3e-2 off
# (`chip_smoke.py --envfit-precision`); the tolerances sit between the two
ENVFIT_LOSS_TOL, ENVFIT_GRAD_TOL = 1e-5, 1e-5


def tools_phase(state, dev):
    """pretabulate_fh writes the F table (the insert phase's first SSDF
    load must then read it, not compute it: counted here, checked in the
    envfit phase); then train_brdf for BRDF_STEPS steps on the card."""
    import numpy as np
    from arnerf_tpu_torch.insert import pretabulate_fh, sg_shadow, train_brdf
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    fh.reset_launches()
    seg.reset_launches()
    res = pretabulate_fh.main([])
    tab = sg_shadow.get_fh_table()
    if tab.shape != (2048, 1024) or not np.isfinite(tab).all():
        raise AssertionError(f"bad F table {tab.shape}")
    orig = sg_shadow.compute_fh_table
    state["fh_computes"] = 0

    def counted(*a, **k):
        state["fh_computes"] += 1
        return orig(*a, **k)

    sg_shadow.compute_fh_table = counted
    print(f"tools: pretabulate_fh {res['seconds']:.2f} s -> "
          f"{res['path']}", flush=True)
    out = TOOLS_DIR / "model_brdf3.npz"
    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    brdf = train_brdf.main(["--steps", str(BRDF_STEPS), "--out", str(out)])
    losses = brdf["losses"]
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    state["tools_launches"] = {"head": fh.launches, **seg.launches}
    state["tools_summary"] = {"fh_seconds": res["seconds"],
                              "brdf_ms_per_step":
                                  1e3 * brdf["seconds"] / BRDF_STEPS,
                              "brdf_loss": (first, last)}
    print(f"tools: train_brdf {BRDF_STEPS} steps in {brdf['seconds']:.2f} "
          f"s ({1e3 * brdf['seconds'] / BRDF_STEPS:.2f} ms/step, batch 512 "
          f"x 4096 directions); loss (mean of 10 steps) {first:.5f} -> "
          f"{last:.5f}; launches {state['tools_launches']}", flush=True)
    if not np.isfinite(losses).all() or last >= first:
        raise AssertionError(f"train_brdf's loss did not fall: {first} -> "
                             f"{last}")


def _fitter_loss(tr, batch):
    import torch
    from arnerf_tpu_torch.insert.envfit import _full_f32, sg2envmap
    with torch.no_grad(), _full_f32():
        return float(torch.mean((sg2envmap(tr.params(batch), 128, 128)
                                 - batch) ** 2))


def _fitter_forward(net, im, route=None):
    """SGFittingNet.forward with its discrete decisions exposed: returns
    (raw SGs, route), the route each layer's 2x2 max-pool argmax (flat
    indices) and ReLU mask. Given a `route`, the pools and ReLUs follow it
    instead of their own inputs, so that two precisions of one step differ
    only by their arithmetic, not by a near tie that rounding breaks the
    other way (one flipped pool window moves conv1-3's gradients ~1e-3)."""
    import torch
    from arnerf_tpu_torch.insert.envfit import CONVS
    x = im.permute(0, 3, 1, 2)
    taken = []
    for i, (name, _, _) in enumerate(CONVS):
        z = getattr(net, name)(x)
        if route is None:
            p, idx = torch.nn.functional.max_pool2d(z, 2, return_indices=True)
            mask = p > 0
        else:
            idx, mask = (t.to(z.device) for t in route[i])
            p = z.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
        taken.append((idx, mask))
        x = torch.where(mask, p, torch.zeros_like(p))
    out = net.lin(x.reshape(x.shape[0], -1))
    return out.reshape(im.shape[0], net.n_sg, 7), taken


def _fitter_grads(net, batch, route=None):
    """The fitter's loss, gradients (leaf name -> float64 numpy) and route
    on `batch`, in the dtype of `net` and `batch`, under the precision
    flags the caller has set."""
    import torch
    from arnerf_tpu_torch.insert.envfit import sg2envmap
    sgs, taken = _fitter_forward(net, batch, route)
    loss = torch.mean((sg2envmap(sgs, 128, 128) - batch) ** 2)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    names = [n.replace(".weight", ".w").replace(".bias", ".b")
             for n, _ in net.named_parameters()]
    return float(loss.detach()), {n: g.cpu().double().numpy()
                                  for n, g in zip(names, grads)}, taken


def envfit_inputs(maps=None):
    """The batches of 16 128x128 maps the fitter's card-vs-CPU check runs
    on: uniform noise, renders of random SGs, those renders rounded to 8
    bits (flat regions: exact ties in the 2x2 pools) and, when given, the
    first 16 of `maps`."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert.envfit import sg2envmap
    rng = np.random.default_rng(7)
    sgs = rng.standard_normal((16, 32, 7)).astype(np.float32)
    sgs[..., 3] *= 20.0
    sgs[..., 4:] = np.abs(sgs[..., 4:]) * 0.3
    with torch.no_grad():
        render = sg2envmap(torch.from_numpy(sgs), 128, 128).numpy()
    out = {"noise": rng.random((16, 128, 128, 3), np.float32),
           "sg": render,
           "sg_8bit": np.round(np.clip(render, 0, 1) * 255) / 255}
    if maps is not None:
        out["generated"] = maps[:16]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


class _backend_flags:
    """Set torch.backends.cudnn / torch.backends.cuda.matmul attributes
    for a with-block (`cudnn_x=`, `matmul_x=`)."""

    def __init__(self, **flags):
        import torch
        self.flags = [((torch.backends.cudnn if k.startswith("cudnn_") else
                        torch.backends.cuda.matmul), k.split("_", 1)[1], v)
                      for k, v in flags.items()]

    def __enter__(self):
        self.old = [getattr(m, k) for m, k, _ in self.flags]
        for m, k, v in self.flags:
            setattr(m, k, v)

    def __exit__(self, *exc):
        for (m, k, _), v in zip(self.flags, self.old):
            setattr(m, k, v)


# the card's variants of the step: as EnvTrainer runs it (envfit._full_f32
# inside), with cuDNN's deterministic algorithms, with cuDNN off (PyTorch's
# own convolutions), and with TF32 allowed (the control the gate must see)
ENVFIT_CARD_VARIANTS = {
    "card": {},
    "card_deterministic": {"cudnn_deterministic": True,
                           "cudnn_benchmark": False},
    "card_no_cudnn": {"cudnn_enabled": False},
    "card_tf32": {"cudnn_allow_tf32": True, "matmul_allow_tf32": True},
}


def envfit_precision(batch, dev, variants=None):
    """One fitter step's loss and gradients on `batch` (16 maps) from the
    default key's weights, for the CPU's float32 step ("cpu") and each of
    `variants` (names of ENVFIT_CARD_VARIANTS, default all), each held
    against the same step in float64 on the CPU that takes the variant's
    own pool and ReLU decisions. Per variant: the loss's relative error,
    each gradient leaf's relative Frobenius error, the largest such error
    against the float64 step on its own decisions, and the decisions that
    differ from that step's."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert.envfit import (_full_f32, sg_net_from_jax,
                                                sg_net_init)
    from arnerf_tpu_torch.ops import threefry
    flat = sg_net_init(threefry.prng_key(0))
    x = torch.from_numpy(batch)
    net64, x64 = sg_net_from_jax(flat).double(), x.double()
    _, own, own_route = _fitter_grads(net64, x64)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))

    def held(loss, grads, route):
        ref_loss, ref, _ = _fitter_grads(net64, x64, route)
        flips = sum(int((a.cpu() != b).sum()) for r, o in
                    zip(route, own_route) for a, b in zip(r, o))
        return {"loss": abs(loss - ref_loss) / abs(ref_loss),
                "grads": {k: rel(grads[k], ref[k]) for k in ref},
                "unrouted": max(rel(grads[k], own[k]) for k in own),
                "flips": flips}

    net = sg_net_from_jax(flat)
    sgs = net(x)
    if not torch.equal(_fitter_forward(net, x)[0], sgs):
        raise AssertionError("_fitter_forward departs from SGFittingNet")
    out = {"cpu": held(*_fitter_grads(net, x))}
    net, xd = sg_net_from_jax(flat, dev), x.to(dev)
    for name in variants or ENVFIT_CARD_VARIANTS:
        with _full_f32(), _backend_flags(**ENVFIT_CARD_VARIANTS[name]):
            out[name] = held(*_fitter_grads(net, xd))
    return out


def envfit_precision_main() -> int:
    """chip_smoke.py --envfit-precision: envfit_precision on each batch of
    envfit_inputs() (no generated maps: those need the insert phase),
    one JSON line per batch. A measurement, run apart from the smoke."""
    import torch
    dev = torch.device("cuda")
    for name, batch in envfit_inputs().items():
        t0 = time.perf_counter()
        res = envfit_precision(batch, dev)
        print("envfit_precision " + json.dumps(
            {"input": name, "seconds": time.perf_counter() - t0,
             **{v: {"max_grad": max(r["grads"].values()), **r}
                for v, r in res.items()}}), flush=True)
    print(card_line(), flush=True)
    return 0


def envfit_phase(state, dev):
    """The amortised SG fitter on the insert phase's network insertor:
    generate_envmaps (ENVFIT_MAPS probes through the network field: the
    fused head must launch for every probe, the segment sum never), then
    EnvTrainer at full width (32 SGs, 128x128, batch 16) for
    ENVFIT_EPOCHS[0] epochs with checkpoints and a second train() that
    resumes at its last checkpoint and goes on to ENVFIT_EPOCHS[1]; the
    loss must fall; one step on the CPU and the card against float64
    (envfit_precision), with TF32 as the control that must fail."""
    import numpy as np
    import torch
    from arnerf_tpu_torch.insert.envfit import EnvTrainer
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    print(f"envfit: F-table computations during insert: "
          f"{state.get('fh_computes')} (pretabulated by the tools phase)",
          flush=True)
    if state.get("fh_computes"):
        raise AssertionError("the insert phase computed the F table instead "
                             "of reading pretabulate_fh's")
    ins = state["insert_insertor"]
    cwd = os.getcwd()
    os.chdir(SMOKE_DIR / "insert")      # the insertor's relative gen_path
    try:
        path = Path(ins.gen_path) / "envmaps.npy"
        path.unlink(missing_ok=True)
        per_probe, probe_s = [], []
        orig = ins.generate_probe

        def probe(*a, **k):
            before = fh.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            probe_s.append(time.perf_counter() - t0)
            per_probe.append(fh.launches - before)
            return out

        ins.generate_probe = probe
        fh.reset_launches()
        seg.reset_launches()
        t0 = time.perf_counter()
        try:
            ins.generate_envmaps(ENVFIT_MAPS)
        finally:
            del ins.generate_probe
        gen_s = time.perf_counter() - t0
        state["envfit_launches"] = fh.launches
        seg_launches = dict(seg.launches)
        maps = np.load(path)
    finally:
        os.chdir(cwd)
    print(f"envfit: generate_envmaps {maps.shape} in {gen_s:.2f} s "
          f"({np.median(probe_s):.4f} s per probe, median); fused-head "
          f"launches {fh.launches} ({sorted(set(per_probe))} per probe); "
          f"segment_sum {seg_launches}", flush=True)
    if maps.shape != (ENVFIT_MAPS, 128, 128, 3) or \
            not np.isfinite(maps).all():
        raise AssertionError(f"bad env maps {maps.shape}")
    if len(per_probe) != ENVFIT_MAPS or min(per_probe) == 0:
        raise AssertionError(f"a probe did not launch the fused head: "
                             f"{len(per_probe)} probes, min {min(per_probe)}")
    if any(seg_launches.values()):
        raise AssertionError(f"the segment sum ran: {seg_launches}")

    ckpt_dir = SMOKE_DIR / "envfit"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    fh.reset_launches()
    t0 = time.perf_counter()
    tr = EnvTrainer(maps, device=dev)
    init_s = time.perf_counter() - t0
    probe_batch = tr.envmaps[:16]
    loss0 = _fitter_loss(tr, probe_batch)
    times, losses = [], []
    for epochs in ENVFIT_EPOCHS:
        steps0 = tr._adam[0].count if tr._adam else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tr.train(epochs, batch_size=16, ckpt_dir=str(ckpt_dir),
                               ckpt_every=50))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, tr._adam[0].count - steps0))
    loss1 = _fitter_loss(tr, probe_batch)
    ckpts = sorted(p.name for p in ckpt_dir.iterdir())
    im = tr.envmaps[0]
    eval_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.eval(im)
        torch.cuda.synchronize()
        eval_ms.append(1e3 * (time.perf_counter() - t0))
    steps = sum(n for _, n in times)
    ms_step = 1e3 * sum(t for t, _ in times) / steps
    prec = {name: envfit_precision(batch, dev, ["card", "card_tf32"])
            for name, batch in envfit_inputs(maps).items()}
    state["envfit_summary"] = {
        "s_per_probe": float(np.median(probe_s)), "ms_per_step": ms_step,
        "eval_ms": float(np.median(eval_ms[1:])), "init_s": init_s,
        "loss": (loss0, loss1), "steps": steps,
        "card_vs_f64": {k: max(r["card"]["grads"].values())
                        for k, r in prec.items()},
        "tf32_vs_f64": {k: max(r["card_tf32"]["grads"].values())
                        for k, r in prec.items()}}
    print(f"envfit: EnvTrainer (32 SGs, batch 16, {ENVFIT_MAPS} maps): "
          f"init {init_s:.2f} s; train() calls {times} (seconds, steps); "
          f"{ms_step:.3f} ms/step; eval {np.median(eval_ms[1:]):.3f} ms; "
          f"last-batch losses {losses}; loss on 16 maps {loss0:.5f} -> "
          f"{loss1:.5f}; checkpoints {ckpts}; fused-head launches "
          f"{fh.launches}", flush=True)
    for name, res in prec.items():
        print(f"envfit: one step on {name} maps against float64 on the CPU "
              f"(tolerances: loss {ENVFIT_LOSS_TOL}, each gradient leaf "
              f"{ENVFIT_GRAD_TOL} relative Frobenius, given the step's own "
              f"pool and ReLU decisions): " + json.dumps(res), flush=True)
    per_epoch = -(-ENVFIT_MAPS // 16)
    want = [n * per_epoch for n in (ENVFIT_EPOCHS[0],
                                    ENVFIT_EPOCHS[1] - ENVFIT_EPOCHS[0])]
    if [n for _, n in times] != want:
        raise AssertionError(f"the second train() did not resume at epoch "
                             f"{ENVFIT_EPOCHS[0]}: steps {times}, want "
                             f"{want}")
    if f"env_model_{ENVFIT_EPOCHS[1]:06d}.npz" not in ckpts:
        raise AssertionError(f"checkpoints {ckpts}")
    if not np.isfinite(losses).all() or loss1 >= loss0:
        raise AssertionError(f"the fitter's loss did not fall: {loss0} -> "
                             f"{loss1}")
    bad = [(name, v) for name, res in prec.items() for v in ("cpu", "card")
           if res[v]["loss"] > ENVFIT_LOSS_TOL
           or max(res[v]["grads"].values()) > ENVFIT_GRAD_TOL]
    if bad:
        raise AssertionError(f"fitter steps off the float64 step: {bad}")
    if not any(max(res["card_tf32"]["grads"].values()) > ENVFIT_GRAD_TOL
               for res in prec.values()):
        raise AssertionError("the gate passes a TF32 step: it cannot tell "
                             "the fitter's full f32 from TF32")


def resume_worker(argv) -> int:
    """chip_smoke.py --resume-worker WORK ARGV...: the train entry point in
    WORK (ARNERF_AUTO_RESUME from the environment), printing each block's
    metrics and the launch counters as JSON lines."""
    import torch
    from arnerf_tpu_torch import train as port_train
    from arnerf_tpu_torch.ops import fused_head as fh
    from arnerf_tpu_torch.ops import segments as seg
    from arnerf_tpu_torch.training.ckpt import tree_leaves
    os.chdir(argv[0])
    fh.reset_launches()
    seg.reset_launches()

    def on_block(step, metrics, trainer):
        print("BLOCK " + json.dumps({"step": step, "head": fh.launches,
                                     **seg.launches,
                                     **{k: float(v) for k, v in
                                        metrics.items()}}), flush=True)

    res = port_train.main(argv[1:], callback=on_block)
    torch.cuda.synchronize()
    trainer = res["trainer"]
    finite = all(bool(torch.isfinite(p).all())
                 for p in tree_leaves(trainer.params))
    print("DONE " + json.dumps({"step": trainer.step, "head": fh.launches,
                                **seg.launches, "finite": finite,
                                "psnr": res["psnr"]}), flush=True)
    return 0


def _resume_run(kill_at=None, timeout=600):
    """The resume worker as a subprocess; with kill_at, SIGKILLed once the
    snapshot on disk holds that step. Returns (output lines, seconds)."""
    import signal
    import numpy as np
    env = dict(os.environ, ARNERF_AUTO_RESUME="1")
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "--resume-worker",
           str(RESUME_DIR), *RESUME_ARGV]
    snap = RESUME_DIR / "ckpts" / "synthetic" / "resume" / "snapshot.npz"
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        if kill_at is not None:
            while proc.poll() is None and time.perf_counter() - t0 < timeout:
                if snap.exists():
                    try:
                        with np.load(snap) as f:
                            if int(f["step"]) >= kill_at:
                                break
                    except (OSError, ValueError, KeyError):
                        pass
                time.sleep(0.05)
            os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate(timeout=timeout)[0]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return out.splitlines(), time.perf_counter() - t0, proc.returncode


def resume_phase(state):
    """ARNERF_AUTO_RESUME=1: the train entry point at the train phase's
    configuration for RESUME_STEPS steps in a subprocess, SIGKILLed once
    its snapshot holds step RESUME_KILL_AT; rerun, it must resume there,
    finish, remove the snapshot, keep finite parameters and launch both
    kernels, its first block's loss within 2x the killed run's last logged
    loss."""
    import numpy as np
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    RESUME_DIR.mkdir(parents=True)
    lines, killed_s, code = _resume_run(kill_at=RESUME_KILL_AT)
    snap = RESUME_DIR / "ckpts" / "synthetic" / "resume" / "snapshot.npz"
    with np.load(snap) as f:
        snap_step = int(f["step"])
    blocks = [json.loads(x[6:]) for x in lines if x.startswith("BLOCK ")]
    log = RESUME_DIR / "logs" / "synthetic" / "resume" / "metrics.jsonl"
    logged = [json.loads(x) for x in log.read_text().splitlines()]
    print(f"resume: killed (code {code}) after {killed_s:.1f} s at block "
          f"step {blocks[-1]['step'] if blocks else None}; snapshot at step "
          f"{snap_step}; last logged {logged[-1]}", flush=True)
    if snap_step != RESUME_KILL_AT:
        raise AssertionError(f"snapshot at {snap_step}, want "
                             f"{RESUME_KILL_AT}")
    lines, resumed_s, code = _resume_run()
    text = "\n".join(lines)
    blocks2 = [json.loads(x[6:]) for x in lines if x.startswith("BLOCK ")]
    done = [json.loads(x[5:]) for x in lines if x.startswith("DONE ")]
    if code != 0 or not done:
        raise AssertionError(f"the resumed run failed ({code}): "
                             f"{text[-3000:]}")
    done = done[0]
    state["resume_launches"] = {k: blocks2[-1][k]
                                for k in ("head", "pack", "exact")}
    state["resume_val_launches"] = done["head"] - blocks2[-1]["head"]
    ms = 1e3 * resumed_s / max(1, RESUME_STEPS - RESUME_KILL_AT)
    state["resume_summary"] = {"killed_s": killed_s, "resumed_s": resumed_s,
                               "first_loss": blocks2[0]["loss"],
                               "last_logged_loss": logged[-1]["loss"]}
    print(f"resume: rerun in {resumed_s:.1f} s (process, incl. start, data "
          f"and validation; {ms:.1f} ms per resumed step); blocks "
          f"{[b['step'] for b in blocks2]}; first block loss "
          f"{blocks2[0]['loss']:.5f} vs the killed run's last logged "
          f"{logged[-1]['loss']:.5f}; done {done}; launches in training "
          f"{state['resume_launches']}", flush=True)
    if f"auto-resume: snapshot at step {RESUME_KILL_AT}" not in text:
        raise AssertionError(f"no resume line: {text[-2000:]}")
    if done["step"] != RESUME_STEPS or blocks2[0]["step"] != \
            RESUME_KILL_AT + 16:
        raise AssertionError(f"resumed run ran {blocks2[0]['step']} .. "
                             f"{done['step']}")
    if snap.exists():
        raise AssertionError("the snapshot was not removed")
    if not done["finite"]:
        raise AssertionError("non-finite parameters after the resume")
    if min(state["resume_launches"].values()) == 0:
        raise AssertionError(f"a kernel did not run in the resumed process: "
                             f"{state['resume_launches']}")
    if not blocks2[0]["loss"] < 2 * logged[-1]["loss"]:
        raise AssertionError("the resumed run's first block lost the "
                             "snapshot's progress")



def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}"


def parallel_phase(state, dev):
    """Multi-GPU training on the one card: every run is a subprocess with
    torchrun's environment for a world of 1 over NCCL (this process holds
    no process group). The train entry point at full width for
    PARALLEL_STEPS steps takes the data parallel path; a helper trains the
    same configuration without a mesh, data parallel, and with the table
    sharded on a 1 x 1 mesh (all-gather and reduce-scatter on the card).
    Both kernels must launch on both (the segment sum in both modes), the
    loss fall and the parameters stay finite; after the first block the
    data parallel and sharded parameters must match the unjoined ones to
    twice the run-to-run floor plus PARALLEL_TOL. `--num_gpus 2` on this
    one-GPU machine must fail, naming the one visible GPU."""
    import numpy as np
    t0 = time.perf_counter()
    entry = _parallel_run(["entry", *PARALLEL_ARGV], PARALLEL_DIR / "entry",
                          timeout=420)
    t_entry = time.perf_counter() - t0
    sharded = _parallel_run(["sharded"], PARALLEL_DIR / "sharded",
                            timeout=420)
    state["parallel_launches"] = entry["counts"]
    state["parallel_val_launches"] = entry["val_launches"]
    state["parallel_sharded_launches"] = sharded["counts"]["tp"]
    print(f"parallel: entry point (rank 0 of 1, NCCL, mesh "
          f"{entry['mesh']}) {PARALLEL_STEPS} steps in "
          f"{entry['seconds']:.1f} s (process {t_entry:.1f} s); median "
          f"ms/step {entry['ms_per_step']:.2f}; block losses "
          f"{[round(x, 5) for x in entry['losses']]}; launches "
          f"{entry['counts']} (+{entry['val_launches']} head in validation);"
          f" test PSNR {entry['psnr']}; collectives per block "
          f"{entry['collectives']}", flush=True)
    print(f"parallel: helper median ms/step (blocks 2-16, in turns) "
          f"{sharded['ms_per_step']} (one: no mesh; dp: 1-rank mesh; tp: "
          f"table sharded on a 1 x 1 mesh); launches {sharded['counts']}; "
          f"collectives per block {sharded['collectives']}; after the "
          f"first block |a - b| / |b - b0| per leaf "
          f"{sharded['first_block']}", flush=True)
    print(f"parallel: card {card_line()}", flush=True)
    state["parallel_summary"] = {
        "ms_per_step": {"entry_dp": entry["ms_per_step"],
                        **sharded["ms_per_step"]},
        "collective_bytes_per_block": {
            "entry_dp": entry["collectives"]["per_block"],
            **{k: v["per_block"] for k, v in
               sharded["collectives"].items()}}}
    for name, counts in (("entry", entry["counts"]),
                         ("sharded", sharded["counts"]["tp"]),
                         ("dp", sharded["counts"]["dp"])):
        if min(counts["head"], counts["pack"], counts["exact"]) == 0:
            raise AssertionError(f"a kernel never ran on the parallel "
                                 f"path ({name}): {counts}")
    runs = {"entry": entry["losses"], **sharded["losses"]}
    for name, losses in runs.items():
        _loss_fell([{"loss": x} for x in losses])
    if not entry["finite"] or not all(sharded["finite"].values()):
        raise AssertionError(f"non-finite parameters: entry "
                             f"{entry['finite']}, {sharded['finite']}")
    if not np.isfinite(entry["psnr"]).all():
        raise AssertionError(f"non-finite test PSNR {entry['psnr']}")
    floor = sharded["first_block"]["floor"]
    for name in ("dp", "tp"):
        rel = sharded["first_block"][name]
        if any(r > 2 * f + PARALLEL_TOL for r, f in zip(rel, floor)):
            raise AssertionError(f"{name} after the first block departs "
                                 f"from one process: {rel} (two runs "
                                 f"without a mesh: {floor})")
    proc = subprocess.run(
        [sys.executable, "-m", "arnerf_tpu_torch.train", "--num_gpus", "2",
         *PARALLEL_ARGV], cwd=PARALLEL_DIR, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    print(f"parallel: --num_gpus 2 exits {proc.returncode}: "
          f"{proc.stderr.strip().splitlines()[-1:]}", flush=True)
    if proc.returncode == 0 or "1 GPU(s) are visible" not in proc.stderr:
        raise AssertionError(f"--num_gpus 2 on one GPU was not refused: "
                             f"{proc.returncode} {proc.stderr[-2000:]}")


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
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--resume-worker"]:
        return resume_worker(sys.argv[2:])
    if sys.argv[1:] == ["--multi-gpu"]:
        return multi_gpu_main()
    if sys.argv[1:] == ["--envfit-precision"]:
        return envfit_precision_main()
    if sys.argv[1:2] == ["--step-census"]:
        return step_census_main(int(sys.argv[2]) if sys.argv[2:] else 20)
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
    phase("parallel", lambda: parallel_phase(state, dev))
    phase("tools", lambda: tools_phase(state, dev))
    phase("insert", lambda: insert_phase(state, dev))
    phase("envfit", lambda: envfit_phase(state, dev))
    phase("resume", lambda: resume_phase(state))
    phase("real_updates", lambda: run_real_updates(state, dev))
    phase("baked", lambda: baked_phase(state, dev))
    phase("reference", reference_phase)
    phase("captures", lambda: captures_phase(state, dev))
    phase("hdr", lambda: hdr_phase(state, dev))
    phase("viewer", lambda: viewer_phase(state, dev))
    try:   # measurements, not checks: their absence fails nothing
        profile_view(state.get("ckpt") or write_smoke_checkpoint(dev), dev)
        if "train_ckpt" in state:
            profile_baked_view(state["train_ckpt"], dev)
        if "trainer" in state:
            profile_train_block(state["trainer"])
        if "insert_insertor" in state:
            profile_insert_frame(state["insert_insertor"], dev)
        if "insert_baked_insertor" in state:
            profile_insert_frame(state["insert_baked_insertor"], dev,
                                 "baked")
        if "viewer_gui" in state:
            profile_gui_frames(state, dev)
    except Exception as e:   # noqa: BLE001 - the profiler is optional here
        print(f"profile: not measured ({type(e).__name__}: {e})", flush=True)

    print(card_line().splitlines()[0], flush=True)

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
                   # the parallel phase's training runs bf16: the entry
                   # point (data parallel), its validation, and the helper
                   # with the table sharded
                   "parallel_train": state.get("parallel_launches", {})
                   .get("head", 0) if bf16 else 0,
                   "parallel_train_validation":
                       state.get("parallel_val_launches", 0) if bf16 else 0,
                   "parallel_train_sharded":
                       state.get("parallel_sharded_launches", {})
                       .get("head", 0) if bf16 else 0,
                   "insert": state.get("insert_launches", 0) if bf16 else 0,
                   # ARNERF_INSERT_BAKED=1: its bake (bf16), no frame
                   "insert_baked":
                       state.get("insert_baked_launches", 0) if bf16 else 0,
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
        # the HDR phase: its three trainings and their validation renders
        # and the insertion run bf16, its eval f32
        by_path["hdr_train"] = state.get("hdr_train_launches", {}).get(
            "head", 0) if bf16 else 0
        by_path["hdr_train_validation"] = state.get(
            "hdr_val_launches", 0) if bf16 else 0
        by_path["hdr_insert"] = state.get("hdr_insert_launches", 0) \
            if bf16 else 0
        by_path["hdr_eval"] = 0 if bf16 else state.get("hdr_eval_launches",
                                                       0)
        # the tools (no field: 0), generate_envmaps' probes on the network
        # insertor (bf16, as insert), and the resumed training run (bf16)
        # and its validation renders
        by_path["tools"] = state.get("tools_launches", {}).get("head", 0) \
            if bf16 else 0
        by_path["envfit_generate_envmaps"] = state.get(
            "envfit_launches", 0) if bf16 else 0
        by_path["resume_train"] = state.get("resume_launches", {}).get(
            "head", 0) if bf16 else 0
        by_path["resume_train_validation"] = state.get(
            "resume_val_launches", 0) if bf16 else 0
        # the viewer renders and bakes in f32: its network frames, its
        # startup bakes and its live preview's delta bake
        for k, v in state.get("viewer_launches", {}).items():
            by_path[k] = 0 if bf16 else v
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
        by_path = {"train": train.get(mode, 0),
                   "parallel_train": state.get("parallel_launches", {})
                   .get(mode, 0),
                   "parallel_train_sharded":
                       state.get("parallel_sharded_launches", {})
                       .get(mode, 0)}
        for name in ("nerf", "colmap"):
            by_path[f"captures_train_{name}"] = state.get(
                ("capture_train", name), {}).get(mode, 0)
        by_path["hdr_train"] = state.get("hdr_train_launches", {}).get(
            mode, 0)
        by_path["tools"] = state.get("tools_launches", {}).get(mode, 0)
        by_path["resume_train"] = state.get("resume_launches", {}).get(
            mode, 0)
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
