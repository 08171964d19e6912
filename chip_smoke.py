#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (arnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases (all run, even after a failure; any failure exits non-zero):
  1. build     - compile every CUDA kernel from csrc/ with nvcc (sm_90a).
  2. kernels   - each kernel against its plain PyTorch version on the card,
                 timed beside its bound and a library yardstick.
  3. slice     - the eval entry point (`arnerf_tpu_torch.eval.main`, i.e.
                 render_test(fast=True, max_samples=96, T_threshold=1e-2))
                 renders the synthetic scene's 4 test views at 800x800 with
                 a full-width NGP (16 levels, 2^19 table, 64-wide MLPs) of
                 seeded random weights and the analytic occupancy grid, in
                 bf16 and in f32; the kernels' launch counters must rise.
  4. reference - a 64x64 view rendered in f32 on the card (kernel) and on
                 the CPU (plain versions) must agree.
Then a torch.profiler pass over one bf16 view prints where its time goes
(a measurement only; it fails nothing).
Prints the card's name and power limit, then one JSON line of per-kernel
numbers, then the result line {"ok": true, "device": {...}}.
"""

import json
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
SMOKE_DIR = ROOT / "build" / "arnerf_tpu_torch" / "smoke"


def _time_ms(fn, iters):
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
    ms = _time_ms(lambda: fh.fused_field_head(feats, sh, w, dtype), 20)
    plain_ms = _time_ms(lambda: fh._head_torch(feats, sh, w, dtype), 5)
    wl = tuple(x.to(dtype) for x in w)
    shl = sh.to(dtype)
    library_ms = _time_ms(lambda: _library_head(feats, shl, wl), 10)
    n_w = sum(x.numel() for x in w)
    bytes_moved = (rows * (32 * feats.element_size() + 16 * 4 + 16 * 4
                           + 3 * 4) + n_w * 4)
    flops = 2 * n_w * rows
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {"rows": rows, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


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
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  kernel {t / 1e3:8.2f} ms x{c:5d}  {name[:110]}")


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
        for name in build.KERNEL_SOURCES:
            log = build.library_path(name).with_suffix(".so.log")
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas[{name}]: {line.strip()}")

    def kernel_phase():
        w = _head_weights(dev)
        for dtype_name in ("bfloat16", "float32"):
            for rows in (PARITY_ROWS, MAIN_PATH_ROWS):
                nums = head_kernel_numbers(dtype_name, rows, w, dev)
                print(f"fused_head[{dtype_name}] rows {rows}: {nums}",
                      flush=True)
                state[(dtype_name, rows)] = nums

    def slice_phase():
        state["ckpt"] = write_smoke_checkpoint(dev)
        for dtype_name in ("bfloat16", "float32"):
            state[("launches", dtype_name)] = run_slice(state["ckpt"],
                                                        dtype_name)

    def reference_phase():
        reference_check(state.get("ckpt") or write_smoke_checkpoint(dev), dev)

    phase("build", build_phase)
    phase("kernels", kernel_phase)
    phase("slice", slice_phase)
    phase("reference", reference_phase)
    try:   # a measurement, not a check: its absence fails nothing
        profile_view(state.get("ckpt") or write_smoke_checkpoint(dev), dev)
    except Exception as e:   # noqa: BLE001 - the profiler is optional here
        print(f"profile: not measured ({type(e).__name__}: {e})", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)

    kernels = []
    for dtype_name in ("bfloat16", "float32"):
        nums = state.get((dtype_name, MAIN_PATH_ROWS))
        if nums is None:
            continue
        kernels.append({
            "name": f"fused_field_head[{dtype_name}]", "route": "cuda",
            "source": "arnerf_tpu_torch/csrc/fused_head.cu",
            "replaces": "arnerf_tpu/ops/fused_head.py:42",
            "launches": state.get(("launches", dtype_name), 0),
            "max_abs_err": max(state[(dtype_name, r)]["max_abs_err"]
                               for r in (PARITY_ROWS, MAIN_PATH_ROWS)
                               if (dtype_name, r) in state),
            **{k: nums[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "rows": nums["rows"]})
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
