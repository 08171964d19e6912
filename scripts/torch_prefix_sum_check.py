#!/usr/bin/env python3
"""Why composite_train sums optical depths in float64: train the COLMAP
capture of chip_smoke.py at --scale 16 (6 cascades, exp stepping) on one
GPU twice through the port's train entry point, first with the float32
batch prefix sum of the JAX formulation (instrumented), then with the
port's float64 one, and print each run's losses and PSNRs and, for the
float32 run, the largest density and optical depth, the batch sum, and how
far the float32 difference of sums lands from the float64 one.

    python3 scripts/torch_prefix_sum_check.py     # from the repo root

Outputs go under build/prefix_sum_check/.
"""

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from arnerf_tpu_torch import rendering, train as port_train  # noqa: E402
from arnerf_tpu_torch.datasets.captures import write_colmap_capture  # noqa
from arnerf_tpu_torch.ops import composite as comp  # noqa: E402

WORK = os.path.join(ROOT, "build", "prefix_sum_check")


def float32_composite(stats):
    """composite_train with the float32 batch prefix sum, recording per
    call: max density, max optical depth, the batch sum, the smallest
    exclusive sum of a valid sample and its largest error against float64,
    and whether densities and colours are finite."""
    def composite(sigmas, rgbs, deltas, ts, ray_idx, valid, ray_start,
                  counts, T_threshold):
        sd = sigmas * deltas * valid.to(sigmas.dtype)
        sd_cum = torch.cumsum(sd, dim=0)
        sd_excl = sd_cum - sd - comp._segment_base(sd_cum, ray_start,
                                                   ray_idx)
        with torch.no_grad():
            sd64 = sd.double()
            c64 = torch.cumsum(sd64, 0)
            ex64 = c64 - sd64 - comp._segment_base(c64, ray_start, ray_idx)
            err = (sd_excl.double() - ex64)[valid]
            stats.append((float(sigmas.max()), float(sd.max()),
                          float(sd_cum[-1]), float(sd_excl[valid].min()),
                          float(err.abs().max()),
                          bool(torch.isfinite(sigmas).all()),
                          bool(torch.isfinite(rgbs).all())))
        T_before = torch.exp(-sd_excl)
        alpha = 1.0 - torch.exp(-sd)
        included = (T_before > T_threshold) & valid
        w = alpha * T_before * included.to(sigmas.dtype)
        tot = comp._ray_totals(torch.cat([w[:, None], (w * ts)[:, None],
                                          w[:, None] * rgbs], dim=1),
                               ray_idx, valid, counts.shape[0])
        return comp.CompositeResults(opacity=tot[:, 0], depth=tot[:, 1],
                                     rgb=tot[:, 2:], ws=w,
                                     vr_samples=included.sum())
    return composite


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.join(WORK, "colmap")
    if not os.path.exists(root):
        t0 = time.perf_counter()
        write_colmap_capture(root, n_views=cs.COLMAP_VIEWS, wh=cs.COLMAP_WH,
                             device=torch.device("cuda"))
        print(f"capture written in {time.perf_counter() - t0:.1f} s")
    argv = cs.CAPTURE_ARGV["colmap"] + ["--root_dir", root, "--no_save_test"]
    stats = []
    for label, fn in (("float32", float32_composite(stats)),
                      ("float64", comp.composite_train)):
        rendering.composite_train = fn
        work = os.path.join(WORK, label)
        os.makedirs(work, exist_ok=True)
        cwd = os.getcwd()
        os.chdir(work)
        blocks, err = [], None
        t0 = time.perf_counter()
        try:
            port_train.main(argv + ["--exp_name", label], callback=lambda s, m, _:
                            blocks.append((s, float(m["loss"]),
                                           float(m["psnr"]))))
        except FloatingPointError as e:
            err = e
        finally:
            os.chdir(cwd)
        print(f"== {label} prefix sum: {time.perf_counter() - t0:.1f} s, "
              f"error {err}; blocks (step, loss, psnr) {blocks[::8]} last "
              f"{blocks[-2:]}", flush=True)
        if label == "float32" and stats:
            a = np.array([s[:5] for s in stats])
            print(f"   steps {len(stats)}; max sigma {a[:, 0].max():.3g}, "
                  f"max optical depth {a[:, 1].max():.3g}, max batch sum "
                  f"{a[:, 2].max():.3g}, min exclusive sum "
                  f"{a[:, 3].min():.3g}, max |float32 - float64| "
                  f"{a[:, 4].max():.3g}; non-finite sigmas "
                  f"{sum(not s[5] for s in stats)}, rgbs "
                  f"{sum(not s[6] for s in stats)}", flush=True)
            for i in range(0, len(stats), 50):
                print("   step", i, stats[i], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
