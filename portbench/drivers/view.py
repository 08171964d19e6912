"""View traffic: one client in a closed loop, as the viewer runs it. Each
view is rendering.render_test at the viewer's settings from the next pose
of an orbit ring; the next view starts when the last one's colour and
depth are on the host. view_ms is the whole window over the views it
completed, view_ms_p90 the 90th percentile of every view's latency.

Set-up makes the weights from the seed, at a trained field's magnitudes
(reference/weights.py: every occupied point is opaque, so rays end at
their first surface), and the occupancy grid from the analytic scene's
mask (rays march only through the scene's cells, as in a trained scene),
and renders two views. After the window, views drawn from the seed among
those it completed are rendered again by the reference and compared pixel
by pixel.
"""

import sys
import time

import numpy as np
import torch

from portbench.harness import device_info
from portbench.reference import field as ref_field
from portbench.reference import scene, weights
from portbench.reference import view as ref_view
from portbench import trace as tracing


def ngp_config(cfg: dict, traffic: dict):
    from arnerf_tpu_torch.models.ngp import NGPConfig
    return NGPConfig(
        scale=cfg["scale"], grid_size=cfg["grid_size"],
        n_levels=cfg["n_levels"], n_features=cfg["n_features"],
        log2_hashmap_size=cfg["log2_hashmap_size"],
        base_resolution=cfg["base_resolution"],
        sigma_hidden=cfg["sigma_hidden"], sigma_out=cfg["sigma_out"],
        rgb_hidden=cfg["rgb_hidden"], compute_dtype=traffic["compute_dtype"],
        fused_head=cfg["fused_head"])


class Orbit:
    """The poses and pixel directions of the orbit ring."""

    def __init__(self, cfg: dict, traffic: dict, device):
        w, h = traffic["img_wh"]
        self.K = scene.intrinsics(w, h, cfg["fov_deg"])
        self.dirs = scene.directions(w, h, self.K, device)
        self.poses = scene.ring_poses(cfg["scale"], traffic["orbit_views"],
                                      cfg["cam_radius_factor"], 0.5, 11)

    def pose(self, i: int):
        return self.poses[i % len(self.poses)]


def run(cell, args, ranks, t_start: float, device=None):
    """One run of a view cell (one card); returns what
    harness.result_line needs."""
    from arnerf_tpu_torch.datasets.ray_utils import get_rays
    from arnerf_tpu_torch.models.ngp import grid_state_init
    from arnerf_tpu_torch.rendering import render_test
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device or "cuda:0")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ncfg = ngp_config(cfg, traffic)
    params = weights.make(cfg, args.seed, dev, traffic["weights"])
    occ = scene.analytic_occupancy(cfg["scale"], cfg["grid_size"],
                                   ncfg.cascades, device=dev)
    state = grid_state_init(ncfg, dev)._replace(occ_flat=occ)
    orbit = Orbit(cfg, traffic, dev)

    def view(i):
        ro, rd = get_rays(orbit.dirs, torch.as_tensor(orbit.pose(i),
                                                      device=dev))
        out = render_test(params, state, ro, rd, ncfg,
                          T_threshold=traffic["T_threshold"],
                          max_samples=traffic["max_samples"],
                          samples_per_round=traffic["samples_per_round"],
                          fast=True)
        return out["rgb"].cpu(), out["depth"].cpu(), out["total_samples"]

    first = int(np.random.default_rng(args.seed).integers(
        len(orbit.poses)))
    for i in range(traffic["warmup_views"]):
        view(first + len(orbit.poses) // 2 + i)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    images, lat, samples = [], [], 0
    parts = []
    part = tracing.start(dev, host=False) if args.trace else None
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        rgb, depth, n = view(first + len(images))
        te = time.perf_counter()
        images.append((rgb, depth))
        lat.append(te - ts)
        if not parts:
            samples += n
        if not args.trace:
            if te - t0 >= args.seconds:
                break
        elif len(images) % traffic["trace_views"] == 0:
            parts.append(tracing.stop(dev, part))
            if len(parts) == 2:
                break
            window = te - t0
            part = tracing.start(dev, host=True)
    trace = None
    if args.trace:
        n = traffic["trace_views"]
        trace = tracing.Trace.of(parts[0][0], parts[0][1], n, parts[1][0],
                                 n, {"samples": samples}, cfg)
    else:
        window = te - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out = {"attempted": len(images),
           "failed": sum(not bool(torch.isfinite(r).all())
                         for r, _ in images),
           "trace": trace,
           "metrics": {"view_ms": 1e3 * window / len(images),
                       "view_ms_p90": 1e3 * float(np.percentile(lat, 90)),
                       "setup_s": setup_s},
           "device": device_info(dev, [peak], 1, None if trace is None
                                 else (trace.busy_s, trace.window_s))}
    pick = np.random.default_rng(args.seed + 1).choice(
        len(images), size=min(traffic["check_views"], len(images)),
        replace=False)
    checked = [(first + int(i), images[int(i)][0]) for i in pick]
    t_ref = time.perf_counter()
    refs = [_render(cfg, traffic, params, occ, orbit, i) for i, _ in checked]
    out["numbers"] = gaps([rgb for _, rgb in checked], refs)
    rays = len(orbit.dirs) * (len(images) if not args.trace
                              else traffic["trace_views"])
    print(f"set-up {setup_s:.2f} s, {len(images)} views, "
          f"{samples / rays:.3f} samples a ray, reference "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)

    def probe(**k):
        return lambda: gaps([_render(cfg, traffic, params, occ, orbit, i, **k)
                             for i, _ in checked], refs)
    out["probes"] = {"control": probe(tf32=True),
                     "encode_hash": probe(fault="encode_hash"),
                     "encode_scale": probe(fault="encode_scale")}
    return out


def gaps(images, refs) -> dict:
    """The compared numbers of candidate colours `images` against the
    reference's `refs`, by the worst view, over pixels of the largest
    channel gap: the 99th percentile, the mean and the largest."""
    out = {"rgb_p99": 0.0, "rgb_mean": 0.0, "rgb_max": 0.0}
    for rgb, refr in zip(images, refs):
        gap = torch.amax(torch.abs(rgb.to(refr.device) - refr), dim=-1)
        for k, v in (("rgb_p99", torch.quantile(gap.float(), 0.99)),
                     ("rgb_mean", gap.mean()), ("rgb_max", gap.max())):
            out[k] = max(out[k], float(v))
    return out


def grid(cfg, fault: str = None) -> ref_field.Grid:
    """The reference's level layout, or one with a fault planted in the
    encode: "encode_hash" swaps the hash's y and z primes, "encode_scale"
    drops the -1 of every level's scale."""
    g = ref_field.Grid(cfg["scale"], cfg["n_levels"], cfg["n_features"],
                       cfg["log2_hashmap_size"], cfg["base_resolution"])
    if fault == "encode_hash":
        g.primes = g.primes[::-1]
    elif fault == "encode_scale":
        g.scales = [s + 1.0 for s in g.scales]
    elif fault is not None:
        raise ValueError(fault)
    return g


def _render(cfg, traffic, params, occ, orbit, i, tf32: bool = False,
            fault: str = None):
    """The reference's colour of orbit view i; with `tf32` its matmuls in
    TF32 (the control), with `fault` a fault planted in its encode."""
    ro, rd = scene.rays(orbit.dirs, orbit.pose(i))
    cascades = max(1 + int(np.ceil(np.log2(2 * cfg["scale"]))), 1)
    with ref_field.matmul_tf32(allow=tf32):
        return ref_view.render(
            params, occ, ro, rd, scale=cfg["scale"], grid=grid(cfg, fault),
            G=cfg["grid_size"], cascades=cascades,
            max_samples=traffic["max_samples"], cap=traffic["sample_cap"],
            T_threshold=traffic["T_threshold"])[0]
