#!/usr/bin/env python3
"""Census of the card-vs-CPU disagreements of the baked renderer.

    python3 scripts/baked_flip_census.py [trainings]    # one NVIDIA GPU

Trains chip_smoke.py's train-phase model `trainings` times (default 2;
each 1,000 steps differs, the segment sum's float atomics being unordered),
bakes each checkpoint at 64^3 on the CPU, and renders 28 synthetic views
(the 4 test and 24 train poses; the test poses under two keys) at 64x64,
trilinear and stochastic, on the card and on the CPU from that bake, as
chip_smoke.baked_card_vs_cpu does for the 4 test views. For every view it
prints whether the rays are equal bit for bit, the largest error of the
pixels within 1e-4, the pixels over it and the rounds; for each pixel over
it, the stochastic renderer's per-ray opacity buckets (weight, and mean
depth from which the colour voxel is rounded) on both sides. Writes all of
it to chiprun_out/baked_flip_census.json.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from arnerf_tpu_torch import build  # noqa: E402
from arnerf_tpu_torch import rendering_baked as rb  # noqa: E402
from arnerf_tpu_torch.datasets.ray_utils import get_rays  # noqa: E402
from arnerf_tpu_torch.datasets.synthetic import (  # noqa: E402
    SyntheticConfig, SyntheticDataset)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init  # noqa: E402
from arnerf_tpu_torch.ops import threefry  # noqa: E402
from arnerf_tpu_torch.training.ckpt import load_ckpt  # noqa: E402

_captured = []
_bucket_color = rb._bucket_color
_cull = rb.cull_and_buckets


def _record_buckets(rows, row_index, rows_q, rays_o, rays_d, bw, bwt, B,
                    scale):
    _captured.append(("bw", bw.cpu(), bwt.cpu()))
    return _bucket_color(rows, row_index, rows_q, rays_o, rays_d, bw, bwt,
                         B, scale)


def _record_cull(*args, **kwargs):
    out = _cull(*args, **kwargs)
    _captured.append(("sl", [b[0] for b in out[0]]))
    return out


def _render(bk, ro, rd, cfg, key, interp):
    _captured.clear()
    stats = {}
    out = rb.render_baked(bk, None, ro, rd, cfg, key=key, interp=interp,
                          img_wh=(64, 64), stats=stats)
    return out, stats["rounds"], list(_captured)


def _buckets_of(captured, p):
    """(weights, mean depths) of pixel p's opacity buckets."""
    sls = [c[1] for c in captured if c[0] == "sl"][0]
    bws = [c for c in captured if c[0] == "bw"]
    for (_, bw, bwt), sl in zip(bws, sls):
        hit = np.nonzero(sl == p)[0]
        if len(hit):
            j = int(hit[0])
            return (bw[j].tolist(),
                    (bwt[j] / torch.clamp(bw[j], min=1e-12)).tolist())
    return None


def main() -> int:
    if not torch.cuda.is_available():
        print("baked_flip_census: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    trainings = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    t0 = time.perf_counter()
    build.build(build.KERNEL_SOURCES + build.HOST_SOURCES)
    rb._bucket_color, rb.cull_and_buckets = _record_buckets, _record_cull
    cfg = NGPConfig(scale=0.5, fused_head=True)
    views = []
    for split in ("test", "train"):
        ds = SyntheticDataset(split=split, read_meta=False,
                              config=SyntheticConfig(img_wh=(64, 64)))
        views += [(split, i, p) for i, p in enumerate(ds.poses)]
    dirs = torch.as_tensor(ds.directions)
    results = []
    for run in range(trainings):
        res = cs.train_entry(cs.TRAIN_ARGV, cs.SMOKE_DIR / f"census{run}",
                             f"census{run}")
        params, state, _ = load_ckpt(res["ckpt"], grid_template=(
            grid_state_init(cfg, cpu)), device=cpu)
        c = rb.bake_ngp(params, state, cfg, resolution=cs.BAKE_CHECK_RES,
                        stoch=True)
        g = rb.BakedField(**{k: v.to(dev) if torch.is_tensor(v) else v
                             for k, v in vars(c).items()})
        for split, i, pose in views:
            ro_c, rd_c = get_rays(dirs, torch.as_tensor(pose))
            ro_g, rd_g = get_rays(dirs.to(dev), torch.as_tensor(pose).to(dev))
            rays_equal = bool(torch.equal(rd_g.cpu(), rd_c)
                              and torch.equal(ro_g.cpu(), ro_c))
            for seed in ((7, 1) if split == "test" else (7,)):
                key = threefry.prng_key(seed)
                for interp in ("trilinear", "stochastic"):
                    oc, rc, capc = _render(c, ro_c, rd_c, cfg, key, interp)
                    og, rg, capg = _render(g, ro_g, rd_g, cfg, key, interp)
                    px = torch.stack(
                        [(og[k].cpu() - oc[k]).abs().reshape(64 * 64, -1)
                         .amax(dim=1) for k in ("rgb", "opacity", "depth")],
                        dim=1)
                    flips = torch.nonzero(px.amax(dim=1) > 1e-4)[:, 0]
                    ok = torch.ones(64 * 64, dtype=torch.bool)
                    ok[flips] = False
                    rec = {"training": run, "split": split, "view": i,
                           "key": seed, "interp": interp,
                           "rays_equal": rays_equal,
                           "max_within": px[ok].amax(dim=0).tolist(),
                           "flipped": int(flips.numel()),
                           "rounds": [rg, rc], "pixels": []}
                    for p in flips.tolist():
                        d = {"pixel": p, "error": px[p].tolist()}
                        if interp == "stochastic":
                            d["buckets_card_cpu"] = [_buckets_of(capg, p),
                                                     _buckets_of(capc, p)]
                        rec["pixels"].append(d)
                    results.append(rec)
                    print(json.dumps({k: v for k, v in rec.items()
                                      if k != "pixels"}), flush=True)
    n = len(results)
    flipped = [r for r in results if r["flipped"]]
    print(f"baked_flip_census: {n} views, {len(flipped)} with pixels over "
          f"1e-4 (most in one view: "
          f"{max((r['flipped'] for r in results), default=0)}), rounds "
          f"unequal in {sum(r['rounds'][0] != r['rounds'][1] for r in results)}"
          f"; {time.perf_counter() - t0:.1f} s", flush=True)
    for r in flipped:
        print(json.dumps(r)[:2000], flush=True)
    out = ROOT / "chiprun_out" / "baked_flip_census.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
