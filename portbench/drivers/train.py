"""Training traffic: the program's NeRFTrainer on the configuration's
scene, through its own fit() loop, one or several ranks.

Set-up makes the images (the analytic scene rendered on the card), makes
the weights from the seed, builds the trainer with them and runs the grid
warm-up (warmup_steps) and one block after it; the window then runs blocks
until `--seconds` have passed, and train_ms_per_step is the whole window
over the steps it completed (rank 0's on several cards). A block is the
trainer's: one grid update and update_interval steps, ending in the loss
read fit() makes.

What decides `correct` (PERF.md): the reference follows three steps twice,
from the program's state before each: steps 0-2 (the first block, whose
grid update evaluates every cell) and the first three after warm-up (the
two-level marcher the window runs). Each time it takes the program's
weights, Adam moments, occupancy grid and draws (which rays, the jitter,
the corner seed) as they were, recomputes the grid update, the march, the
field, the composite, the loss, the gradient and Adam, and compares the
losses, the first gradient (the program's read back from its Adam moments)
and the parameters' change after three steps, leaf by leaf, and the
occupancy bits of the grid update.
"""

import sys
import time

import numpy as np
import torch

from portbench.harness import device_info
from portbench.reference import field as ref_field
from portbench.reference import scene, weights
from portbench.reference import train as ref
from portbench import trace as tracing

B1 = 0.9


class WindowClosed(Exception):
    """Raised from fit()'s callback to end the window."""


class Data:
    """The dataset object the trainer reads: images (n, H*W, 3) on the
    device, poses (n, 3, 4), directions (H*W, 3), K and the image size. On
    several ranks each renders every world-th view and they exchange
    them."""

    def __init__(self, cfg: dict, device, rank: int = 0, world: int = 1):
        w, h = cfg["img_wh"]
        self.img_wh = (w, h)
        self.K = scene.intrinsics(w, h, cfg["fov_deg"])
        self.poses = scene.ring_poses(cfg["scale"], cfg["n_train_views"],
                                      cfg["cam_radius_factor"], 0.0, 7)
        self.directions = scene.directions(w, h, self.K, device)
        n = len(self.poses)
        self.rays = torch.empty((n, w * h, 3), device=device)
        for i in range(rank, n, world):
            self.rays[i] = scene.render_gt(
                *scene.rays(self.directions, self.poses[i]), cfg["scale"],
                n_samples=cfg["gt_samples"])
        for i0 in range(0, n, world) if world > 1 else ():
            got = [torch.empty_like(self.rays[0]) for _ in range(world)]
            torch.distributed.all_gather(got, self.rays[min(i0 + rank,
                                                            n - 1)])
            for r, img in enumerate(got):
                if i0 + r < n:
                    self.rays[i0 + r] = img


def ngp_config(cfg: dict, device):
    from arnerf_tpu_torch.models.ngp import NGPConfig
    return NGPConfig(
        scale=cfg["scale"], grid_size=cfg["grid_size"],
        n_levels=cfg["n_levels"], n_features=cfg["n_features"],
        log2_hashmap_size=cfg["log2_hashmap_size"],
        base_resolution=cfg["base_resolution"],
        sigma_hidden=cfg["sigma_hidden"], sigma_out=cfg["sigma_out"],
        rgb_hidden=cfg["rgb_hidden"], compute_dtype=cfg["compute_dtype"],
        fused_head=cfg["fused_head"], stoch_corners=cfg["stoch_corners"])


def _clone(tensors):
    return [t.detach().clone() for t in tensors]


class Observer:
    """Records, for the steps the reference follows, what the program drew
    and held: it wraps the trainer module's rays_at, draw_train_inputs and
    finish_step and the model module's update_density_grid_core while it
    is installed, and counts steps by finish_step's calls."""

    def __init__(self, trainer, starts, n_steps: int = 3):
        from arnerf_tpu_torch.models import ngp as ngp_mod
        from arnerf_tpu_torch.training import ckpt
        from arnerf_tpu_torch.training import trainer as tr_mod
        self.trainer, self.starts, self.n = trainer, tuple(starts), n_steps
        self.leaves = lambda: ckpt.tree_leaves(trainer.params)
        self.mods = {(tr_mod, "rays_at"), (tr_mod, "draw_train_inputs"),
                     (tr_mod, "finish_step"),
                     (ngp_mod, "update_density_grid_core")}
        self.orig = {name: getattr(m, name) for m, name in self.mods}
        self.step = 0
        self.rec = {s: {"steps": [{} for _ in range(n_steps)]}
                    for s in self.starts}

    def _cur(self):
        for s in self.starts:
            if s <= self.step < s + self.n:
                return self.rec[s]["steps"][self.step - s], s
        return None, None

    def install(self):
        o = self.orig

        def rays_at(images, poses, directions, img_idxs, pix_idxs, *a, **k):
            cur, _ = self._cur()
            if cur is not None:
                cur["img"], cur["pix"] = img_idxs.clone(), pix_idxs.clone()
            return o["rays_at"](images, poses, directions, img_idxs,
                                pix_idxs, *a, **k)

        def draw_train_inputs(*a, **k):
            out = o["draw_train_inputs"](*a, **k)
            cur, _ = self._cur()
            if cur is not None:
                cur["noise"], cur["seed"] = out[0].clone(), out[1]
                cur["bg"] = out[2]
            return out

        def finish_step(params, opt, loss, results, rgb_gt, **k):
            cur, s = self._cur()
            if cur is not None:
                tc = self.trainer.tc
                cur["m_cap"] = tc.batch_size * tc.samples_per_ray_budget
                pooled = tc.seg_pool and self.trainer.cfg.cascades == 1 \
                    and self.step >= tc.warmup_steps
                cur["pool"] = tc.batch_size * tc.seg_cap if pooled else 0
                cur["demand"] = results["rm_samples"].detach().clone()
                cur["loss"] = loss.detach().clone()
                if self.step == s:
                    r = self.rec[s]
                    r["p0"] = _clone(self.leaves())
                    r["mu0"], r["nu0"] = _clone(opt.mu), _clone(opt.nu)
                    r["count0"] = opt.count
            out = o["finish_step"](params, opt, loss, results, rgb_gt, **k)
            if cur is not None:
                if self.step == s:
                    self.rec[s]["mu1"] = _clone(opt.mu)
                if self.step == s + self.n - 1:
                    self.rec[s]["p3"] = _clone(self.leaves())
            self.step += 1
            return out

        def update_density_grid_core(params, state, cfg, thr, idx, jitter,
                                     seed=None, **k):
            new = o["update_density_grid_core"](params, state, cfg, thr, idx,
                                                jitter, seed=seed, **k)
            if self.step in self.rec:
                self.rec[self.step]["grid"] = {
                    "pre": state.density_grid.clone(),
                    "idx": None if idx is None else idx.clone(),
                    "jitter": jitter.clone(), "seed": seed,
                    "decay": k.get("decay", 0.95),
                    "occ": new.occ_flat.clone(),
                    "params": _clone(self.leaves())}
            return new

        fns = {"rays_at": rays_at, "draw_train_inputs": draw_train_inputs,
               "finish_step": finish_step,
               "update_density_grid_core": update_density_grid_core}
        for m, name in self.mods:
            setattr(m, name, fns[name])

    def remove(self):
        for m, name in self.mods:
            setattr(m, name, self.orig[name])

    def complete(self) -> bool:
        return all("grid" in r and "p3" in r and "mu1" in r
                   and all("img" in s for s in r["steps"])
                   for r in self.rec.values())


def _host(rec):
    """A record with every tensor on the host (to gather across ranks)."""
    if torch.is_tensor(rec):
        return rec.cpu()
    if isinstance(rec, dict):
        return {k: _host(v) for k, v in rec.items()}
    if isinstance(rec, (list, tuple)):
        return type(rec)(_host(v) for v in rec)
    return rec


def run(cell, args, ranks, t_start: float, device=None):
    """One run of a training cell; returns what harness.result_line needs
    on rank 0, an empty dict on the other ranks."""
    from arnerf_tpu_torch.parallel import init_distributed, make_mesh
    from arnerf_tpu_torch.training.trainer import NeRFTrainer, TrainConfig
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device or "cuda:0")
    mesh = None
    if ranks.size > 1:
        dev = init_distributed(dev)
        mesh = make_mesh()
    elif dev.type == "cuda":
        torch.cuda.set_device(dev)
    data = Data(cfg, dev, ranks.rank, ranks.size)
    w0 = weights.make(cfg, args.seed, dev)
    tc = TrainConfig(batch_size=cfg["batch_size"], lr=cfg["lr"],
                     num_epochs=cfg["num_epochs"],
                     steps_per_epoch=cfg["steps_per_epoch"],
                     warmup_steps=cfg["warmup_steps"],
                     update_interval=cfg["update_interval"])
    trainer = NeRFTrainer(ngp_config(cfg, dev), tc, data, seed=args.seed,
                          device=dev, mesh=mesh)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(ref.named_leaves(trainer.params),
                                      ref.named_leaves(w0)):
            dst.copy_(src)
    del w0
    warm, ui = cfg["warmup_steps"], cfg["update_interval"]
    obs = Observer(trainer, (0, warm))
    obs.install()
    t_made = time.perf_counter()
    st = {"rm": [], "evaluated": 0.0, "blocks": 0, "parts": []}

    def stop_all(local: bool) -> bool:
        if mesh is None:
            return local
        flag = torch.tensor([1.0 if local else 0.0], device=dev)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX)
        return bool(flag.item() > 0)

    def callback(step, last):
        if step == warm + ui:                      # set-up ends here
            obs.remove()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            st["setup_s"] = time.perf_counter() - t_start
            st["step0"], st["budget"] = step, trainer.tc.samples_per_ray_budget
            if args.trace:
                st["part"] = tracing.start(dev, host=False)
            st["t0"] = time.perf_counter()
            return
        if "t0" not in st:
            return
        st["blocks"] += 1
        now = time.perf_counter()
        if not st["parts"]:          # the window, or the device part
            rm = float(last["rm_s"])
            st["rm"].append(rm)
            st["evaluated"] += min(rm, st["budget"]) * tc.batch_size * ui
        st["budget"] = trainer.tc.samples_per_ray_budget
        if args.trace:
            done = st["blocks"] >= traffic["trace_blocks"]
            if stop_all(done):
                st["blocks"] = 0
                st["parts"].append((tracing.stop(dev, st["part"]), step))
                if len(st["parts"]) == 1:
                    st["part"] = tracing.start(dev, host=True)
                    return
                st["t1"], st["step1"] = now, st["parts"][0][1]
                raise WindowClosed
        elif stop_all(now - st["t0"] >= args.seconds):
            st["t1"], st["step1"] = now, step
            raise WindowClosed

    try:
        trainer.fit(n_steps=1 << 40, log_every=0, callback=callback)
    except WindowClosed:
        pass
    finally:
        obs.remove()
    print(f"set-up: inputs and trainer {t_made - t_start:.2f} s, warm-up "
          f"{st['setup_s'] - (t_made - t_start):.2f} s", file=sys.stderr)
    steps = st["step1"] - st["step0"]
    window = st["t1"] - st["t0"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = None
    if args.trace:
        (p_dev, wall), _ = st["parts"][0]
        (p_host, _), s_host = st["parts"][1]
        cells = ref.Spec(cfg).cascades * (cfg["grid_size"] ** 3 // 2) \
            * (steps // ui)
        counters = {"rm_s": st["rm"], "samples": st["evaluated"],
                    "grid_cells": cells}
        trace = tracing.Trace.of(p_dev, wall, steps, p_host,
                                 s_host - st["step1"], counters, cfg)
    rec = obs.rec if obs.complete() else None
    del trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mine = {"steps": None if rec is None else _host(
                {s: {"steps": r["steps"]} for s, r in rec.items()}),
            "peak": peak,
            "busy": None if trace is None else (trace.busy_s,
                                                trace.window_s)}
    if mesh is not None:
        everyone = [None] * ranks.size
        torch.distributed.all_gather_object(everyone, mine)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        if ranks.rank != 0:
            return {}
    else:
        everyone = [mine]
    recs = [rec] + [e["steps"] for e in everyone[1:]]
    out = {"attempted": steps, "failed": 0, "trace": trace,
           "metrics": {"train_ms_per_step": 1e3 * window / steps,
                       "setup_s": st["setup_s"]}}
    busy = None
    if trace is not None:
        busy = tuple(float(np.mean([e["busy"][i] for e in everyone]))
                     for i in range(2))
    out["device"] = device_info(dev, [e["peak"] for e in everyone],
                                ranks.size, busy)
    if any(r is None for r in recs):
        out["numbers"], out["fault"] = {}, "the observed steps are incomplete"
        return out
    t_ref = time.perf_counter()
    out["numbers"] = compare_all(cfg, data, recs)
    print(f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    out["probes"] = probes(cfg, data, recs)
    return out


def _batches(rec_steps, data, dev, half: bool = False):
    """The ranks' batches of one step, rebuilt from their draws (with
    `half`, the first half of each rank's rays only: a fault)."""
    out = []
    for s in rec_steps:
        n = len(s["img"]) // 2 if half else len(s["img"])
        img, pix = s["img"][:n].to(dev), s["pix"][:n].to(dev)
        pose = torch.as_tensor(data.poses, device=dev)[img]
        d = torch.einsum("nc,nbc->nb", data.directions[pix], pose[..., :3])
        out.append({"rays_o": pose[..., 3], "rays_d": d,
                    "rgb": data.rays[img, pix],
                    "noise": s["noise"][:n].to(dev),
                    "seed": s["seed"], "m_cap": s["m_cap"],
                    "pool": s["pool"]})
    return out


def follow(cfg, data, recs, start, rnd=ref_field.identity,
           half: bool = False):
    """The reference's readings of one followed stretch (or, with `rnd`, a
    control's; with `half`, the reference with half of each batch left
    out): losses, first gradients, parameters after three steps and the
    grid update's occupancy."""
    dev = data.rays.device
    spec = ref.Spec(cfg)
    r0 = recs[0][start]
    tree = ref.rebuild(TREE, [p.to(dev) for p in r0["p0"]])
    steps = [_batches([r[start]["steps"][i] for r in recs], data, dev, half)
             for i in range(len(r0["steps"]))]
    with ref_field.matmul_tf32():
        g = r0["grid"]
        gtree = ref.rebuild(TREE, [p.to(dev) for p in g["params"]])
        _, occ = ref.grid_update(
            gtree, g["pre"].to(dev),
            None if g["idx"] is None else g["idx"].to(dev),
            g["jitter"].to(dev), g["seed"], spec, decay=g["decay"], rnd=rnd)
        losses, g1, p3, demand = ref.follow(
            tree, [m.to(dev) for m in r0["mu0"]],
            [v.to(dev) for v in r0["nu0"]], r0["count0"],
            g["occ"].to(dev), steps, spec, rnd)
    return {"losses": losses, "grad": [g1[n] for n in NAMES],
            "p3": [p3[n] for n in NAMES], "occ": occ, "demand": demand}


def program(recs, start, dev):
    """The program's readings of one followed stretch: losses (the ranks'
    mean), its first gradient read back from Adam's moments, its
    parameters after three steps and its grid update's occupancy."""
    r0 = recs[0][start]
    losses = [float(np.mean([float(r[start]["steps"][i]["loss"])
                             for r in recs]))
              for i in range(len(r0["steps"]))]
    grad = [((m1.to(dev) - B1 * m0.to(dev)) / (1 - B1))
            for m0, m1 in zip(r0["mu0"], r0["mu1"])]
    demand = [sum(int(r[start]["steps"][i]["demand"]) for r in recs)
              for i in range(len(r0["steps"]))]
    return {"losses": losses, "grad": grad,
            "p3": [p.to(dev) for p in r0["p3"]],
            "occ": r0["grid"]["occ"].to(dev), "demand": demand}


def numbers(cand: dict, refr: dict, p0, pre_grid, detail=None) -> dict:
    """The compared numbers of a candidate (the program or a control)
    against the reference: the widest relative loss gap; by the worst leaf,
    the gap of the first gradient's norm and of the norm of the change over
    three steps, each over the larger of that leaf's and the median leaf's
    reference norm (leaves whose reference gradient is under a thousandth
    of the median leaf's move by round-off alone and are left out of the
    change), and the median leaf's change gap; the share of visible grid
    cells whose occupancy differs."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(cand["losses"],
                                                   refr["losses"]))
    gn_r = [float(torch.linalg.norm(g)) for g in refr["grad"]]
    gn_c = [float(torch.linalg.norm(g)) for g in cand["grad"]]
    med = float(np.median(gn_r))
    grad = max(abs(c - r) / max(r, med) for c, r in zip(gn_c, gn_r))
    moved = [i for i, r in enumerate(gn_r) if r >= 1e-3 * med]
    dn_r = [float(torch.linalg.norm(refr["p3"][i] - p0[i])) for i in moved]
    dn_c = [float(torch.linalg.norm(cand["p3"][i] - p0[i])) for i in moved]
    dmed = float(np.median(dn_r))
    upd = [abs(c - r) / max(r, dmed) for c, r in zip(dn_c, dn_r)]
    vis = pre_grid.reshape(-1) >= 0
    flips = (cand["occ"] != refr["occ"])[vis].float().mean()
    if detail is not None:
        detail.update(grad=list(zip(gn_c, gn_r)), change=list(zip(dn_c, dn_r)),
                      losses=list(zip(cand["losses"], refr["losses"])))
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": max(upd),
            "update_median": float(np.median(upd)),
            "grid_flips": float(flips)}


def compare_all(cfg, data, recs, rnd=None, fault: str = None,
                detail: dict = None) -> dict:
    """Every compared number of a run: the program's against the reference,
    for the stretch from step 0 ("start.") and after warm-up ("timed.").
    With `rnd` the candidate is the reference at that rounding (the
    control); with `fault` the reference with a fault planted: "half" (half
    of each batch left out, the mean over the rest) or "local" (rank 0's
    rays alone, the exchange between ranks left out)."""
    dev = data.rays.device
    out = {}
    for start, tag in zip(sorted(recs[0]), ("start", "timed")):
        refr = follow(cfg, data, recs, start)
        if rnd is None and fault is None:
            cand = program(recs, start, dev)
        else:
            cand = follow(cfg, data, recs[:1] if fault == "local" else recs,
                          start, rnd or ref_field.identity,
                          half=fault == "half")
        p0 = [p.to(dev) for p in recs[0][start]["p0"]]
        pre = recs[0][start]["grid"]["pre"].to(dev)
        d = None if detail is None else detail.setdefault(tag, {})
        for k, v in numbers(cand, refr, p0, pre, d).items():
            out[f"{tag}.{k}"] = v
        out[f"{tag}.demand_gap"] = max(
            abs(a - b) / max(b, 1) for a, b in zip(cand["demand"],
                                                   refr["demand"]))
    return out


def probes(cfg, data, recs) -> dict:
    """The readings that set the limits (portbench.calibrate): the control
    (the reference in fp8, the precision below the configuration's bf16)
    and the faults planted in the reference."""
    def leaves():
        detail = {}
        compare_all(cfg, data, recs, detail=detail)
        return detail

    out = {"control": lambda: compare_all(cfg, data, recs,
                                          rnd=ref_field.round_fp8),
           "half_batch": lambda: compare_all(cfg, data, recs, fault="half"),
           "bf16": lambda: compare_all(cfg, data, recs,
                                       rnd=ref_field.round_bf16),
           "leaves": leaves}
    if len(recs) > 1:
        out["no_exchange"] = lambda: compare_all(cfg, data, recs,
                                                 fault="local")
    return out


# the parameter tree's shape, for rebuilding it from its leaves
TREE = {"hash_table": 0, "sigma_mlp": [0, 0], "rgb_mlp": [0, 0, 0]}
NAMES = [n for n, _ in ref.named_leaves(TREE)]
