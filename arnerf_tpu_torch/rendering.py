"""Test-time render orchestration: AABB clip -> march -> field eval ->
composite (port of the test-time half of arnerf_tpu/rendering.py;
reference: models/rendering.py:175-250).

`render_test_chunk` is the reference's alive-ray loop with masks in place
of a shrinking alive list. PyTorch runs eagerly, so the JAX package's
device-side while_loop is simply a host loop here; there is no compiled
variant to fall back from. Every ray is independent of every other, so
the chunking below bounds memory without changing any result.

A `render_test` call runs under a `view` span whose unit is the
process's next view ordinal (utils/profiling.py); each layer of a round
runs under a span of it ("march", "field", "composite"; "first_hit" for
the pre-pass), so a profile of a render attributes device time to layers,
and each point where the host waits for the card (a round's and a
pre-pass's test for live rays, the nonzero of the compactions, the
sample total) under a `host_read` span. With tracing off a span costs what
a `record_function` range costs (about 10 us on an H100 machine's host);
an 800x800 view at the viewer's settings opens about 55.

`render_surface_normal` (the AR insertor's surface cache) differentiates
the density with respect to the positions only, so the hash-grid backward
never computes the table gradient there.

`render_train` is the differentiable training render (marching, field,
compositing, background blend) on explicit noise, corner seed and
background; `draw_train_inputs` draws those from generators. The JAX
package's hoisted block march (`march_results`) is not ported: it is off by
default there.
"""

import torch

from .insert.sh_math import get_sh_val
from .models.ngp import (NGPConfig, ngp_density, ngp_forward,
                         ngp_forward_chunked)
from .ops.composite import composite_test_step, composite_train
from .ops.intersection import ray_aabb_intersect_single
from .ops.marching import (build_coarse_occupancy, coarse_dilation_radius,
                           march_rays_test, march_rays_train,
                           march_rays_train_pooled)
from .ops.stepping import SQRT3, num_lattice_steps
from .utils import profiling

MAX_SAMPLES = 1024   # reference: models/rendering.py:9
NEAR_DISTANCE = 0.01


def scene_hits(rays_o, rays_d, cfg: NGPConfig, mesh_depth_map=None):
    """Scene-AABB intersection with the reference's near clamp
    (rendering.py:29-31) and optional far clamp to an inserted mesh's depth
    map for AR compositing (rendering.py:38-44)."""
    hits = ray_aabb_intersect_single(rays_o, rays_d, torch.zeros(3),
                                     torch.full((3,), cfg.scale))
    t1, t2 = hits[:, 0], hits[:, 1]
    t1 = torch.where((t1 >= 0) & (t1 < NEAR_DISTANCE), NEAR_DISTANCE, t1)
    if mesh_depth_map is not None:
        valid_depth = mesh_depth_map >= 1e-6
        clamped = torch.maximum(torch.minimum(t2, mesh_depth_map), t1)
        t2 = torch.where(valid_depth, clamped, t2)
    return torch.stack([t1, t2], dim=-1)


def default_candidates(cfg: NGPConfig, exp_step_factor: float,
                       max_samples: int = MAX_SAMPLES) -> int:
    """Lattice length covering the scene diagonal from any start."""
    diag = 2 * SQRT3 * cfg.scale
    return num_lattice_steps(NEAR_DISTANCE, NEAR_DISTANCE + diag,
                             exp_step_factor, max_samples, cfg.grid_size,
                             cfg.scale)


def render_train(params, grid_state, rays_o, rays_d, cfg: NGPConfig, *,
                 noise, seed=None, rgb_bg=None, exp_step_factor: float = 0.0,
                 T_threshold: float = 1e-4, m_cap: int = 256 * 1024,
                 s_cap: int = MAX_SAMPLES, max_samples: int = MAX_SAMPLES,
                 seg_cap: int = 64, exposure=None, mesh_depth_map=None,
                 seg_pool: int = 0):
    """Differentiable training render (arnerf_tpu/rendering.py:52-195).
    Returns the reference's results dict (rendering.py:255-298): rgb,
    opacity, depth, ws, deltas, ts, the segment layout and the sample
    counters.

    noise: (N,) U[0, 1) first-sample jitter; seed: None for exact hash
    gathers, a uint32 int for stochastic corners; rgb_bg: (3,) background,
    default white when exp_step_factor == 0 (bounded scenes) else black.
    seg_cap == 0 (warmup) marches single-level; seg_pool > 0 routes
    two-level marching through a shared pool of that many segment slots
    (single-cascade scenes)."""
    hits = scene_hits(rays_o, rays_d, cfg, mesh_depth_map)
    occ_coarse = None
    if seg_cap > 0:
        occ_coarse = _coarse_occupancy(grid_state, cfg, exp_step_factor,
                                       max_samples, None)
    kw = dict(scale=cfg.scale, cascades=cfg.cascades,
              exp_step_factor=exp_step_factor, grid_size=cfg.grid_size,
              max_samples=max_samples,
              n_candidates=default_candidates(cfg, exp_step_factor,
                                              max_samples),
              m_cap=m_cap, s_cap=s_cap, occ_coarse=occ_coarse)
    with profiling.span("march"):
        if seg_pool > 0 and occ_coarse is not None:
            mr = march_rays_train_pooled(rays_o, rays_d, hits,
                                         grid_state.occ_flat, noise,
                                         seg_pool_cap=seg_pool, **kw)
        else:
            mr = march_rays_train(rays_o, rays_d, hits, grid_state.occ_flat,
                                  noise, seg_cap=max(seg_cap, 1), **kw)
    return _render_train_from_march(params, mr, cfg, seed=seed,
                                    rgb_bg=rgb_bg,
                                    exp_step_factor=exp_step_factor,
                                    T_threshold=T_threshold,
                                    exposure=exposure)


def _render_train_from_march(params, mr, cfg: NGPConfig, *, seed, rgb_bg,
                             exp_step_factor: float, T_threshold: float,
                             exposure=None):
    """Field eval + composite + background blend over MarchResults."""
    sample_exposure = None if exposure is None else exposure[mr.ray_idx]
    with profiling.span("field"):
        sigmas, rgbs = ngp_forward(params, mr.xyzs, mr.dirs + 1e-12, cfg,
                                   exposure=sample_exposure, seed=seed)
    with profiling.span("composite"):
        comp = composite_train(sigmas, rgbs, mr.deltas, mr.ts, mr.ray_idx,
                               mr.valid, mr.ray_start, mr.counts,
                               T_threshold)
    if rgb_bg is None:
        rgb_bg = torch.full((3,), 1.0 if exp_step_factor == 0.0 else 0.0,
                            device=comp.rgb.device)
    # background blend (reference rendering.py:287-296)
    rgb = comp.rgb + rgb_bg[None, :] * (1.0 - comp.opacity[:, None])
    zero = torch.zeros((), dtype=torch.int64, device=rgb.device)
    return {
        "rgb": rgb, "opacity": comp.opacity, "depth": comp.depth,
        "ws": comp.ws, "deltas": mr.deltas, "ts": mr.ts,
        "ray_idx": mr.ray_idx, "valid": mr.valid,
        "ray_start": mr.ray_start, "counts": mr.counts,
        "rm_samples": mr.rm_samples, "vr_samples": comp.vr_samples,
        "max_nseg": mr.max_nseg,
        "total_nseg": zero if mr.total_nseg is None else mr.total_nseg,
    }


def draw_train_inputs(n_rays: int, device, *, generator: torch.Generator,
                      host_generator: torch.Generator, stoch: bool,
                      random_bg: bool):
    """render_train's draws: (noise, seed, rgb_bg). The noise and the
    random background come from `generator` on `device`, the corner seed
    (stoch) from the CPU generator `host_generator`, so that no draw waits
    for the card. (jax.random's three-way key split cannot be reproduced in
    torch; the parity tests pass JAX's draws to render_train instead.)"""
    noise = torch.rand(n_rays, generator=generator, device=device)
    seed = int(torch.randint(0, 1 << 32, (), generator=host_generator)) \
        if stoch else None
    rgb_bg = torch.rand(3, generator=generator, device=device) \
        if random_bg else None
    return noise, seed, rgb_bg


def _coarse_occupancy(grid_state, cfg: NGPConfig, exp_step_factor: float,
                      max_samples: int, dt_scale):
    """Dilated supercell grid of single-cascade scenes (None otherwise)."""
    if cfg.cascades != 1:
        return None
    return build_coarse_occupancy(
        grid_state.occ_flat, cfg.cascades, cfg.grid_size,
        dilate=coarse_dilation_radius(
            scale=cfg.scale, exp_step_factor=exp_step_factor,
            grid_size=cfg.grid_size, max_samples=max_samples,
            dt_scale=dt_scale))


@torch.no_grad()
def render_test_chunk(params, grid_state, rays_o, rays_d, cfg: NGPConfig, *,
                      exp_step_factor: float = 0.0, T_threshold: float = 1e-4,
                      max_samples: int = MAX_SAMPLES, n_candidates: int = 512,
                      samples_per_round: int = 32,
                      output_radiance: bool = False, exposure=None,
                      mesh_depth_map=None, init_state=None,
                      max_rounds: int = 0, return_state: bool = False,
                      dt_scale: float = None):
    """Incremental render of one chunk of rays: each round marches every
    still-alive ray `samples_per_round` occupied samples forward and
    composites in place.

    `max_rounds` bounds the loop; `return_state=True` also returns the
    carried (t_cur, opacity, depth, rgb, alive, samples_done) so a caller
    can gather the surviving rays and resume them via `init_state`.
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    hits = scene_hits(rays_o, rays_d, cfg, mesh_depth_map)
    t2 = hits[:, 1]
    occ_coarse = _coarse_occupancy(grid_state, cfg, exp_step_factor,
                                   max_samples, dt_scale)
    if init_state is None:
        alive = hits[:, 0] >= 0
        zeros = torch.zeros(N, device=dev)
        init_state = (torch.where(alive, hits[:, 0], t2 + 1.0), zeros,
                      zeros, torch.zeros((N, 3), device=dev), alive, 0)
    t_cur, opacity, depth, rgb, alive, samples_done = init_state
    S = samples_per_round
    total = torch.zeros((), dtype=torch.int64, device=dev)
    rounds = 0
    while (samples_done < max_samples
           and not (max_rounds and rounds >= max_rounds)):
        with profiling.span("host_read"):
            if not bool(alive.any()):
                break
        with profiling.span("march"):
            xyzs, deltas, ts, n_eff, t_next = march_rays_test(
                rays_o, rays_d, t_cur, t2, grid_state.occ_flat,
                scale=cfg.scale, cascades=cfg.cascades,
                exp_step_factor=exp_step_factor, grid_size=cfg.grid_size,
                max_samples=max_samples, n_candidates=n_candidates,
                n_samples=S, occ_coarse=occ_coarse, dt_scale=dt_scale)
        n_eff = torch.where(alive, n_eff, 0)
        flat_x = xyzs.reshape(N * S, 3)
        flat_d = rays_d[:, None, :].expand(N, S, 3).reshape(-1, 3)
        sample_exposure = None
        if exposure is not None:
            sample_exposure = exposure[:, None, :].expand(N, S, 1) \
                .reshape(-1, 1)
        with profiling.span("field"):
            sig, col = ngp_forward_chunked(params, flat_x, flat_d + 1e-12,
                                           cfg, exposure=sample_exposure,
                                           output_radiance=output_radiance)
        with profiling.span("composite"):
            opacity, depth, rgb, still = composite_test_step(
                sig.reshape(N, S), col.reshape(N, S, 3), deltas, ts, n_eff,
                opacity, depth, rgb, T_threshold)
        t_cur = torch.where(alive, t_next, t_cur)
        alive = alive & still & (t_cur < t2)
        total = total + n_eff.sum()
        samples_done += S
        rounds += 1
    with profiling.span("host_read"):
        total = int(total)
    out = {"opacity": opacity, "depth": depth, "rgb": rgb,
           "total_samples": total}
    if return_state:
        out["state"] = (t_cur, opacity, depth, rgb, alive, samples_done)
    return out


@torch.no_grad()
def first_hit(grid_state_occ, occ_coarse, rays_o, rays_d, hits,
              cfg: NGPConfig, *, exp_step_factor: float = 0.0,
              max_samples: int = MAX_SAMPLES, n_candidates: int = 512,
              dt_scale: float = None):
    """March-only alive detection: for each ray, whether its marching window
    contains ANY occupied lattice sample, and the t of the first one.

    Returns (alive (N,) bool, t_first (N,), parked > t2 for misses). One
    march_rays_test call is not enough: the two-level path truncates at
    seg_cap dilated-occupied segments, so the cursor keeps marching until
    every ray found a sample or parked past t2."""
    t1, t2 = hits[:, 0], hits[:, 1]
    unresolved = t1 >= 0
    t_c = torch.where(unresolved, t1, t2 + 1.0)
    alive = torch.zeros_like(unresolved)
    t_first = t2 + 1.0
    while True:
        with profiling.span("host_read"):
            if not bool(unresolved.any()):
                break
        _, _, ts, n_eff, t_next = march_rays_test(
            rays_o, rays_d, t_c, t2, grid_state_occ,
            scale=cfg.scale, cascades=cfg.cascades,
            exp_step_factor=exp_step_factor, grid_size=cfg.grid_size,
            max_samples=max_samples, n_candidates=n_candidates,
            n_samples=1, occ_coarse=occ_coarse, dt_scale=dt_scale)
        found = unresolved & (n_eff > 0)
        alive = alive | found
        t_first = torch.where(found, ts[:, 0], t_first)
        t_c = torch.where(unresolved, t_next, t_c)
        unresolved = unresolved & ~found & (t_c < t2)
    return alive, t_first


@torch.no_grad()
def render_test_fast(params, grid_state, rays_o, rays_d, cfg: NGPConfig, *,
                     phase1_rounds: int = 2, chunk: int = 1 << 16,
                     prehit: bool = True, **kwargs):
    """Alive-ray-compacted render (the reference's shrinking alive-list
    loop, rendering.py:191-233). Three phases:

    0. `first_hit` pre-pass (occupancy tests only, no field eval) drops
       every ray whose marching window holds no occupied cell.
    1. A few rounds on the survivors; quickly-saturating rays die here.
    2. The remaining survivors are gathered again and finished with bigger
       rounds (the reference grows N_samples as rays die,
       rendering.py:193-196).
    """
    N = rays_o.shape[0]
    dev = rays_o.device
    exp_step_factor = kwargs.get("exp_step_factor", 0.0)
    max_samples = kwargs.get("max_samples", MAX_SAMPLES)
    dt_scale = kwargs.get("dt_scale")

    opacity = torch.zeros(N, device=dev)
    depth = torch.zeros(N, device=dev)
    rgb = torch.zeros((N, 3), device=dev)
    total = 0

    # ---- phase 0: march-only alive detection -------------------------------
    sub_t = None
    if prehit:
        hits = scene_hits(rays_o, rays_d, cfg)
        occ_coarse = _coarse_occupancy(grid_state, cfg, exp_step_factor,
                                       max_samples, dt_scale)
        # the pre-pass scans the ENTIRE marching window (a caller's
        # per-round n_candidates may cover only part of the scene diagonal)
        step_scale = cfg.scale if dt_scale is None else dt_scale
        diag = 2 * SQRT3 * cfg.scale
        fh_K = num_lattice_steps(NEAR_DISTANCE, NEAR_DISTANCE + diag,
                                 exp_step_factor, max_samples,
                                 cfg.grid_size, step_scale)
        with profiling.span("first_hit"):
            found = [first_hit(grid_state.occ_flat, occ_coarse,
                               rays_o[i:i + chunk], rays_d[i:i + chunk],
                               hits[i:i + chunk], cfg,
                               exp_step_factor=exp_step_factor,
                               max_samples=max_samples, n_candidates=fh_K,
                               dt_scale=dt_scale)
                     for i in range(0, N, chunk)]
        alive0 = torch.cat([a for a, _ in found])
        with profiling.span("host_read"):
            idx0 = torch.nonzero(alive0)[:, 0]
        if len(idx0) == 0:
            return {"opacity": opacity, "depth": depth, "rgb": rgb,
                    "total_samples": 0}
        sub_t = torch.cat([t for _, t in found])[idx0]
    else:
        idx0 = torch.arange(N, device=dev)
    M = len(idx0)

    # ---- phase 1: a few rounds on the survivors ----------------------------
    states = []
    for i in range(0, M, chunk):
        rows = idx0[i:i + chunk]
        n = len(rows)
        init_state = None
        if sub_t is not None:
            init_state = (sub_t[i:i + chunk], torch.zeros(n, device=dev),
                          torch.zeros(n, device=dev),
                          torch.zeros((n, 3), device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev), 0)
        res = render_test_chunk(params, grid_state, rays_o[rows],
                                rays_d[rows], cfg, max_rounds=phase1_rounds,
                                return_state=True, init_state=init_state,
                                **kwargs)
        states.append(res["state"])
        total += res["total_samples"]
    t_cur, op1, dp1, rgb1, alive = (torch.cat([s[j] for s in states])
                                    for j in range(5))
    samples_done = max(s[5] for s in states)
    opacity[idx0] = op1
    depth[idx0] = dp1
    rgb[idx0] = rgb1

    # ---- phase 2: gather the survivors again, bigger rounds to the end -----
    with profiling.span("host_read"):
        alive_idx = torch.nonzero(alive)[:, 0]  # into the phase-1 set
    kw2 = dict(kwargs)
    kw2["samples_per_round"] = max(kwargs.get("samples_per_round", 32), 64)
    for i in range(0, len(alive_idx), chunk):
        a = alive_idx[i:i + chunk]
        rows = idx0[a]                        # indices into the input rays
        state = (t_cur[a], op1[a], dp1[a], rgb1[a],
                 torch.ones(len(a), dtype=torch.bool, device=dev),
                 samples_done)
        res2 = render_test_chunk(params, grid_state, rays_o[rows],
                                 rays_d[rows], cfg, init_state=state, **kw2)
        opacity[rows] = res2["opacity"]
        depth[rows] = res2["depth"]
        rgb[rows] = res2["rgb"]
        total += res2["total_samples"]

    return {"opacity": opacity, "depth": depth, "rgb": rgb,
            "total_samples": total}


@torch.no_grad()
def render_test(params, grid_state, rays_o, rays_d, cfg: NGPConfig, *,
                chunk: int = 1 << 16, sh_bkg=None, im_bkg=None,
                blend_bkg: bool = True, fast: bool = False, **kwargs):
    """Full test-time render, chunked over rays, with the reference's
    background options (rendering.py:240-250): an SH environment `sh_bkg`
    (9, 3), evaluated along each ray and clamped positive, or an image
    background `im_bkg` (N, 3) (AR insertion), or none.

    Step sizing mirrors the reference's test kernel, which passes
    `cascades` where calc_dt expects `scale` (raymarching.cu:370,399);
    override with dt_scale=None to step exactly as in training."""
    with profiling.span("view", unit=profiling.next_view()):
        N = rays_o.shape[0]
        chunk = min(chunk, N)
        if "dt_scale" not in kwargs:
            kwargs["dt_scale"] = float(cfg.cascades)
        if fast and kwargs.get("mesh_depth_map") is None \
                and kwargs.get("exposure") is None:
            result = render_test_fast(params, grid_state, rays_o, rays_d, cfg,
                                      chunk=chunk, **kwargs)
        else:
            outs = []
            for i in range(0, N, chunk):
                kw = dict(kwargs)
                n = min(chunk, N - i)
                e = kw.get("exposure")
                if e is not None:
                    kw["exposure"] = (e.reshape(1, 1).expand(n, 1)
                                      if e.ndim == 0 or e.shape[0] == 1
                                      else e[i:i + chunk])
                if kw.get("mesh_depth_map") is not None:
                    kw["mesh_depth_map"] = kw["mesh_depth_map"][i:i + chunk]
                outs.append(render_test_chunk(params, grid_state,
                                              rays_o[i:i + chunk],
                                              rays_d[i:i + chunk], cfg, **kw))
            result = {k: torch.cat([o[k] for o in outs])
                      for k in ("opacity", "depth", "rgb")}
            result["total_samples"] = sum(o["total_samples"] for o in outs)

        if blend_bkg and (im_bkg is not None or sh_bkg is not None):
            # the image background wins where both are given
            rgb_bg = im_bkg if im_bkg is not None else \
                get_sh_val(sh_bkg, rays_d, clamp_positive=True)
            result["rgb"] = result["rgb"] \
                + rgb_bg * (1.0 - result["opacity"][:, None])
        return result


def render_surface_normal(params, pts, cfg: NGPConfig):
    """Surface normals as the negative normalized density gradient
    (arnerf_tpu/rendering.py:652-665; reference models/rendering.py:300-313).
    pts: (..., 3) -> (..., 3).

    The gradient is taken with respect to the positions only: every
    parameter is detached, so the hash-grid backward computes d_x and never
    the table gradient (no segment sum runs). Points are independent, so
    chunks of 2^18 rows bound memory without changing any result."""
    frozen = _detached(params)
    flat = pts.reshape(-1, 3)
    chunk = 1 << 18
    grads = []
    for i in range(0, flat.shape[0], chunk):
        x = flat[i:i + chunk].detach().requires_grad_(True)
        with torch.enable_grad():
            sigma = ngp_density(frozen, x, cfg)
            (g,) = torch.autograd.grad(sigma.sum(), x)
        grads.append(g)
    g = torch.nan_to_num(torch.cat(grads), nan=0.0, posinf=1.0, neginf=-1.0)
    normals = -g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-6)
    return normals.reshape(pts.shape)


@torch.no_grad()
def render_surface_rgb(params, pts, rays_d, cfg: NGPConfig, **kwargs):
    """Radiance emitted at surface points toward given directions
    (arnerf_tpu/rendering.py:668-674; reference models/rendering.py:315-320).
    """
    _, rgbs = ngp_forward(params, pts.reshape(-1, 3), rays_d.reshape(-1, 3),
                          cfg, **kwargs)
    return rgbs.reshape(*pts.shape[:-1], 3)


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()
