"""The port's tracer (arnerf_tpu_torch/utils/profiling.py) and the
benchmark's readers of it (portbench/metrics/, portbench/program.py), on
the CPU.

- Spans nest, carry the unit of their step or view, and record nothing
  with tracing off; the trainer's and the renderer's spans and counters
  land under the units they belong to, and a view's host reads are its
  `host_read` spans.
- Counters launch no tensor operation and no sync with tracing off, and
  no sync with it on.
- A span's stamps sit within 100 us of its own record_function event on
  the profiler's clock, and device_trace() writes the program spans into
  its Chrome trace with their ids.
- The new span names stay out of portbench.trace's device events and
  leave every layer span's device time as it was; the benchmark's metrics
  that existed before the tracer read on the tiny cells what they read
  with the program's spans as they were.
- The five per-layer metrics that read the tracer read finite values on
  the tiny cells (portbench/tests/tiny.py) with trace=1, the four-rank
  cell on gloo ranks; the join's GB/s needs device time, which a CPU trace
  has not, and reads None there.
- samples_kept is the march buffer's valid slots.
"""

import contextlib
import json
import math
import multiprocessing as mp
import socket
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset,
                                                 analytic_occupancy)
from arnerf_tpu_torch.datasets.ray_utils import get_rays
from arnerf_tpu_torch.models.ngp import NGPConfig, grid_state_init, ngp_init
from arnerf_tpu_torch.ops import marching
from arnerf_tpu_torch.rendering import (default_candidates, render_test,
                                        scene_hits)
from arnerf_tpu_torch.training.trainer import NeRFTrainer, TrainConfig
from arnerf_tpu_torch.utils import profiling
from portbench import harness
from portbench import trace as bench_trace
from portbench.tests import tiny

SMALL = dict(grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)
NEW_METRICS = {"synthetic_train": ("train.host_ms", "train.backward_host_ms",
                                   "train.kept_per_ray"),
               "synthetic_view": ("view.host_reads",),
               "unbounded_train_dp4": ("train.host_ms",
                                       "train.backward_host_ms",
                                       "train.kept_per_ray")}


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.TRACER.reset()
    yield profiling.TRACER
    profiling.TRACER.reset()


def test_spans_nest_and_carry_their_unit():
    tr = profiling.TRACER
    with profiling.span("train_step", unit=7):
        with profiling.span("sample"):
            pass
    assert len(tr.spans) == 0                     # tracing off: nothing
    with profiling.tracing():
        with profiling.span("train_step", unit=7):
            with profiling.span("backward"):
                with profiling.span("host_read"):
                    profiling.count("samples_kept", 5)
        with profiling.span("view", unit=3):
            with profiling.span("march"):
                pass
    by = {s.name: s for s in tr.spans}
    assert [s.name for s in tr.spans] == ["host_read", "backward",
                                          "train_step", "march", "view"]
    assert by["train_step"].parent is None and by["view"].parent is None
    assert by["backward"].parent == by["train_step"].id
    assert by["host_read"].parent == by["backward"].id
    assert by["march"].parent == by["view"].id
    assert {by[n].unit for n in ("train_step", "backward", "host_read")} \
        == {7}
    assert by["march"].unit == 3
    for s in tr.spans:
        assert s.start_ns <= s.end_ns
    assert by["train_step"].start_ns <= by["backward"].start_ns \
        <= by["host_read"].start_ns <= by["host_read"].end_ns \
        <= by["backward"].end_ns <= by["train_step"].end_ns
    assert tr.units("train_step") == [7] and tr.units("view", 5) == [3]
    assert tr.counter("samples_kept", [7, 3]) == {7: 5.0, 3: 0.0}
    with profiling.span("view", unit=4):          # off again
        profiling.count("samples_kept", 1)
    assert len(tr.spans) == 5 and len(tr.counts) == 1


class _Ops(TorchDispatchMode):
    """The aten operations run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_counters_do_no_tensor_work_when_off():
    x = torch.arange(12, dtype=torch.int64)
    first = x[0]
    called = []

    def value():
        called.append(1)
        return x.sum()
    with _Ops() as seen:
        profiling.count("samples_kept", value)
        profiling.count("samples_kept", x.sum)
        profiling.count("samples_kept", first)
        profiling.count("join_bytes", 64)
    assert seen.ops == [] and called == [] and len(profiling.TRACER.counts) \
        == 0
    with profiling.tracing(), profiling.span("train_step", unit=0):
        with _Ops() as seen:
            profiling.count("samples_kept", x.sum)
            profiling.count("join_bytes", 64)
    # the reduction is made; nothing is read back to the host
    assert "aten.sum.default" in seen.ops
    assert set(seen.ops) <= {"aten.sum.default", "aten.detach.default"}
    tr = profiling.TRACER
    assert tr.counter("samples_kept", [0]) == {0: 66.0}
    assert tr.counter("join_bytes", [0, 1]) == {0: 64.0, 1: 0.0}


def _abs_ns(prof, e):
    base = prof.profiler.kineto_results.trace_start_ns()
    return base + 1e3 * e.time_range.start, base + 1e3 * e.time_range.end


def test_span_stamps_sit_on_the_profiler_clock(tmp_path):
    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):                        # first-call costs
            with profiling.span("warm"):
                (a @ a).sum()
        for i in range(4):
            with profiling.span("train_step", unit=i):
                with profiling.span("backward"):
                    (a @ a).sum()
    spans = [s for s in profiling.TRACER.spans if s.name != "warm"]
    assert len(spans) == 8
    events = {}
    for e in prof.events():
        if e.name in ("train_step", "backward"):
            events.setdefault(e.name, []).append(e)
    for name in ("train_step", "backward"):
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start_ns)
        theirs = sorted(events[name], key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs) == 4
        for s, e in zip(mine, theirs):
            t0, t1 = _abs_ns(prof, e)
            assert abs(s.start_ns - t0) < 1e5, (name, s.start_ns - t0)
            assert abs(s.end_ns - t1) < 1e5, (name, s.end_ns - t1)
    assert [s.unit for s in spans if s.name == "backward"] == [0, 1, 2, 3]


def test_device_trace_writes_the_program_spans(tmp_path):
    a = torch.ones(64, 64)
    with profiling.device_trace(str(tmp_path / "tr")):
        for i in range(3):                        # a session's first ranges
            with profiling.span("warm"):
                (a @ a).sum()
        for i in range(3):
            with profiling.span("view", unit=10 + i):
                with profiling.span("field"):
                    (a @ a).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    evs = events["traceEvents"]
    program = [e for e in evs if e.get("cat") == "program"]
    assert sorted(e["args"]["unit"] for e in program
                  if e["name"] == "view") == [10, 11, 12]
    ids = {e["args"]["id"]: e for e in program}
    for e in program:
        if e["name"] == "field":
            up = ids[e["args"]["parent"]]
            assert up["name"] == "view"
            assert up["args"]["unit"] == e["args"]["unit"]
    # on the profiler's timeline: each program span beside its own
    # record_function event, within 100 us
    annotated = sorted((e for e in evs if e.get("cat") == "user_annotation"
                        and e["name"] == "view"), key=lambda e: e["ts"])
    mine = sorted((e for e in program if e["name"] == "view"),
                  key=lambda e: e["ts"])
    assert len(annotated) == 3
    for p, u in zip(mine, annotated):
        assert abs(p["ts"] - u["ts"]) < 100
        assert abs((p["ts"] + p["dur"]) - (u["ts"] + u["dur"])) < 100
        assert p["tid"] == u["tid"]


def _event(name, device, annotation):
    return FunctionEvent(id=0, name=name, thread=0, start_us=0, end_us=5,
                         device_type=device, is_user_annotation=annotation)


@pytest.mark.parametrize("name", ["train_step", "view", "host_read",
                                  "grid_update"])
def test_new_span_names_are_not_device_events(name):
    """A span's range as the card's timeline shows it (a user annotation
    of the device) is no kernel; the kernel beside it is."""
    events = [_event(name, DeviceType.CUDA, True),
              _event(name, DeviceType.CPU, True),
              _event("fused_head_tc_kernel", DeviceType.CUDA, False)]
    cpu, dev = bench_trace._split(events)
    assert [e.name for e in dev] == ["fused_head_tc_kernel"]
    assert len(cpu) == 1


def _host(name, start, end, kernel_us=()):
    """A host event of the host part as portbench.trace reads it."""
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        kernels=[types.SimpleNamespace(duration=d) for d in kernel_us])


# a step's layer spans and the operations launched inside them (us)
_STEP = [_host("sample", 0, 10), _host("aten::randint", 1, 2, (3,)),
         _host("march", 10, 30), _host("aten::sort", 12, 14, (7, 2)),
         _host("aten::nonzero", 20, 22, (1,)),
         _host("field", 30, 50), _host("fused_head", 31, 33, (11,)),
         _host("backward", 50, 80), _host("aten::mm", 55, 56, (5,)),
         _host("join", 80, 90), _host("nccl:all_reduce", 81, 82, (9,)),
         _host("aten::add", 95, 96, (4,))]           # under no layer span


@pytest.mark.parametrize("new", [
    [_host("train_step", 0, 92), _host("train_step", 92, 99)],
    [_host("view", 0, 99), _host("host_read", 19, 23)],
    [_host("host_read", 94, 97), _host("host_read", 54, 57)],
], ids=["train_step", "view", "host_read"])
def test_new_spans_leave_layer_device_times_alone(new):
    """The step, view and host-read ranges, around layer spans or inside
    them, move no span's device time in portbench.trace."""
    before = bench_trace.Trace._span_us(_STEP)
    after = bench_trace.Trace._span_us(_STEP + new)
    assert after == before
    assert before == {"sample": 3, "march": 10, "field": 11, "backward": 5,
                      "join": 9}


def _tiny_line(name):
    c = tiny.cell(name)
    c.limits = {}
    profiling.TRACER.reset()
    return tiny.run(c, trace=1)


_TRACED = {}


def _traced(name):
    """A tiny cell's traced run, made once for this module: (result line,
    the units the tracer recorded in the device part, the driver's device
    part's unit count, train.join_gbps as read right after the run)."""
    if name not in _TRACED:
        line, out = _tiny_line(name)
        t = out["trace"]
        root = "view" if name == "synthetic_view" else "train_step"
        _TRACED[name] = (line, profiling.TRACER.units(root, t.units),
                         t.units, harness.reader("train.join_gbps")(t))
    return _TRACED[name]


def _as_before(name, unit=None):
    """The program's spans as they were before the tracer: the layer spans
    as record_function ranges, no step, view or host-read spans."""
    if name in ("train_step", "view", "host_read"):
        return contextlib.nullcontext()
    return record_function(name)


@pytest.mark.parametrize("name", ["synthetic_train", "synthetic_view"])
def test_existing_metrics_read_as_before(name, monkeypatch):
    c = tiny.cell(name)
    new = {m for m in NEW_METRICS[name]}
    old = [m["name"] for m in c.per_layer if m["name"] not in new]
    line = _traced(name)[0]
    monkeypatch.setattr(profiling, "span", _as_before)
    monkeypatch.setattr(profiling, "count", lambda name, value: None)
    before, _ = _tiny_line(name)
    now = {k: v for k, v in line["metrics"].items() if k in old}
    assert set(now) == set(before["metrics"])
    for k in ("train.samples_per_ray",):
        if k in now:
            assert now[k] == before["metrics"][k]


@pytest.mark.parametrize("name", ["synthetic_train", "synthetic_view"])
def test_new_metrics_read_on_the_tiny_cells(name):
    line, units, n, join_gbps = _traced(name)
    for m in NEW_METRICS[name]:
        v = line["metrics"][m]["value"]
        assert math.isfinite(v) and v > 0, (m, v)
    # the device part's steps or views, as many as the driver counted
    assert len(units) == n and units == sorted(units)
    if name == "synthetic_train":
        kept = line["metrics"]["train.kept_per_ray"]["value"]
        assert kept <= line["metrics"]["train.samples_per_ray"]["value"]
        assert line["metrics"]["train.backward_host_ms"]["value"] < \
            line["metrics"]["train.host_ms"]["value"]
        assert join_gbps is None         # no device time in a CPU trace


def _rank_traced(name, rank, world, port, seed, queue):
    """One rank of a cell on gloo with trace=1; rank 0 sends its result
    line and the join bytes its tracer counted a step."""
    import os
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), PORTBENCH_RANK=str(rank),
                      OMP_NUM_THREADS="1")
    torch.set_num_threads(1)
    line, out = tiny.run(tiny.cell(name), seed=seed, trace=1,
                         ranks=harness.Ranks(world, []))
    if rank == 0:
        tr = profiling.TRACER
        units = tr.units("train_step", out["trace"].units)
        queue.put((line, tr.counter("join_bytes", units),
                   harness.reader("train.join_gbps")(out["trace"])))


def test_new_metrics_read_on_four_gloo_ranks():
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_traced,
                         args=("unbounded_train_dp4", r, 4, port,
                               2 ** 31 + 11, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        line, joined, gbps = q.get(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert not any(p.is_alive() for p in procs)
    for m in NEW_METRICS["unbounded_train_dp4"]:
        v = line["metrics"][m]["value"]
        assert math.isfinite(v) and v > 0, (m, v)
    # one all-reduce of the gradients and metrics and one max a step, the
    # same bytes every step
    assert len(set(joined.values())) == 1 and min(joined.values()) > 0
    assert gbps is None and "train.join_gbps" not in line["metrics"]


def _march_inputs(n=512, scale=0.5, seed=0):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([1.2 * np.cos(th), rng.uniform(-0.4, 0.2, n),
                  1.2 * np.sin(th)], 1) * (scale / 0.5)
    d = rng.uniform(-0.3, 0.3, (n, 3)) * scale - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cfg = NGPConfig(scale=scale, **SMALL)
    o, d = torch.tensor(o, dtype=torch.float32), torch.tensor(
        d, dtype=torch.float32)
    occ = analytic_occupancy(scale, cfg.grid_size, cfg.cascades)
    kw = dict(scale=scale, cascades=cfg.cascades, exp_step_factor=0.0,
              grid_size=cfg.grid_size, max_samples=1024,
              n_candidates=default_candidates(cfg, 0.0), s_cap=1024)
    noise = torch.tensor(rng.random(n), dtype=torch.float32)
    return o, d, scene_hits(o, d, cfg), occ, noise, kw


@pytest.mark.parametrize("pooled,m_cap", [(False, 40000), (False, 3000),
                                          (True, 40000), (True, 3000)])
def test_samples_kept_is_the_buffers_valid_slots(pooled, m_cap):
    o, d, hits, occ, noise, kw = _march_inputs()
    r = marching.coarse_dilation_radius(
        scale=kw["scale"], exp_step_factor=0.0, grid_size=kw["grid_size"],
        max_samples=kw["max_samples"])
    occ_c = marching.build_coarse_occupancy(occ, kw["cascades"],
                                            kw["grid_size"], dilate=r)
    with profiling.tracing(), profiling.span("train_step", unit=0):
        if pooled:
            mr = marching.march_rays_train_pooled(
                o, d, hits, occ, noise, m_cap=m_cap, occ_coarse=occ_c,
                seg_pool_cap=900 if m_cap == 3000 else 512 * 16, **kw)
        else:
            mr = marching.march_rays_train(o, d, hits, occ, noise,
                                           m_cap=m_cap, seg_cap=64,
                                           occ_coarse=occ_c, **kw)
    tr = profiling.TRACER
    kept = tr.counter("samples_kept", [0])[0]
    assert kept == int(mr.valid.sum()) > 0
    assert kept <= int(mr.rm_samples)
    if not pooled and m_cap == 3000:              # the buffer strides
        assert kept < int(mr.rm_samples)


def _tiny_trainer():
    scfg = SyntheticConfig(img_wh=(24, 24), n_train=6, n_test=1,
                           gt_samples=64)
    tc = TrainConfig(batch_size=128, lr=1e-2, num_epochs=1,
                     steps_per_epoch=64, warmup_steps=16,
                     samples_per_ray_budget=16, seg_cap=8)
    return NeRFTrainer(NGPConfig(scale=0.5, **SMALL), tc,
                       SyntheticDataset(split="train", config=scfg),
                       seed=0)


def test_fit_records_steps_grid_updates_and_block_reads():
    import chip_smoke
    tr = _tiny_trainer()
    with profiling.tracing():
        tr.fit(n_steps=32, log_every=0)
    t = profiling.TRACER
    assert t.units("train_step") == list(range(32))
    by = {}
    for s in t.spans:
        by.setdefault(s.name, []).append(s)
    assert sorted(s.unit for s in by["grid_update"]) == [0, 16]
    assert sorted(s.unit for s in by["host_read"]) == [15, 31]
    roots = {s.id: s for s in by["train_step"]}
    for name in ("sample", "loss", "backward", "adam", "march", "field",
                 "composite"):
        assert len(by[name]) == 32, name
        for s in by[name]:
            up = s
            while up.parent is not None and up.id not in roots:
                up = next(x for x in t.spans if x.id == up.parent)
            assert up.id in roots and roots[up.id].unit == s.unit, name
    assert all(s.parent is None for s in by["grid_update"]
               + by["host_read"])
    ms = t.host_ms(("train_step", "grid_update"), range(32))
    assert all(v > 0 for v in ms.values())
    kept = t.counter("samples_kept", range(32))
    assert all(0 < v <= 128 * 16 for v in kept.values())
    # chip_smoke's block seconds: grid update to the block's read
    blocks = chip_smoke.block_seconds(tr)
    assert [(f, w) for f, _, w in blocks] == [(0, True), (16, False)]
    assert all(0 < s < 60 for _, s, _ in blocks)


def test_views_count_their_rounds_and_host_reads():
    cfg = NGPConfig(scale=0.5, **SMALL)
    params = ngp_init(cfg, torch.Generator().manual_seed(0), "cpu")
    occ = analytic_occupancy(0.5, cfg.grid_size, cfg.cascades)
    state = grid_state_init(cfg, "cpu")._replace(occ_flat=occ)
    ds = SyntheticDataset(split="test", config=SyntheticConfig(
        img_wh=(24, 24), n_train=1, n_test=2, gt_samples=8))
    ro, rd = get_rays(torch.as_tensor(ds.directions),
                      torch.as_tensor(ds.poses[0]))
    with profiling.tracing():
        for fast in (True, False):
            render_test(params, state, ro, rd, cfg, fast=fast,
                        max_samples=96, chunk=256)
    t = profiling.TRACER
    views = t.units("view")
    assert len(views) == 2 and views[1] == views[0] + 1
    for v in views:
        spans = [s for s in t.spans if s.unit == v]
        reads = [s for s in spans if s.name == "host_read"]
        marches = [s for s in spans if s.name == "march"]
        # a round's live-ray test precedes each round, and more reads end
        # the loop and read the sample total
        assert len(reads) > len(marches) > 0
        assert all(s.parent is not None for s in spans
                   if s.name != "view")
    # view.host_reads reads the host_read spans a view
    t_view = type("T", (), {"units": 2})()
    n_reads = sum(s.name == "host_read" for s in t.spans)
    assert harness.reader("view.host_reads")(t_view) == n_reads / 2
    # the fast path's pre-pass reads once a pass of each chunk
    fast = [s for s in t.spans if s.unit == views[0]]
    assert any(s.name == "first_hit" for s in fast)
