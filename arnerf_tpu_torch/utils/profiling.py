"""The port's tracer, and its metrics sink (port of
arnerf_tpu/utils/profiling.py).

`span(name, unit)` is the one span of the port: it always opens a
`torch.profiler.record_function` range of that name, so a profile
attributes device time to it as before. While tracing is on it also
records a program span: name, unit id (a training step, a view ordinal),
its own id, the id of the span it opened inside, thread, and open and
close times. A span given no unit takes its enclosing span's. `count(name,
value)` adds to a counter of the enclosing span's unit: a host number, or
a device scalar kept as it is (no sync) until a reader asks, or a callable
that gives either, so that the work to make the value is done only while
tracing is on.

Tracing is on while a torch.profiler session runs
(`torch.autograd.profiler._is_profiler_enabled`), or inside `tracing()`.
Otherwise a span costs what `record_function` costs and records nothing,
and a counter does nothing.

The clock is the profiler's: Kineto stamps an event at epoch nanoseconds.
When tracing turns on the tracer takes one (time_ns, perf_counter_ns)
pair, and stamps spans at perf_counter_ns plus that offset, so that a step
of the wall clock while tracing cannot skew them. A span's stamps enclose
its record_function event, within microseconds once a profiler session has
opened its first range (that one spends a few hundred microseconds before
the event's own stamp); `device_trace` writes the program spans into the
same Chrome trace, on the timeline of the profiler's events.

The buffers are bounded (LIMIT records each, the oldest dropped first) and
hold what every traced window of a process recorded, until `reset()`.

`MetricsLogger` appends metrics to metrics.jsonl and, as the JAX
MetricsLogger does, to TensorBoard whenever torch.utils.tensorboard
imports. That import pulls in TensorFlow where it is installed, so it is
made at the first log(), not when a logger opens.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

LIMIT = 1 << 18

Span = collections.namedtuple(
    "Span", "name unit id parent tid start_ns end_ns")


class Tracer:
    """Program spans and counters of one process (see the module note)."""

    def __init__(self):
        self.spans = collections.deque(maxlen=LIMIT)
        self.counts = collections.deque(maxlen=LIMIT)
        self.explicit = 0           # open tracing() contexts
        self.was_on = False
        self.offset_ns = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    def on(self) -> bool:
        """Whether tracing is on; takes the clock pair as it turns on."""
        if self.explicit or _autograd_profiler._is_profiler_enabled:
            if not self.was_on:
                self.offset_ns = time.time_ns() - time.perf_counter_ns()
                self.was_on = True
            return True
        self.was_on = False
        return False

    def stack(self) -> list:
        """This thread's open spans. The thread's id is read once here:
        it is a system call, which costs microseconds in a sandbox."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            self._local.tid = threading.get_native_id()
        return st

    def unit(self):
        """The unit of the innermost open span of this thread."""
        st = self.stack()
        return st[-1].unit if st else None

    def reset(self):
        self.spans.clear()
        self.counts.clear()

    # -- readers --------------------------------------------------------

    def units(self, root: str, n: int = None) -> list:
        """The first `n` (all: None) distinct units of spans named `root`,
        in the order they opened."""
        out, seen = [], set()
        for s in sorted((s for s in self.spans if s.name == root),
                        key=lambda s: s.start_ns):
            if s.unit not in seen:
                seen.add(s.unit)
                out.append(s.unit)
        return out if n is None else out[:n]

    def host_ms(self, names, units) -> dict:
        """{unit: host ms inside spans of `names`} over `units`."""
        want = set(units)
        out = dict.fromkeys(units, 0.0)
        for s in self.spans:
            if s.name in names and s.unit in want:
                out[s.unit] += (s.end_ns - s.start_ns) * 1e-6
        return out

    def counter(self, name: str, units) -> dict:
        """{unit: total} of counter `name` over `units` (0 where nothing
        was counted). Device scalars are read here, one copy a device."""
        want = set(units)
        out = dict.fromkeys(units, 0.0)
        dev = collections.defaultdict(list)
        for c_name, unit, value in list(self.counts):
            if c_name != name or unit not in want:
                continue
            if torch.is_tensor(value):
                dev[value.device].append((unit, value))
            else:
                out[unit] += value
        for vals in dev.values():
            read = torch.stack([v.reshape(()).to(torch.float64)
                                for _, v in vals]).tolist()
            for (unit, _), x in zip(vals, read):
                out[unit] += x
        return out


class _Open:
    """A program span while it is open."""
    __slots__ = ("tracer", "name", "unit", "id", "parent", "rf", "t0")

    def __init__(self, tracer, name, unit):
        self.tracer, self.name, self.unit = tracer, name, unit

    def __enter__(self):
        st = self.tracer.stack()
        up = st[-1] if st else None
        self.parent = None if up is None else up.id
        if self.unit is None and up is not None:
            self.unit = up.unit
        self.id = next(self.tracer._ids)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr.stack().pop()
        tr.spans.append(Span(self.name, self.unit, self.id, self.parent,
                             tr._local.tid, self.t0 + tr.offset_ns,
                             t1 + tr.offset_ns))
        return False


TRACER = Tracer()
_VIEWS = itertools.count()


def span(name: str, unit=None):
    """A record_function range of `name`; while tracing is on, also a
    program span of `unit` (None: the enclosing span's)."""
    if TRACER.on():
        return _Open(TRACER, name, unit)
    return record_function(name)


def count(name: str, value):
    """Add `value` (a number, a device scalar, or a callable giving one) to
    counter `name` of the enclosing span's unit, while tracing is on."""
    if TRACER.on():
        if callable(value):
            value = value()
        if torch.is_tensor(value):
            value = value.detach()
        TRACER.counts.append((name, TRACER.unit(), value))


def next_view() -> int:
    """The process's next view ordinal (the `view` span's unit)."""
    return next(_VIEWS)


@contextlib.contextmanager
def tracing():
    """Trace the block without a profiler session (for operators and
    tools that read the program spans themselves)."""
    TRACER.explicit += 1
    try:
        yield
    finally:
        TRACER.explicit -= 1


@contextlib.contextmanager
def device_trace(logdir="traces"):
    """Profile the block's CPU and CUDA activity; on exit write
    logdir/trace.json (chrome://tracing, Perfetto) with the program spans
    the block recorded on the same timeline. Yields the profiler, whose
    key_averages() summarise the spans."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time_ns()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    # Kineto writes microseconds after baseTimeNanoseconds, where it has one
    base, pid = trace.get("baseTimeNanoseconds", 0), os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid,
         "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"unit": s.unit, "id": s.id, "parent": s.parent}}
        for s in TRACER.spans if s.start_ns >= t0)
    with open(path, "w") as f:
        json.dump(trace, f)


class MetricsLogger:
    """JSONL + TensorBoard metrics sink (the reference's Lightning
    TensorBoardLogger, train.py:277-279): logdir/metrics.jsonl gets one
    {"step": ..., name: value, ...} line per log() call, appended, and
    logdir the same scalars as TensorBoard events when
    torch.utils.tensorboard imports (tried once, at the first log())."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None             # None: not tried yet; False: no import

    def log(self, step, metrics: dict):
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(self.logdir)
            except ImportError:
                self._tb = False
        if self._tb:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb:
            self._tb.close()
