"""Tracing and timing helpers (port of arnerf_tpu/utils/profiling.py):
`device_trace` records a torch.profiler trace of the CPU and, where there is
one, the card, and writes it as a Chrome trace; `StepTimer` is an EMA
wall-clock timer; `MetricsLogger` appends metrics to metrics.jsonl and,
as the JAX MetricsLogger does, to TensorBoard whenever
torch.utils.tensorboard imports. That import pulls in TensorFlow where it
is installed, so it is made at the first log(), not when a logger opens.
"""

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def device_trace(logdir="traces"):
    """Profile the block's CPU and CUDA activity; on exit write
    logdir/trace.json (chrome://tracing, Perfetto). Yields the profiler,
    whose key_averages() summarise the spans."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock EMA timer for hot loops (the reference's time.time()
    bracketing, show_gui.py:73-99, with smoothing). The time of a block
    that launches card work ends at its launches, not at their end: sync
    inside the block to time the card."""

    def __init__(self, alpha=0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt

    @property
    def fps(self):
        return 1.0 / self.ema if self.ema else 0.0


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
