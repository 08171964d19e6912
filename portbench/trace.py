"""Reading torch.profiler traces of the measured window: device busy time,
the device time under the program's record_function spans, kernel time by
name, and the breakdown (top device operations, longest idle gaps by the
host operation that was open in their middle).

A traced window has two parts. The first traces the device alone, so the
tracer costs the host next to nothing: busy time, the idle share and the
kernels' times come from it. The second traces the host too: the spans
and the idle gaps' host operations come from it. Busy time is the union
of the device intervals, so overlapping streams count once; idle share =
1 - busy / wall of the device part (CUDA events).

A span's device time is that of the kernels launched by host operations
that start inside the span, on any thread: the autograd engine runs a
backward's operations on a thread of its own.
"""

import bisect
from collections import defaultdict

# record_function spans of the port (training/trainer.py, rendering.py)
SPANS = ("sample", "loss", "backward", "join", "adam", "grid_update",
         "first_hit", "march", "field", "composite")


def _split(events):
    from torch.autograd import DeviceType
    events = list(events)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in SPANS
           and not getattr(e, "is_user_annotation", False)]
    return cpu, dev


class Trace:
    """The summary per-layer readers see. `device` is (events, wall s,
    units) of the device part, `host` (events, units) of the host part;
    `counters` are what the driver counted over the device part's units
    (program counters), `cfg` the configuration file's dict."""

    def __init__(self, device, host, counters: dict, cfg: dict):
        events, self.window_s, self.units = device
        self.counters, self.cfg = counters, cfg
        _, self._dev = _split(events)
        self._by_kernel = defaultdict(lambda: [0.0, 0])
        for e in self._dev:
            k = self._by_kernel[e.name]
            k[0] += e.time_range.elapsed_us() * 1e-6
            k[1] += 1
        self._merged = self._merge([(e.time_range.start, e.time_range.end)
                                    for e in self._dev])
        self.busy_s = sum(b - a for a, b in self._merged) * 1e-6
        h_events, self.host_units = host
        self._cpu, h_dev = _split(h_events)
        self._h_merged = self._merge([(e.time_range.start, e.time_range.end)
                                      for e in h_dev])
        self._spans = self._span_us(self._cpu)

    @classmethod
    def of(cls, device_prof, wall_s, units, host_prof, host_units, counters,
           cfg):
        """The Trace of two finished torch.profiler.profile objects."""
        return cls((device_prof.events(), wall_s, units),
                   (host_prof.events(), host_units), counters, cfg)

    @staticmethod
    def _merge(intervals):
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @staticmethod
    def _span_us(cpu):
        """{span: device us of kernels launched from inside it}."""
        out = {}
        for name in SPANS:
            iv = Trace._merge([(e.time_range.start, e.time_range.end)
                               for e in cpu if e.name == name])
            if not iv:
                continue
            starts = [a for a, _ in iv]
            total = 0.0
            for e in cpu:
                ks = getattr(e, "kernels", ())
                if not ks or e.name in SPANS:
                    continue
                i = bisect.bisect_right(starts, e.time_range.start) - 1
                if i >= 0 and e.time_range.start <= iv[i][1]:
                    total += sum(k.duration for k in ks)
            out[name] = total
        return out

    def span_ms(self, *names):
        """Device ms under the named spans a unit of the host part, summed
        over the names, in units of the device part; None where no span of
        those names was traced or no device time was."""
        if self.busy_s == 0 or not any(n in self._spans for n in names):
            return None
        return sum(self._spans.get(n, 0.0) for n in names) / 1e3 \
            * self.units / self.host_units

    def kernel_s(self, fragment: str):
        """(device seconds, launches) of kernels whose name holds
        `fragment`, or None where none ran."""
        hits = [v for k, v in self._by_kernel.items() if fragment in k]
        if not hits:
            return None
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": [[name, s]...], "idle_gaps": [[host op, s]...]}:
        device time by operation name (device part), and the host part's
        idle gaps between device intervals summed by the innermost host
        operation open at the gap's middle."""
        ops = sorted(((k, v[0]) for k, v in self._by_kernel.items()),
                     key=lambda kv: -kv[1])[:top]
        m = self._h_merged
        gaps = [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)]
        gaps = sorted(sorted(gaps, key=lambda g: g[0] - g[1])[:400],
                      key=lambda g: g[0] + g[1])
        cpu = sorted(((e.time_range.start, e.time_range.end, e.name)
                      for e in self._cpu), key=lambda c: c[0])
        by_host = defaultdict(float)
        active, i = [], 0
        for a, b in gaps:             # a sweep: events open at each middle
            mid = (a + b) / 2
            while i < len(cpu) and cpu[i][0] <= mid:
                active.append(cpu[i])
                i += 1
            active = [c for c in active if c[1] >= mid]
            inner = min(active, key=lambda c: c[1] - c[0], default=None)
            by_host[inner[2] if inner else "(no host op)"] += (b - a) * 1e-6
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def start(dev, host: bool):
    """Start one part of a traced window: the device alone, or with `host`
    the host too; the wall starts at a CUDA event (the host clock on the
    CPU)."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    if host or not acts:
        acts = [ProfilerActivity.CPU] + acts
    prof = profile(activities=acts)
    prof.start()
    ev = None
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
    return prof, ev, time.perf_counter()


def stop(dev, part):
    """End a part started by start(): (profiler, wall seconds)."""
    import time
    import torch
    prof, ev, t0 = part
    wall = time.perf_counter() - t0
    if ev is not None:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
        torch.cuda.synchronize(dev)
        wall = ev.elapsed_time(ev1) / 1e3
    prof.stop()
    return prof, wall
