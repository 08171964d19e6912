"""What the program's own tracer recorded (arnerf_tpu_torch/utils/profiling.py),
for the per-layer readers of program spans and counters.

A traced run records its device part first, while the host runs untraced
by the profiler, so a reader takes the first `t.units` units the tracer
recorded under a root span ("train_step", "view"): those are the device
part's steps or views. The tracer is the process's, so on several cards
it is rank 0's. A checkout whose program has no tracer reads None.
"""


def tracer():
    """The program's tracer, or None where the program has none."""
    try:
        from arnerf_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    return TRACER


def units(t, root: str):
    """(tracer, the device part's units of `root` spans); (None, []) where
    nothing was recorded."""
    tr = tracer()
    if tr is None:
        return None, []
    return tr, tr.units(root, t.units)


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None
