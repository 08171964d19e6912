"""Host ms a step inside the trainer's `train_step` span and the
`grid_update` span of that step (the program's tracer), mean over the
device part's steps. The device part runs under the profiler's CUDA
(CUPTI) tracing, which slows each launch, so this reads the host's pace
under that tracing, not the untraced pace of `train_ms_per_step`."""

from portbench import program


def read(t):
    tr, units = program.units(t, "train_step")
    if not units:
        return None
    return program.mean(tr.host_ms(("train_step", "grid_update"),
                                   units).values())
