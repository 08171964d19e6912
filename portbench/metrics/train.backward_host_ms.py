"""Host ms a step inside the `backward` span (the hash-grid backward, the
segment sum, the MLP gradients: what the host spends launching them),
mean over the device part's steps. As `train.host_ms`, it reads the
host's pace under the device part's CUDA (CUPTI) tracing."""

from portbench import program


def read(t):
    tr, units = program.units(t, "train_step")
    if not units:
        return None
    return program.mean(tr.host_ms(("backward",), units).values())
