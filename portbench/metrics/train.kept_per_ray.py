"""Samples a ray the march's buffer kept (the `samples_kept` counter: its
allocated slots), every step of the device part over its rays (the cell's
batch a rank)."""

from portbench import program


def read(t):
    tr, units = program.units(t, "train_step")
    if not units:
        return None
    kept = tr.counter("samples_kept", units)
    if not any(kept.values()):
        return None
    return program.mean(kept.values()) / t.cfg["batch_size"]
