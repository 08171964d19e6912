"""GB/s of the join: the logical bytes a step handed to the collectives
(the `join_bytes` counter of the trainer's join, from the bytes
parallel/accounting.py counts) over the device ms a step under the `join`
span."""

from portbench import program


def read(t):
    tr, units = program.units(t, "train_step")
    ms = t.span_ms("join")
    if not units or not ms:
        return None
    moved = program.mean(tr.counter("join_bytes", units).values())
    if not moved:
        return None
    return moved / (ms / t.units * 1e-3) / 1e9
