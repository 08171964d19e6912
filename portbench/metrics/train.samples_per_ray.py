"""Samples a ray demanded (the trainer's rm_s counter), mean over the traced
blocks' last steps."""


def read(t):
    rm = t.counters.get("rm_s")
    return sum(rm) / len(rm) if rm else None
