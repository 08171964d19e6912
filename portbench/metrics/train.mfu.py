"""Model FLOPs of the traced training steps (the samples they demanded and
the grid updates' cells, portbench/work.py) over the window at the bf16
peak: training computes in bf16 on the card."""

from portbench import work


def read(t):
    samples = t.counters.get("samples")
    if not samples or t.busy_s == 0:
        return None
    flops = work.train_flops(t.cfg, samples, t.counters.get("grid_cells", 0))
    return 100.0 * flops / (t.window_s * work.PEAKS["bf16_flops_per_s"])
