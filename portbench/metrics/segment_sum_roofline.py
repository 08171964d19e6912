"""The segment sum's share of its roofline: the least time for the table
updates the traced steps' backward needs (one a level of each demanded
sample, portbench/work.py) over the device time of segment_sum_kernel."""

from portbench import work


def read(t):
    k = t.kernel_s("segment_sum_kernel")
    samples = t.counters.get("samples")
    if k is None or not samples:
        return None
    updates = samples * t.cfg["n_levels"]
    return 100.0 * work.segment_sum_bound_s(t.cfg, updates) / k[0]
