"""The bf16 fused head's share of its roofline: the least time for the rows
the traced steps demanded (portbench/work.py) over the device time of
fused_head_tc_kernel."""

from portbench import work


def read(t):
    k = t.kernel_s("fused_head_tc_kernel")
    rows = t.counters.get("samples")
    if k is None or not rows:
        return None
    return 100.0 * work.head_bound_s(t.cfg, rows, bf16=True) / k[0]
