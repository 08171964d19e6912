"""The f32 fused head's share of its roofline: the least time for the
samples the traced views marched (portbench/work.py) over the device time
of fused_head_f32_kernel."""

from portbench import work


def read(t):
    k = t.kernel_s("fused_head_f32_kernel")
    rows = t.counters.get("samples")
    if k is None or not rows:
        return None
    return 100.0 * work.head_bound_s(t.cfg, rows, bf16=False) / k[0]
