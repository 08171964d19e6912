"""Model FLOPs of the traced views (the samples the marcher produced,
exact encode and MLPs, portbench/work.py) over the window at the float32
peak outside the tensor cores: views compute in float32."""

from portbench import work


def read(t):
    samples = t.counters.get("samples")
    if not samples or t.busy_s == 0:
        return None
    flops = work.view_flops(t.cfg, samples)
    return 100.0 * flops / (t.window_s * work.PEAKS["f32_flops_per_s"])
