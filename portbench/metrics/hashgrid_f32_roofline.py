"""The f32 exact hash-grid encode's share of its roofline: the least time
for the samples the traced views marched over the device time of
hashgrid_encode_f32_kernel. Per sample, L levels x 8 corners of a weight
(2 products) and F multiply-adds, and 12 B of position read and L*F f32
features written; the table is left out, as the head's bound leaves out
its weights. None where the kernel did not run."""

from portbench import work


def read(t):
    k = t.kernel_s("hashgrid_encode_f32_kernel")
    rows = t.counters.get("samples")
    if k is None or not rows:
        return None
    L, F = t.cfg["n_levels"], t.cfg["n_features"]
    bound_s = rows * max(
        L * 8 * (2 + 2 * F) / work.PEAKS["f32_flops_per_s"],
        (12 + 4 * L * F) / work.PEAKS["hbm_bytes_per_s"])
    return 100.0 * bound_s / k[0]
