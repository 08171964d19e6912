"""Front-to-back volume compositing (port of arnerf_tpu/ops/composite.py;
the reference's composite_train_fw/bw and composite_test_fw kernels,
models/csrc/volumerendering.cu:5-284).

A sample contributes iff the transmittance BEFORE it exceeds T_threshold,
which matches the reference loop that breaks after the first sample whose
post-update transmittance drops to or below the threshold.

`composite_train` works on the marchers' compact buffer, where each ray's
samples are contiguous: a per-ray prefix sum is a global cumsum minus the
value at the ray's segment start (per-ray totals are summed ray by ray,
see `_ray_totals`), and autograd derives the backward that the reference
writes by hand. That prefix sum runs in float64 over optical depths capped
at SD_CAP (see `composite_train`).
"""

from typing import NamedTuple

import torch

# the largest optical depth a sample enters the transmittance prefix sum
# with: exp(-SD_CAP) is 0 in float32 (as is exp(-x) for x > 104), so every
# transmittance and gradient keeps its float32 value, and an infinite
# density no longer turns the difference of two sums into inf - inf
SD_CAP = 1e4


class CompositeResults(NamedTuple):
    opacity: torch.Tensor      # (N,)
    depth: torch.Tensor        # (N,)
    rgb: torch.Tensor          # (N, 3)
    ws: torch.Tensor           # (M,) per-sample weights
    vr_samples: torch.Tensor   # () total contributing samples


def _segment_base(x_cum, ray_start, ray_idx):
    """Per-sample cumsum value at its segment's start (exclusive)."""
    start = ray_start[ray_idx]                                   # (M,)
    base = x_cum[torch.clamp(start - 1, min=0)]
    return torch.where(start > 0, base, torch.zeros_like(base))


def _ray_totals(x, ray_idx, valid, n_rays: int):
    """Per-ray sums of x (M,) or (M, k) over the valid samples.

    Summed ray by ray, where the JAX package takes the difference of a
    global cumsum at the segment's two ends. On the card that cumsum is a
    parallel scan, which rounds the two ends along different paths, so an
    all-zero segment can total -ulp(running sum): a negative opacity, whose
    log in the opacity loss is NaN. A direct sum of non-negative weights
    stays non-negative."""
    mask = valid.reshape(-1, *([1] * (x.ndim - 1)))
    out = torch.zeros((n_rays, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, ray_idx, torch.where(mask, x, 0.0))


def composite_train(sigmas, rgbs, deltas, ts, ray_idx, valid, ray_start,
                    counts, T_threshold: float) -> CompositeResults:
    """sigmas (M,), rgbs (M, 3), deltas/ts (M,), segment layout from the
    training marchers. Differentiable in sigmas and rgbs.

    The JAX package differences a float32 cumsum over the whole batch.
    Where densities are large, as an unbounded scene's far samples are
    (exp stepping makes deltas long), that running sum reaches 1e7 and
    more, its rounding error reaches tens, and a segment's difference
    comes out negative: a transmittance e^40 or inf, inf x 0 = NaN. The
    port takes the prefix sum in float64 (rounding 2^-29 of float32's), of
    depths capped at SD_CAP, then returns to float32."""
    fvalid = valid.to(sigmas.dtype)
    sd = sigmas * deltas * fvalid                  # optical depth per sample
    sd64 = torch.clamp(sd, max=SD_CAP).double()
    sd_cum = torch.cumsum(sd64, dim=0)
    sd_excl = (sd_cum - sd64 - _segment_base(sd_cum, ray_start, ray_idx)) \
        .to(sd.dtype)
    T_before = torch.exp(-sd_excl)
    alpha = 1.0 - torch.exp(-sd)
    included = (T_before > T_threshold) & valid
    w = alpha * T_before * included.to(sigmas.dtype)
    tot = _ray_totals(torch.cat([w[:, None], (w * ts)[:, None],
                                 w[:, None] * rgbs], dim=1),
                      ray_idx, valid, counts.shape[0])
    return CompositeResults(opacity=tot[:, 0], depth=tot[:, 1],
                            rgb=tot[:, 2:], ws=w, vr_samples=included.sum())


def composite_test_step(sigmas, rgbs, deltas, ts, n_eff, opacity, depth, rgb,
                        T_threshold: float):
    """One incremental compositing round, padded per-ray layout:
    sigmas/deltas/ts (N, S), rgbs (N, S, 3). The carries (opacity, depth,
    rgb) accumulate across rounds, with the running transmittance
    reconstructed as T = 1 - opacity.

    Returns (opacity, depth, rgb, alive) with alive=False once a ray's
    transmittance drops to or below T_threshold. A round that found no
    samples does not kill a ray: marching scans a bounded window per round,
    so ray exhaustion is the render loop's t_cur >= t2 check instead.
    """
    N, S = sigmas.shape
    smask = torch.arange(S, device=sigmas.device)[None, :] < n_eff[:, None]
    sd = sigmas * deltas * smask.to(sigmas.dtype)
    sd_excl = torch.cumsum(sd, dim=1) - sd
    T_carry = (1.0 - opacity)[:, None]
    T_before = T_carry * torch.exp(-sd_excl)
    alpha = 1.0 - torch.exp(-sd)
    included = (T_before > T_threshold) & smask
    w = alpha * T_before * included.to(sigmas.dtype)

    opacity = opacity + torch.sum(w, dim=1)
    depth = depth + torch.sum(w * ts, dim=1)
    rgb = rgb + torch.sum(w[..., None] * rgbs, dim=1)
    alive = (1.0 - opacity) > T_threshold
    return opacity, depth, rgb, alive
