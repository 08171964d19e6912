"""Front-to-back volume compositing for the test-time renderer (port of
arnerf_tpu/ops/composite.py::composite_test_step; the reference's
composite_test_fw_kernel, models/csrc/volumerendering.cu:204-248).

A sample contributes iff the transmittance BEFORE it exceeds T_threshold,
which matches the reference loop that breaks after the first sample whose
post-update transmittance drops to or below the threshold. The training
compositor comes with the training path.
"""

import torch


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
