"""Mip-NeRF-360 distortion loss over compact per-ray segments (port of
arnerf_tpu/ops/distortion.py; the reference's distortion_loss_fw/bw,
models/csrc/losses.cu, formulation of DVGO-v2, arXiv:2206.05085):

  loss_ray = sum_s 2*(wts_incl[s]*ws_excl[s] - ws_incl[s]*wts_excl[s])
             + 1/3 * sum_s ws[s]^2 * deltas[s]

with per-ray inclusive/exclusive prefix sums of ws and ws*ts taken as a
global cumsum minus the segment base (ops/composite.py); autograd gives the
backward.
"""

from .composite import _ray_totals, _segment_base


def distortion_loss(ws, deltas, ts, ray_idx, valid, ray_start, counts):
    """Per-ray distortion loss. ws/deltas/ts: (M,). Returns (N,)."""
    fvalid = valid.to(ws.dtype)
    w = ws * fvalid
    wt = w * ts
    w_cum = w.cumsum(0)
    wt_cum = wt.cumsum(0)
    w_incl = w_cum - _segment_base(w_cum, ray_start, ray_idx)
    wt_incl = wt_cum - _segment_base(wt_cum, ray_start, ray_idx)
    w_excl = w_incl - w
    wt_excl = wt_incl - wt
    per_sample = 2.0 * (wt_incl * w_excl - w_incl * wt_excl) \
        + (1.0 / 3.0) * w * w * deltas
    return _ray_totals(per_sample, ray_idx, valid, counts.shape[0])
