"""An Instant-NGP view in plain PyTorch: each ray's occupied lattice points
from its AABB entry, the field at each in float32, and front-to-back
compositing that stops once the transmittance falls to T_threshold
(ngp_pl's test-time render, models/rendering.py)."""

import torch

from . import field, march


@torch.no_grad()
def render(params, occ, rays_o, rays_d, *, scale: float, grid: field.Grid,
           G: int, cascades: int, max_samples: int, cap: int,
           T_threshold: float, ray_chunk: int = 1 << 14):
    """(rgb (N, 3), depth (N,), opacity (N,)) with no background blend. The
    step is that of the viewer's marcher: dt_min = sqrt(3) / max_samples
    and dt_max from a step scale of `cascades`; `cap` bounds a ray's
    samples."""
    f = 1 / 256 if scale > 0.5 else 0.0
    steps = march.Steps(f, max_samples, G, float(cascades))
    outs = []
    for i in range(0, rays_o.shape[0], ray_chunk):
        o, d = rays_o[i:i + ray_chunk], rays_d[i:i + ray_chunk]
        t, dt, n = march.view_samples(o, d, occ, steps, scale, cascades, G,
                                      cap)
        N, S = t.shape
        mask = torch.arange(S, device=o.device)[None, :] < n[:, None]
        x = (o[:, None, :] + t[..., None] * d[:, None, :])[mask]
        sig, col = field.forward(params, x, d[:, None, :].expand(N, S, 3)
                                 [mask], scale, grid)
        sigma = torch.zeros((N, S), device=o.device)
        rgb = torch.zeros((N, S, 3), device=o.device)
        sigma[mask], rgb[mask] = sig, col
        sd = sigma * dt
        T = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]),
                                  torch.cumsum(sd, 1)[:, :-1]], 1))
        w = (1.0 - torch.exp(-sd)) * T * ((T > T_threshold) & mask)
        outs.append((torch.sum(w[..., None] * rgb, 1),
                     torch.sum(w * t, 1), torch.sum(w, 1)))
    return tuple(torch.cat([o[j] for o in outs]) for j in range(3))
