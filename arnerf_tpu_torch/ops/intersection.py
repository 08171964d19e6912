"""Ray / AABB intersection (port of arnerf_tpu/ops/intersection.py).

The render path only intersects the single scene AABB with max_hits=1
(reference: models/rendering.py:29-30): a slab test per ray.
"""

import torch


def _slab_test(rays_o, inv_d, center, half_size):
    """Per (ray, box) slab test. Returns (t1, t2); (-1, -1) where there is
    no intersection, and t1 is clamped to >= 0 like the reference
    (intersection.cu:51)."""
    t_lo = (center - half_size - rays_o) * inv_d
    t_hi = (center + half_size - rays_o) * inv_d
    t1 = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t2 = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = (t1 <= t2) & (t2 > 0)
    t1 = torch.where(hit, torch.clamp(t1, min=0.0), -1.0)
    t2 = torch.where(hit, t2, -1.0)
    return t1, t2


def ray_aabb_intersect_single(rays_o, rays_d, center, half_size):
    """Intersect N rays against ONE axis-aligned box.

    rays_o, rays_d: (N, 3); center, half_size: (3,) or (1, 3) tensors.
    Returns hits_t: (N, 2) [t1, t2], (-1, -1) on miss, t1 >= 0.
    """
    center = torch.as_tensor(center, dtype=rays_o.dtype,
                             device=rays_o.device).reshape(1, 3)
    half_size = torch.as_tensor(half_size, dtype=rays_o.dtype,
                                device=rays_o.device).reshape(1, 3)
    inv_d = 1.0 / rays_d
    t1, t2 = _slab_test(rays_o, inv_d, center, half_size)
    return torch.stack([t1, t2], dim=-1)
