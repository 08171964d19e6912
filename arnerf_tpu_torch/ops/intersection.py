"""Ray / AABB and ray / sphere intersection (port of
arnerf_tpu/ops/intersection.py; reference `vren.ray_aabb_intersect` and
`vren.ray_sphere_intersect`, models/csrc/intersection.cu:5-197).

The render path only intersects the single scene AABB with max_hits=1
(reference: models/rendering.py:29-30): `ray_aabb_intersect_single`, a
slab test per ray. `ray_aabb_intersect` (N rays x V boxes) and
`ray_sphere_intersect` (N rays x S spheres) keep the first `max_hits` hits
by t1, as the reference's kernels do.
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


def _first_hits(t1, t2, hit, max_hits: int):
    """(N, V) hits -> the first `max_hits` by t1: (hits_cnt (N,) int32,
    hits_t (N, max_hits, 2), index (N, max_hits) int32), -1 padded. The
    sort is stable, as jnp.argsort is: a ray starting inside several boxes
    has t1 = 0 in each, and those keep their index order."""
    hits_cnt = torch.sum(hit, dim=1, dtype=torch.int32)
    sort_key = torch.where(hit, t1, torch.inf)
    order = torch.argsort(sort_key, dim=1, stable=True)[:, :max_hits]
    t1s, t2s, hits = (torch.gather(x, 1, order) for x in (t1, t2, hit))
    hits_t = torch.stack([torch.where(hits, t1s, -1.0),
                          torch.where(hits, t2s, -1.0)], dim=-1)
    return hits_cnt, hits_t, torch.where(hits, order, -1).to(torch.int32)


def ray_aabb_intersect(rays_o, rays_d, centers, half_sizes, max_hits: int):
    """N rays x V boxes (centers, half_sizes: (V, 3)), the first `max_hits`
    by t1. Returns (hits_cnt (N,), hits_t (N, max_hits, 2),
    hits_voxel_idx (N, max_hits)), hits sorted near to far, -1 padding."""
    inv_d = 1.0 / rays_d
    t1, t2 = _slab_test(rays_o[:, None, :], inv_d[:, None, :],
                        centers[None, :, :], half_sizes[None, :, :])
    return _first_hits(t1, t2, t2 > 0, max_hits)


def _dot(u, v):
    """Dot product over the last axis of 3, summed (x + y) + z: the same
    IEEE operations on every device. A near-tangent ray's roots take the
    square root of a small discriminant, which magnifies any difference in
    its last bits (a reduction kernel that sums in another order)."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] \
        + u[..., 2] * v[..., 2]


def ray_sphere_intersect(rays_o, rays_d, centers, radii, max_hits: int):
    """N rays x S spheres (centers (S, 3), radii (S,)): the quadratic's
    roots, t1 clamped to >= 0, the first `max_hits` by t1, near to far,
    -1 padding (reference intersection.cu:103-197)."""
    oc = rays_o[:, None, :] - centers[None, :, :]            # (N, S, 3)
    d = rays_d[:, None, :]
    a = _dot(d, d)
    b = 2.0 * _dot(oc, d)
    c = _dot(oc, oc) - radii[None, :] ** 2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    hit = (disc > 0) & (t2 > 0)
    return _first_hits(torch.clamp(t1, min=0.0), t2, hit, max_hits)
