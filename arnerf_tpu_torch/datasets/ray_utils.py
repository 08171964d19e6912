"""Ray/pose utilities (port of arnerf_tpu/datasets/ray_utils.py; reference
datasets/ray_utils.py). Host-side numpy for the loaders, torch for rays."""

import numpy as np
import torch


def get_ray_directions(H, W, K, random=False, flatten=True, rng=None):
    """Camera-space ray directions [right down front] for every pixel.

    reference: datasets/ray_utils.py:8-42 (pixel centers at +0.5).
    Returns (H*W, 3) float32 numpy (or (H, W, 3) if flatten=False).
    """
    K = np.asarray(K)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    v, u = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    if random:
        rng = rng or np.random.default_rng()
        du = rng.random(u.shape, dtype=np.float32)
        dv = rng.random(v.shape, dtype=np.float32)
    else:
        du = dv = 0.5
    dirs = np.stack([(u - cx + du) / fx, (v - cy + dv) / fy,
                     np.ones_like(u)], axis=-1).astype(np.float32)
    return dirs.reshape(-1, 3) if flatten else dirs


def get_rays(directions, c2w):
    """Camera-space dirs + c2w pose(s) -> world rays.

    directions: (N, 3) tensor; c2w: (3, 4) or (N, 3, 4) tensor on the same
    device. Float32 products run at full precision (TF32 stays off).
    reference: datasets/ray_utils.py:46-70.
    """
    if c2w.ndim == 2:
        rays_d = directions @ c2w[:, :3].T
        rays_o = c2w[:, 3].expand(rays_d.shape)
    else:
        rays_d = torch.einsum("nc,nbc->nb", directions, c2w[..., :3])
        rays_o = c2w[..., 3]
    return rays_o, rays_d


def normalize(v):
    return v / np.linalg.norm(v)


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """c2w (3,4) for a [right down front] camera at `eye` looking at `target`."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    forward = normalize(target - eye)            # +z (front)
    right = normalize(np.cross(forward, np.asarray(up, np.float64)))
    down = np.cross(forward, right)              # +y (down)
    return np.stack([right, down, forward, eye], axis=1).astype(np.float32)
