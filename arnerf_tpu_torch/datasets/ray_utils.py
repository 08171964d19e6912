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


def axisangle_to_R(v):
    """Axis-angle (B, 3) tensor -> rotation matrices (B, 3, 3).

    reference: datasets/ray_utils.py:74-100 (Rodrigues via skew matrix).
    """
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1)], dim=1)
    # sqrt(sum+eps) keeps the derivative finite at v = 0 (plain norm has a
    # NaN gradient there, which poisons --optimize_ext's zero-initialized
    # deltas on the very first step)
    norm = torch.sqrt(torch.sum(v * v, dim=1) + 1e-14)[:, None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)[None]
    return (eye + torch.sin(norm) / norm * skew
            + (1 - torch.cos(norm)) / norm ** 2 * (skew @ skew))


def normalize(v):
    return v / np.linalg.norm(v)


def average_poses(poses, pts3d=None):
    """reference: datasets/ray_utils.py:108-147."""
    center = pts3d.mean(0) if pts3d is not None else poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses, pts3d=None):
    """reference: datasets/ray_utils.py:150-178."""
    pose_avg = average_poses(poses, pts3d)
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = pose_avg
    pose_avg_inv = np.linalg.inv(pose_avg_homo)
    last_row = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    poses_centered = (pose_avg_inv @ poses_homo)[:, :3]
    if pts3d is not None:
        pts3d_centered = pts3d @ pose_avg_inv[:, :3].T + pose_avg_inv[:, 3:].T
        return poses_centered, pts3d_centered, pose_avg
    return poses_centered, pose_avg


def create_spheric_poses(radius, mean_h, n_poses=120):
    """Circular test trajectory. reference: datasets/ray_utils.py:180-215."""
    def spheric_pose(theta, phi, radius):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, 2 * mean_h],
                            [0, 0, 1, -radius]])
        rot_phi = np.array([[1, 0, 0], [0, np.cos(phi), -np.sin(phi)],
                            [0, np.sin(phi), np.cos(phi)]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta)], [0, 1, 0],
                              [np.sin(theta), 0, np.cos(theta)]])
        c2w = rot_theta @ rot_phi @ trans_t
        return np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]]) @ c2w

    return np.stack([spheric_pose(th, -np.pi / 12, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]], 0)


def look_at_pose(eye, target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)):
    """c2w (3,4) for a [right down front] camera at `eye` looking at `target`."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    forward = normalize(target - eye)            # +z (front)
    right = normalize(np.cross(forward, np.asarray(up, np.float64)))
    down = np.cross(forward, right)              # +y (down)
    return np.stack([right, down, forward, eye], axis=1).astype(np.float32)
