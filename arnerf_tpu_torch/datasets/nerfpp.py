"""NeRF++ layout loader, per-image intrinsics/pose txt files (port of
arnerf_tpu/datasets/nerfpp.py; reference datasets/nerfpp.py). The image
size comes from the first image's header (the JAX loader opens it with
PIL)."""

import glob
import os

import numpy as np

from .ray_utils import get_ray_directions
from ..image_io import image_size
from .color_utils import read_images
from .base import BaseDataset


class NeRFPPDataset(BaseDataset):
    def __init__(self, root_dir, split='train', downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get('read_meta', True):
            self.read_meta(split)

    def read_intrinsics(self):
        K = np.loadtxt(glob.glob(os.path.join(
            self.root_dir, 'train/intrinsics/*.txt'))[0],
            dtype=np.float32).reshape(4, 4)[:3, :3]
        K[:2] *= self.downsample
        w, h = image_size(glob.glob(
            os.path.join(self.root_dir, 'train/rgb/*'))[0])
        w, h = int(w * self.downsample), int(h * self.downsample)
        self.K = np.float32(K)
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        rays, poses = [], []
        self.blender_trans = np.eye(4)
        if split == 'test_traj':
            pose_files = sorted(glob.glob(
                os.path.join(self.root_dir, 'camera_path/pose/*.txt')))
            poses = [np.loadtxt(p).reshape(4, 4)[:3] for p in pose_files]
        else:
            if split == 'trainval':
                img_paths, pose_files = [], []
                for s in ('train', 'val'):
                    img_paths += sorted(glob.glob(
                        os.path.join(self.root_dir, s, 'rgb/*')))
                    pose_files += sorted(glob.glob(
                        os.path.join(self.root_dir, s, 'pose/*.txt')))
            else:
                img_paths = sorted(glob.glob(
                    os.path.join(self.root_dir, split, 'rgb/*')))
                pose_files = sorted(glob.glob(
                    os.path.join(self.root_dir, split, 'pose/*.txt')))
            for img_path, pose in zip(img_paths, pose_files):
                poses.append(np.loadtxt(pose).reshape(4, 4)[:3])
                rays.append(img_path)
            if rays:
                self.rays = read_images(rays, self.img_wh)
        self.poses = np.stack(poses).astype(np.float32)
