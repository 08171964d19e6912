"""NSVF-format loader (Synthetic-NSVF / BlendedMVS / TanksAndTemples), port
of arnerf_tpu/datasets/nsvf.py (reference datasets/nsvf.py): bbox
shift/scale (+Mic/Lego enlargements), per-subdataset intrinsics, split
prefixes, test trajectories, Jade/Fountain background rewrite."""

import glob
import os

import numpy as np

from .ray_utils import get_ray_directions
from .color_utils import read_images
from .base import BaseDataset


class NSVFDataset(BaseDataset):
    def __init__(self, root_dir, split='train', downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get('read_meta', True):
            xyz_min, xyz_max = np.loadtxt(
                os.path.join(root_dir, 'bbox.txt'))[:6].reshape(2, 3)
            self.shift = (xyz_max + xyz_min) / 2
            self.scale = (xyz_max - xyz_min).max() / 2 * 1.05
            # reference's hard-coded bound fixes (nsvf.py:25-27)
            if 'Mic' in self.root_dir:
                self.scale *= 1.2
            elif 'Lego' in self.root_dir:
                self.scale *= 1.1
            self.read_meta(split)

    def read_intrinsics(self):
        if 'Synthetic' in self.root_dir or 'Ignatius' in self.root_dir:
            with open(os.path.join(self.root_dir, 'intrinsics.txt')) as f:
                fx = fy = float(f.readline().split()[0]) * self.downsample
            if 'Synthetic' in self.root_dir:
                w = h = int(800 * self.downsample)
            else:
                w, h = int(1920 * self.downsample), int(1080 * self.downsample)
            K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        else:
            K = np.loadtxt(os.path.join(self.root_dir, 'intrinsics.txt'),
                           dtype=np.float32)[:3, :3]
            if 'BlendedMVS' in self.root_dir:
                w, h = int(768 * self.downsample), int(576 * self.downsample)
            elif 'Tanks' in self.root_dir:
                w, h = int(1920 * self.downsample), int(1080 * self.downsample)
            else:
                raise ValueError(
                    f'unknown NSVF sub-dataset at {self.root_dir}')
            K[:2] *= self.downsample
        self.K = np.float32(K)
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        rays, poses = [], []
        if split == 'test_traj':  # BlendedMVS and TanksAndTemple
            if 'Ignatius' in self.root_dir:
                poses_path = sorted(glob.glob(
                    os.path.join(self.root_dir, 'test_pose/*.txt')))
                traj = [np.loadtxt(p) for p in poses_path]
            else:
                traj = np.loadtxt(
                    os.path.join(self.root_dir, 'test_traj.txt')).reshape(
                        -1, 4, 4)
            for pose in traj:
                c2w = pose[:3]
                c2w[:, 0] *= -1  # [left down front] -> [right down front]
                c2w[:, 3] -= self.shift
                c2w[:, 3] /= 2 * self.scale  # bound into [-0.5, 0.5]
                poses.append(c2w)
        else:
            if split == 'train':
                prefix = '0_'
            elif split == 'trainval':
                prefix = '[0-1]_'
            elif split == 'trainvaltest':
                prefix = '[0-2]_'
            elif split == 'val':
                prefix = '1_'
            elif 'Synthetic' in self.root_dir:
                prefix = '2_'  # test set for synthetic scenes
            elif split == 'test':
                prefix = '1_'  # test set for real scenes
            else:
                raise ValueError(f'{split} split not recognized!')
            img_paths = sorted(glob.glob(
                os.path.join(self.root_dir, 'rgb', prefix + '*.png')))
            pose_files = sorted(glob.glob(
                os.path.join(self.root_dir, 'pose', prefix + '*.txt')))
            for pose in pose_files:
                c2w = np.loadtxt(pose)[:3]
                c2w[:, 3] -= self.shift
                c2w[:, 3] /= 2 * self.scale
                poses.append(c2w)
            if img_paths:
                self.rays = read_images(img_paths, self.img_wh)
                if 'Jade' in self.root_dir or 'Fountain' in self.root_dir:
                    # black background -> white (reference nsvf.py:93-95)
                    self.rays[np.all(self.rays <= 0.1, axis=-1)] = 1.0
        self.poses = np.stack(poses).astype(np.float32)
