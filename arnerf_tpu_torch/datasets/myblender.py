"""MyBlender loader (port of arnerf_tpu/datasets/myblender.py; reference
datasets/myblender.py): intrinsics in int.txt (image size twice the
principal point), world-to-camera extrinsics in exts.npy, OpenEXR frames
in img/, the every-8th test split."""

import os

import numpy as np

from .base import BaseDataset
from .color_utils import read_images
from .ray_utils import create_spheric_poses, get_ray_directions


class MyBlenderDataset(BaseDataset):
    def __init__(self, root_dir, split='train', downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get('read_meta', True):
            self.read_meta(split, **kwargs)

    def read_intrinsics(self):
        self.K = np.loadtxt(os.path.join(self.root_dir, 'int.txt')
                            ).astype(np.float32)
        W = int(self.K[0, 2]) * 2
        H = int(self.K[1, 2]) * 2
        self.img_wh = (W, H)
        self.directions = get_ray_directions(H, W, self.K)

    def read_meta(self, split, **kwargs):
        exts = np.load(os.path.join(self.root_dir, 'exts.npy'))
        poses = []
        for ext in exts:
            ext = np.concatenate([ext, np.array([[0, 0, 0, 1.0]])], 0)
            poses.append(np.linalg.inv(ext))
        self.poses = np.stack(poses, 0)[:, :3, :]

        scale = np.linalg.norm(self.poses[..., 3], axis=-1).min()
        self.poses[..., 3] /= scale
        self.blender_trans = np.eye(4)
        self.blender_scale = scale

        img_dir = os.path.join(self.root_dir, 'img')
        img_paths = [os.path.join(img_dir, im)
                     for im in sorted(os.listdir(img_dir))]
        if len(img_paths) < self.poses.shape[0]:
            print('warning: use less img')
            self.poses = self.poses[:len(img_paths)]
        elif len(img_paths) > self.poses.shape[0]:
            print('error: incomplete pose')

        if split == 'test_traj':
            self.poses = create_spheric_poses(
                1.2, self.poses[:, 1, 3].mean()).astype(np.float32)
            return

        if split == 'train':
            keep = [i for i in range(len(img_paths)) if i % 8 != 0]
        elif split == 'test':
            keep = [i for i in range(len(img_paths)) if i % 8 == 0]
        else:
            keep = list(range(len(img_paths)))
        img_paths = [img_paths[i] for i in keep]
        self.poses = np.asarray(self.poses[keep], np.float32)
        if img_paths:
            self.rays = read_images(img_paths, self.img_wh, blend_a=False,
                                    exr_file=True)
