"""NeRF-synthetic (blender transforms_*.json) loader (port of
arnerf_tpu/datasets/nerf.py; reference datasets/nerf.py): identical pose
normalization (pose_radius_scale, Jrender special cases). The `device` and
`read_meta` kwargs of the entry points are accepted; rays stay host float32."""

import json
import os

import numpy as np

from .ray_utils import get_ray_directions
from .color_utils import read_images
from .base import BaseDataset


class NeRFDataset(BaseDataset):
    def __init__(self, root_dir, split='train', downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get('read_meta', True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, "transforms_train.json")) as f:
            meta = json.load(f)
        w = h = int(800 * self.downsample)
        fx = fy = 0.5 * 800 / np.tan(0.5 * meta['camera_angle_x']) \
            * self.downsample
        self.K = np.float32([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        rays, poses = [], []
        if split == 'trainval':
            frames = []
            for s in ('train', 'val'):
                with open(os.path.join(self.root_dir,
                                       f"transforms_{s}.json")) as f:
                    frames += json.load(f)["frames"]
        else:
            with open(os.path.join(self.root_dir,
                                   f"transforms_{split}.json")) as f:
                frames = json.load(f)["frames"]

        is_jrender = 'Jrender_Dataset' in self.root_dir
        scene = ''
        if is_jrender:
            folder = self.root_dir.split('/')
            scene = folder[-1] if folder[-1] != '' else folder[-2]
        scale = 1.0
        for frame in frames:
            c2w = np.array(frame['transform_matrix'])[:3, :4]
            if is_jrender:
                c2w[:, :2] *= -1  # [left up front] -> [right down front]
                pose_radius_scale = {'Easyship': 1.2, 'Scar': 1.8,
                                     'Coffee': 2.5, 'Car': 0.8}.get(scene, 1.5)
            else:
                c2w[:, 1:3] *= -1  # [right up back] -> [right down front]
                pose_radius_scale = 1.5
            scale = np.linalg.norm(c2w[:, 3]) / pose_radius_scale
            c2w[:, 3] /= scale
            if is_jrender:
                if scene == 'Coffee':
                    c2w[1, 3] -= 0.4465
                elif scene == 'Car':
                    c2w[0, 3] -= 0.7
            poses.append(c2w)
            img_path = os.path.join(self.root_dir,
                                    f"{frame['file_path']}.png")
            if os.path.exists(img_path):
                rays.append(img_path)

        # viewer/insertor transform back to original blender coordinates
        self.blender_trans = np.eye(4)
        self.blender_scale = scale
        if is_jrender:
            if scene == 'Coffee':
                self.blender_trans[1, 3] += 0.4465
            elif scene == 'Car':
                self.blender_trans[0, 3] += 0.7

        if rays:
            self.rays = read_images(rays, self.img_wh)
        self.poses = np.stack(poses).astype(np.float32)
