"""RTMV loader (port of arnerf_tpu/datasets/rtmv.py; reference
datasets/rtmv.py): camera_data from NNNNN.json, the scene-box shift and
scale, the 0-100 / 0-105 / 105-150 index splits. The frames are the 8-bit
sRGB PNGs under images/ that `python -m arnerf_tpu_torch.prepare_rtmv`
makes from the scene's OpenEXR frames, read as LDR images."""

import glob
import json
import os

import numpy as np

from .ray_utils import get_ray_directions
from .color_utils import read_images
from .base import BaseDataset

SPLITS = {"train": (0, 100), "trainval": (0, 105), "test": (105, 150)}


class RTMVDataset(BaseDataset):
    def __init__(self, root_dir, split='train', downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get('read_meta', True):
            self.read_meta(split)

    def read_intrinsics(self):
        with open(os.path.join(self.root_dir, '00000.json')) as f:
            meta = json.load(f)['camera_data']
        self.shift = np.array(meta['scene_center_3d_box'])
        self.scale = (np.array(meta['scene_max_3d_box'])
                      - np.array(meta['scene_min_3d_box'])).max() / 2 * 1.05
        fx = meta['intrinsics']['fx'] * self.downsample
        fy = meta['intrinsics']['fy'] * self.downsample
        cx = meta['intrinsics']['cx'] * self.downsample
        cy = meta['intrinsics']['cy'] * self.downsample
        w = int(meta['width'] * self.downsample)
        h = int(meta['height'] * self.downsample)
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)
        self.img_wh = (w, h)

    def read_meta(self, split):
        start_idx, end_idx = SPLITS.get(split, (0, 150))
        img_paths = sorted(glob.glob(os.path.join(self.root_dir,
                                                  'images/*')))
        if not img_paths:
            raise FileNotFoundError(
                f"{os.path.join(self.root_dir, 'images')} holds no frames: "
                f"run `python -m arnerf_tpu_torch.prepare_rtmv "
                f"{self.root_dir}` first")
        img_paths = img_paths[start_idx:end_idx]
        pose_files = sorted(glob.glob(
            os.path.join(self.root_dir, '*.json')))[start_idx:end_idx]
        pairs = list(zip(img_paths, pose_files))
        poses = []
        for _, pose in pairs:
            with open(pose) as f:
                p = json.load(f)['camera_data']
            c2w = np.array(p['cam2world']).T[:3]
            c2w[:, 1:3] *= -1
            if 'bricks' in self.root_dir:
                c2w[:, 3] -= self.shift
                c2w[:, 3] /= 2 * self.scale  # bound in [-0.5, 0.5]
            poses.append(c2w)
        if pairs:
            self.rays = read_images([p for p, _ in pairs], self.img_wh)
        self.poses = np.stack(poses).astype(np.float32)
