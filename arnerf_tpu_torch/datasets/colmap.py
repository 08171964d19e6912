"""COLMAP-reconstruction loader, LLFF / mip-NeRF 360 / HDR-NeRF layouts
(port of arnerf_tpu/datasets/colmap.py; reference datasets/colmap.py): pose
centering against the sparse point cloud, min-norm scaling, every-8th test
split, mipnerf360 images_{n} folders, HDR-NeRF per-scene exposure tables
(carried as a 4th ray column; the trainer refuses --use_exposure until the
HDR heads are ported), spheric test trajectories."""

import glob
import os

import numpy as np

from .ray_utils import get_ray_directions, center_poses, create_spheric_poses
from .color_utils import read_images
from .colmap_utils import (read_cameras_binary, read_images_binary,
                           read_points3d_binary)
from .base import BaseDataset

# HDR-NeRF exposure tables per scene (reference colmap.py:141-159)
_EXPOSURES = {
    **{s: {e: 1 / 8 * 4 ** e for e in range(5)}
       for s in ('bathroom', 'bear', 'chair', 'desk')},
    **{s: {e: 1 / 16 * 4 ** e for e in range(5)}
       for s in ('diningroom', 'dog')},
    'sofa': {0: 0.25, 1: 1, 2: 2, 3: 4, 4: 16},
    'sponza': {0: 0.5, 1: 2, 2: 4, 3: 8, 4: 32},
    'box': {0: 2 / 3, 1: 1 / 3, 2: 1 / 6, 3: 0.1, 4: 0.05},
    'computer': {0: 1 / 3, 1: 1 / 8, 2: 1 / 15, 3: 1 / 30, 4: 1 / 60},
    'flower': {0: 1 / 3, 1: 1 / 6, 2: 0.1, 3: 0.05, 4: 1 / 45},
    'luckycat': {0: 2, 1: 1, 2: 0.5, 3: 0.25, 4: 0.125},
}


class ColmapDataset(BaseDataset):
    def __init__(self, root_dir, split='train', downsample=1.0, **kwargs):
        super().__init__(root_dir, split, downsample)
        self.read_intrinsics()
        if kwargs.get('read_meta', True):
            self.read_meta(split, **kwargs)

    def read_intrinsics(self):
        camdata = read_cameras_binary(
            os.path.join(self.root_dir, 'sparse/0/cameras.bin'))
        cam = camdata[1]
        h = int(cam.height * self.downsample)
        w = int(cam.width * self.downsample)
        self.img_wh = (w, h)
        if cam.model == 'SIMPLE_RADIAL':
            fx = fy = cam.params[0] * self.downsample
            cx = cam.params[1] * self.downsample
            cy = cam.params[2] * self.downsample
        elif cam.model in ('PINHOLE', 'OPENCV'):
            fx = cam.params[0] * self.downsample
            fy = cam.params[1] * self.downsample
            cx = cam.params[2] * self.downsample
            cy = cam.params[3] * self.downsample
        else:
            raise ValueError(
                f'Please parse the intrinsics for camera model {cam.model}!')
        self.K = np.float32([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        self.directions = get_ray_directions(h, w, self.K)

    def read_meta(self, split, **kwargs):
        imdata = read_images_binary(
            os.path.join(self.root_dir, 'sparse/0/images.bin'))
        img_names = [imdata[k].name for k in imdata]
        perm = np.argsort(img_names)
        if '360_v2' in self.root_dir and self.downsample < 1:
            folder = f'images_{int(1 / self.downsample)}'
        else:
            folder = 'images'
        img_paths = [os.path.join(self.root_dir, folder, name)
                     for name in sorted(img_names)]
        bottom = np.array([[0, 0, 0, 1.0]])
        w2c = np.stack([
            np.concatenate([np.concatenate(
                [imdata[k].qvec2rotmat(), imdata[k].tvec.reshape(3, 1)], 1),
                bottom], 0) for k in imdata], 0)
        poses = np.linalg.inv(w2c)[perm, :3]

        pts3d_d = read_points3d_binary(
            os.path.join(self.root_dir, 'sparse/0/points3D.bin'))
        pts3d = np.array([pts3d_d[k].xyz for k in pts3d_d])

        self.poses, self.pts3d, pose_avg = center_poses(poses, pts3d)
        scale = np.linalg.norm(self.poses[..., 3], axis=-1).min()
        self.poses[..., 3] /= scale
        self.pts3d /= scale

        self.blender_trans = np.eye(4)
        self.blender_trans[:3, :] = pose_avg
        self.blender_scale = scale

        if split == 'test_traj':
            self.poses = create_spheric_poses(
                1.2, self.poses[:, 1, 3].mean()).astype(np.float32)
            return

        if 'HDR-NeRF' in self.root_dir:
            img_paths, exposures = self._hdr_nerf_split(split)
        else:
            exposures = None
            # every 8th image is the test set (reference colmap.py:124-131)
            if split == 'train':
                keep = [i for i in range(len(img_paths)) if i % 8 != 0]
            elif split == 'test':
                keep = [i for i in range(len(img_paths)) if i % 8 == 0]
            else:
                keep = list(range(len(img_paths)))
            img_paths = [img_paths[i] for i in keep]
            self.poses = self.poses[keep]

        if img_paths:
            rays = read_images(img_paths, self.img_wh, blend_a=False)
            if exposures is not None:
                col = np.broadcast_to(np.float32(exposures)[:, None, None],
                                      rays.shape[:2] + (1,))
                rays = np.concatenate([rays, col], 2)
            self.rays = rays
        self.poses = np.asarray(self.poses, np.float32)

    def _hdr_nerf_split(self, split):
        """HDR-NeRF train/test conventions + exposure values
        (reference colmap.py:91-123, 141-161)."""
        folder = self.root_dir.split('/')
        scene = folder[-1] if folder[-1] != '' else folder[-2]
        if 'syndata' in self.root_dir:  # synthetic HDR
            self.unit_exposure_rgb = 0.73
            if split == 'train':
                img_paths = sorted(glob.glob(
                    os.path.join(self.root_dir, 'train/*[024].png')))
                self.poses = np.repeat(self.poses[-18:], 3, 0)
            elif split == 'test':
                img_paths = sorted(glob.glob(
                    os.path.join(self.root_dir, 'test/*[13].png')))
                self.poses = np.repeat(self.poses[:17], 2, 0)
            else:
                raise ValueError(f'split {split} is invalid for HDR-NeRF!')
        else:  # real captures
            self.unit_exposure_rgb = 0.5
            if split == 'train':
                img_paths = []
                for d in ('0', '2', '4'):
                    img_paths += sorted(glob.glob(os.path.join(
                        self.root_dir, f'input_images/*{d}.jpg')))[::2]
                self.poses = np.tile(self.poses[::2], (3, 1, 1))
            elif split == 'test':
                img_paths = []
                for d in ('1', '3'):
                    img_paths += sorted(glob.glob(os.path.join(
                        self.root_dir, f'input_images/*{d}.jpg')))[1::2]
                self.poses = np.tile(self.poses[1::2], (2, 1, 1))
            else:
                raise ValueError(f'split {split} is invalid for HDR-NeRF!')
        e_dict = _EXPOSURES[scene]
        exposures = [e_dict[int(p.split('.')[0][-1])] for p in img_paths]
        return img_paths, exposures
