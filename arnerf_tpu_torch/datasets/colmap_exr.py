"""COLMAP poses with HDR OpenEXR frames (port of
arnerf_tpu/datasets/colmap_exr.py; reference datasets/colmap_exr.py): the
file-name remap train_r_15_3.png -> train_hdr/hdr_015.exr and the every-8th
test split. The frames are read as linear radiance (color_utils.read_images
with exr_file=True: RGBA premultiplied, nothing clipped)."""

import os

import numpy as np

from .colmap import ColmapDataset
from .colmap_utils import read_images_binary, read_points3d_binary
from .color_utils import read_images
from .ray_utils import center_poses, create_spheric_poses


class ColmapEXRDataset(ColmapDataset):
    def remap_name(self, img_name):
        # train_r_15_3.png -> train_hdr/hdr_015.exr (colmap_exr.py:52-58)
        sp = img_name.split('_')
        return '{}_hdr/hdr_{:0>3d}.exr'.format(sp[0], int(sp[2]))

    def read_meta(self, split, **kwargs):
        imdata = read_images_binary(
            os.path.join(self.root_dir, 'sparse/0/images.bin'))
        img_names = [self.remap_name(imdata[k].name) for k in imdata]
        perm = np.argsort(img_names)
        img_paths = [os.path.join(self.root_dir, name)
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
