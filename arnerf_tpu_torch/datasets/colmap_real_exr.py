"""COLMAP poses with real-capture OpenEXR frames (port of
arnerf_tpu/datasets/colmap_real_exr.py; reference
datasets/colmap_real_exr.py): IMG.jpg -> exr/IMG.exr."""

import os

from .colmap_exr import ColmapEXRDataset


class ColmapRealEXRDataset(ColmapEXRDataset):
    def remap_name(self, img_name):
        # IMGXXXX.jpg -> exr/IMGXXXX.exr (colmap_real_exr.py:51-52)
        return os.path.join('exr', img_name.replace('.jpg', '.exr'))
