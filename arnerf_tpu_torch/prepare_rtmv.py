"""Convert an RTMV scene's OpenEXR frames to the 8-bit sRGB PNGs the rtmv
loader reads (port of misc/prepare_rtmv.py; reference
misc/prepare_rtmv.py):

    python -m arnerf_tpu_torch.prepare_rtmv <root>

Each <root>/*.exr becomes <root>/images/<name>.png: its R, G and B
channels (alpha dropped, not applied), clipped at 0, through
linear_to_srgb (which clamps at 1), times 255 and truncated to uint8, as
the JAX script computes from OpenCV's read. Frames are read with the
port's OpenEXR reader (image_io.read_exr), which names what it cannot
decode (PIZ, among others)."""

import glob
import os
import sys

import numpy as np

from .datasets.color_utils import linear_to_srgb
from .image_io import read_exr, write_png


def main(root):
    out_dir = os.path.join(root, 'images')
    os.makedirs(out_dir, exist_ok=True)
    for p in sorted(glob.glob(os.path.join(root, '*.exr'))):
        img = read_exr(p)[..., :3]
        img = linear_to_srgb(np.clip(img.astype(np.float32), 0, None))
        name = os.path.splitext(os.path.basename(p))[0] + '.png'
        write_png(os.path.join(out_dir, name), (img * 255).astype(np.uint8))
        print(name)


if __name__ == '__main__':
    main(sys.argv[1])
