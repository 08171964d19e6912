"""PFM depth-map read/write (port of arnerf_tpu/datasets/depth_utils.py;
reference datasets/depth_utils.py; unused by the main path but part of
the public data API)."""

import re

import numpy as np


def read_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise Exception("Not a PFM file: " + path)
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise Exception("Malformed PFM header.")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
        shape = (height, width, 3) if color else (height, width)
        return np.flipud(data.reshape(shape)), scale


def write_pfm(path, image, scale=1):
    image = np.flipud(image).astype(np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise Exception("Image must have H x W x 3, H x W x 1 or H x W.")
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        if image.dtype.byteorder == "<" or (
                image.dtype.byteorder == "=" and np.little_endian):
            scale = -scale
        f.write(b"%f\n" % scale)
        image.tofile(f)
