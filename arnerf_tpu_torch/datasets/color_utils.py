"""Image reading and colour-space helpers (port of
arnerf_tpu/datasets/color_utils.py; reference datasets/color_utils.py).

The JAX package reads with imageio (OpenEXR files with OpenCV) and resizes
with OpenCV, or takes its native libpng/libjpeg decoder when that is built.
The port has one path: the files are decoded by its own native decoder
(image_io.imread_many, the arrays imageio gives; image_io.read_exr_many for
OpenEXR) and then follow the JAX package's conventions in numpy. LDR:
values divided by 255 whatever the bit depth, gray repeated to 3 channels,
alpha blended to white or premultiplied. EXR: linear values as stored,
RGBA premultiplied (rgb * a) whatever `blend_a` says. Then OpenCV's
INTER_LINEAR resize.
"""

from concurrent.futures import ThreadPoolExecutor
import os

import numpy as np

from ..image_io import imread, imread_many, read_exr, read_exr_many

READ_CHUNK = 64


def srgb_to_linear(img):
    limit = 0.04045
    return np.where(img > limit, ((img + 0.055) / 1.055) ** 2.4, img / 12.92)


def linear_to_srgb(img):
    limit = 0.0031308
    img = np.where(img > limit, 1.055 * img ** (1 / 2.4) - 0.055, 12.92 * img)
    img[img > 1] = 1  # "clamp" tonemapper
    return img


def _linear_taps(src, dst):
    """OpenCV's INTER_LINEAR taps along one axis (resize.cpp): the source
    index pair and the float32 weights of every destination index, with
    half-pixel centres and the edges clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    edge = (s < 0) | (s >= src - 1)
    f[edge] = 0.0
    s = np.clip(s, 0, src - 1)
    return s, np.minimum(s + 1, src - 1), np.float32(1) - f, f


def resize_linear(img, img_wh):
    """cv2.resize(img, img_wh) (INTER_LINEAR) of an (H, W, C) float32 image,
    in numpy: horizontal pass, then vertical, in float32."""
    w, h = img_wh
    if img.shape[:2] == (h, w):
        return img
    x0, x1, a0, a1 = _linear_taps(img.shape[1], w)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], h)
    rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
    return rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]


def _to_rays(img, img_wh, blend_a):
    """imageio's array -> (H*W, C) float32 as the JAX read_image makes it."""
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[2] == 2:   # gray + alpha: as RGBA (JAX keeps 2 channels)
        img = img[..., [0, 0, 0, 1]]
    if img.shape[2] == 4:  # blend A to RGB
        if blend_a:
            img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        else:
            img = img[..., :3] * img[..., -1:]
    img = resize_linear(img, img_wh)
    return img.reshape(-1, img.shape[-1]).astype(np.float32)


def _exr_to_rays(img, img_wh):
    """A decoded OpenEXR image (H, W, 3|4) -> (H*W, 3) float32 as the JAX
    read_image(exr_file=True) makes it from OpenCV's: RGBA premultiplied,
    then resized."""
    if img.shape[2] == 4:
        img = img[..., :3] * img[..., 3:]
    img = resize_linear(img, img_wh)
    return img.reshape(-1, 3).astype(np.float32)


def read_image(img_path, img_wh, blend_a=True, exr_file=False):
    """Load an image to a flattened (H*W, C) float32 array: [0, 1] (or
    above, for 16-bit files) with alpha blended to white (blend_a) or
    premultiplied; exr_file: an OpenEXR file's linear RGB, premultiplied
    by its alpha."""
    if exr_file:
        return _exr_to_rays(read_exr(img_path), img_wh)
    return _to_rays(imread(img_path), img_wh, blend_a)


def read_images(img_paths, img_wh, blend_a=True, exr_file=False):
    """Batch image read -> (n, W*H, 3) float32, decoded in parallel,
    READ_CHUNK files at a time (bounds the decoded bytes held at once)."""
    w, h = img_wh
    out = np.empty((len(img_paths), w * h, 3), np.float32)

    def convert(i_img):
        i, img = i_img
        out[i] = _exr_to_rays(img, img_wh) if exr_file \
            else _to_rays(img, img_wh, blend_a)[:, :3]

    read_many = read_exr_many if exr_file else imread_many
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for start in range(0, len(img_paths), READ_CHUNK):
            imgs = read_many(img_paths[start:start + READ_CHUNK])
            list(pool.map(convert, enumerate(imgs, start)))
    return out
