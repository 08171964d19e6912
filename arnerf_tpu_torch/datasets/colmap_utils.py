"""Minimal COLMAP sparse-model readers, binary + text (port of
arnerf_tpu/datasets/colmap_utils.py).

Independent implementation of the public COLMAP model format
(https://colmap.github.io/format.html); provides the same API surface the
reference uses (reference datasets/colmap_utils.py): read_cameras_binary,
read_images_binary, read_points3d_binary, their text variants, and
qvec<->rotmat conversion.
"""

import collections
import os
import struct

import numpy as np

CameraModel = collections.namedtuple("CameraModel",
                                     ["model_id", "model_name", "num_params"])
Camera = collections.namedtuple("Camera",
                                ["id", "model", "width", "height", "params"])
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


def _read(fid, fmt):
    data = fid.read(struct.calcsize(fmt))
    return struct.unpack(fmt, data)


def read_cameras_binary(path):
    cameras = {}
    with open(path, "rb") as fid:
        (num,) = _read(fid, "<Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(fid, "<iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = np.array(_read(fid, "<" + "d" * model.num_params))
            cameras[cam_id] = Camera(cam_id, model.model_name,
                                     width, height, params)
    return cameras


def read_images_binary(path):
    images = {}
    with open(path, "rb") as fid:
        (num,) = _read(fid, "<Q")
        for _ in range(num):
            vals = _read(fid, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = fid.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(fid, "<Q")
            data = _read(fid, "<" + "ddq" * num_pts)
            xys = np.array(data).reshape(-1, 3)[:, :2] if num_pts else \
                np.zeros((0, 2))
            p3d = np.array(data[2::3], dtype=np.int64) if num_pts else \
                np.zeros(0, np.int64)
            images[image_id] = Image(image_id, qvec, tvec, camera_id,
                                     name.decode("utf-8"), xys, p3d)
    return images


def read_points3d_binary(path):
    points = {}
    with open(path, "rb") as fid:
        (num,) = _read(fid, "<Q")
        for _ in range(num):
            vals = _read(fid, "<QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            error = vals[7]
            (track_len,) = _read(fid, "<Q")
            track = _read(fid, "<" + "ii" * track_len)
            points[pid] = Point3D(pid, xyz, rgb, error,
                                  np.array(track[0::2]),
                                  np.array(track[1::2]))
    return points


def read_cameras_text(path):
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cam_id = int(el[0])
            cameras[cam_id] = Camera(cam_id, el[1], int(el[2]), int(el[3]),
                                     np.array(el[4:], dtype=np.float64))
    return cameras


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        image_id = int(el[0])
        qvec = np.array(el[1:5], dtype=np.float64)
        tvec = np.array(el[5:8], dtype=np.float64)
        camera_id = int(el[8])
        name = el[9]
        el2 = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(el2, dtype=np.float64).reshape(-1, 3)[:, :2] \
            if el2 else np.zeros((0, 2))
        p3d = np.array(el2[2::3], dtype=np.int64) if el2 else \
            np.zeros(0, np.int64)
        images[image_id] = Image(image_id, qvec, tvec, camera_id, name,
                                 xys, p3d)
    return images


def read_points3d_text(path):
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            pid = int(el[0])
            points[pid] = Point3D(
                pid, np.array(el[1:4], np.float64),
                np.array(el[4:7], np.float64), float(el[7]),
                np.array(el[8::2], np.int64), np.array(el[9::2], np.int64))
    return points


def read_model(path, ext=".bin"):
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3d_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3d_text(os.path.join(path, "points3D.txt")))
