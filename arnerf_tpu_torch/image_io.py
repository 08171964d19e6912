"""Image files without an image library: 8-bit PNG and uncompressed
float OpenEXR writers in numpy (the GPU machine has neither OpenCV nor
PIL)."""

import struct
import zlib

import numpy as np


def write_png(path, img):
    """img: (H, W) or (H, W, 3) uint8 -> an 8-bit PNG file."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body \
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _attr(name, kind, value: bytes) -> bytes:
    return name.encode() + b"\0" + kind.encode() + b"\0" \
        + struct.pack("<i", len(value)) + value


def write_exr(path, img):
    """img: (H, W, 3) float RGB -> a single-part scanline OpenEXR file,
    uncompressed, 32-bit FLOAT channels B, G, R (the file format's
    alphabetical channel order), one scanline per block."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    chlist = b"".join(c + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", b"\0")
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    row_bytes = 3 * w * 4
    first = len(header) + 8 * h
    offsets = first + np.arange(h, dtype=np.uint64) * (8 + row_bytes)
    # per block: y, byte count, then each channel's scanline (B, G, R)
    planar = np.ascontiguousarray(img[:, :, ::-1].transpose(0, 2, 1))
    with open(path, "wb") as f:
        f.write(header + offsets.astype("<u8").tobytes())
        for y in range(h):
            f.write(struct.pack("<ii", y, row_bytes)
                    + planar[y].astype("<f4").tobytes())
