"""Image files without an image library (the GPU machine has neither OpenCV
nor PIL nor imageio).

Writers in numpy: 8-bit PNG and uncompressed float OpenEXR. Readers: PNG
(colour types 0, 2, 3, 4 and 6; depths 1, 2, 4, 8 and 16; `tRNS` accepted)
and baseline / extended sequential JPEG, each returning the array that
`imageio.v2.imread` returns for the file: 16-bit RGB(A) reduced to its high
bytes, 16-bit gray+alpha as 8-bit RGBA, 1-bit gray as bool, 2- and 4-bit gray
scaled to 0-255, palette images as RGB, `tRNS`, gamma and EXIF orientation
ignored. The PNG stream is inflated by Python's zlib; the unfilter and the
JPEG decoder are the port's native code (csrc/dataio.cpp, built at first
use), which runs many files on a pool of threads without the GIL.
Adam7-interlaced PNGs and progressive, lossless, arithmetic-coded or CMYK
JPEGs raise, naming the file.
"""

import ctypes
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
_JPEG_ERRORS = {
    1: "corrupt or truncated JPEG stream",
    2: "progressive, lossless or arithmetic-coded JPEG (SOF2 and up) is not "
       "supported: only baseline and extended sequential Huffman JPEG",
    3: "only 1-component (gray) and 3-component (YCbCr or RGB) JPEGs are "
       "supported, not CMYK or YCCK",
    4: "JPEG chroma sampling other than 4:4:4, 4:2:2 or 4:2:0 is not "
       "supported",
    5: "not a JPEG stream",
    6: "only 8-bit JPEG samples are supported",
    7: "JPEG output buffer of the wrong size",
}


def _chunk(tag, data):
    body = tag + data
    return struct.pack(">I", len(data)) + body \
        + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _filter_rows(raw, bpp, filter_types):
    """PNG-filter the rows of raw (H, rowbytes) uint8, row y with
    filter_types[y % len(filter_types)]; returns (H, 1 + rowbytes)."""
    r = raw.astype(np.int16)
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    upleft = np.zeros_like(r)
    upleft[:, bpp:] = up[:, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = (np.zeros_like(r), left, up, (left + up) >> 1, paeth)
    kinds = np.asarray(filter_types)[np.arange(len(r)) % len(filter_types)]
    out = np.empty((len(r), r.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for k in set(kinds.tolist()):
        rows = kinds == k
        out[rows, 1:] = (r[rows] - preds[k][rows]).astype(np.uint8)
    return out


def write_png(path, img, filter_types=(0,)):
    """img: (H, W), (H, W, 3) or (H, W, 4) uint8 -> an 8-bit gray, RGB or
    RGBA PNG file. Rows are filtered with `filter_types` in rotation (0
    None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 3: 2, 4: 6}[channels]
    raw = _filter_rows(img.reshape(h, w * channels), channels, filter_types)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


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


# ------------------------------------------------------------- readers ---

def _lib():
    from . import build
    lib = build.load("dataio")
    if not getattr(lib, "_typed", False):
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.dataio_jpeg_header.argtypes = [p, i64, p, p, p]
        lib.dataio_jpeg_header.restype = i
        lib.dataio_decode_batch.argtypes = [i, p, p, p, p, p, p, p, i]
        lib.dataio_decode_batch.restype = i
        lib._typed = True
    return lib


class _Job:
    """One file on its way through the native decoder: the bytes it is
    given, the buffer it fills, and how that buffer becomes the array."""

    def __init__(self, path, kind, data, out, params=(0, 0, 0), png=None):
        self.path, self.kind, self.data = path, kind, data
        self.out, self.params, self.png = out, params, png

    def pixels(self):
        return _png_pixels(self.out, self.png) if self.kind == 0 \
            else self.out


def _parse_png(path, buf):
    """IHDR fields, palette and the concatenated IDAT stream of a PNG."""
    pos, idat, info, palette = 8, [], None, None
    while pos + 8 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            info = dict(zip(("w", "h", "depth", "ctype", "compression",
                             "filter", "interlace"),
                            struct.unpack(">IIBBBBB", data)))
        elif tag == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            n = min(len(data) // 3, 256) * 3
            pal = np.frombuffer(data, np.uint8)[:n].reshape(-1, 3)
            palette[:len(pal)] = pal
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if info is None or not idat:
        raise ValueError(f"{path}: malformed PNG (no IHDR or IDAT chunk)")
    if info["ctype"] not in _PNG_DEPTHS \
            or info["depth"] not in _PNG_DEPTHS[info["ctype"]]:
        raise ValueError(f"{path}: invalid PNG colour type {info['ctype']} "
                         f"at bit depth {info['depth']}")
    if info["interlace"]:
        raise ValueError(f"{path}: Adam7-interlaced PNG is not supported")
    if info["ctype"] == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    info["palette"] = palette
    return info, b"".join(idat)


def _png_pixels(rows, info):
    """Unfiltered rows (H, rowbytes) uint8 -> imageio's array for the file."""
    h, w, depth, ctype = info["h"], info["w"], info["depth"], info["ctype"]
    c = _PNG_CHANNELS[ctype]
    if depth == 16:
        v = rows.view(">u2").reshape(h, w, c)
        if ctype == 0:
            return v[..., 0].astype(np.uint16)
        hi = (v >> 8).astype(np.uint8)
        return hi[..., [0, 0, 0, 1]] if ctype == 4 else hi
    if depth == 8:
        v = rows.reshape(h, w, c)
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        v = (bits * weights).sum(-1, dtype=np.uint8)[:, :w, None]
    if ctype == 3:
        return info["palette"][v[..., 0]]
    if ctype == 0:
        g = v[..., 0]
        if depth == 1:
            return g.astype(bool)
        return g * np.uint8(255 // ((1 << depth) - 1))
    return np.ascontiguousarray(v)


def _prepare(path):
    """Read one file and make its decoder job (PNG: inflated here)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] == PNG_SIGNATURE:
        info, stream = _parse_png(path, buf)
        try:
            raw = zlib.decompress(stream)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt PNG data stream ({e})") \
                from None
        bits = _PNG_CHANNELS[info["ctype"]] * info["depth"]
        rowbytes = (info["w"] * bits + 7) // 8
        if len(raw) < info["h"] * (rowbytes + 1):
            raise ValueError(f"{path}: truncated PNG data stream")
        out = np.empty((info["h"], rowbytes), np.uint8)
        return _Job(path, 0, raw, out, (info["h"], rowbytes,
                                        max(1, bits // 8)), info)
    if buf[:2] == b"\xff\xd8":
        w, h, c = _jpeg_header(path, buf)
        out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
        return _Job(path, 1, buf, out)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def _jpeg_header(path, buf):
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    st = _lib().dataio_jpeg_header(buf, len(buf), ctypes.byref(w),
                                   ctypes.byref(h), ctypes.byref(c))
    if st:
        raise ValueError(f"{path}: {_JPEG_ERRORS.get(st, st)}")
    return w.value, h.value, c.value


def _decode(jobs, n_threads):
    """Run the jobs' native decoding in one call on n_threads threads."""
    n = len(jobs)
    if not n:
        return
    arr = lambda ctype, vals: (ctype * n)(*vals)  # noqa: E731
    ins = arr(ctypes.c_char_p, [j.data for j in jobs])
    status = (ctypes.c_int * n)()
    _lib().dataio_decode_batch(
        n, arr(ctypes.c_int, [j.kind for j in jobs]), ins,
        arr(ctypes.c_int64, [len(j.data) for j in jobs]),
        arr(ctypes.c_void_p, [j.out.ctypes.data for j in jobs]),
        arr(ctypes.c_int64, [j.out.size for j in jobs]),
        (ctypes.c_int64 * (3 * n))(*[v for j in jobs for v in j.params]),
        status, n_threads)
    for j, st in zip(jobs, status):
        if st:
            msg = (_JPEG_ERRORS.get(st, st) if j.kind else
                   "corrupt PNG scanline (unknown filter type)")
            raise ValueError(f"{j.path}: {msg}")


def imread_many(paths):
    """The arrays `imageio.v2.imread` gives for many PNG / JPEG files; the
    files are read, inflated and decoded in parallel, one thread a core."""
    n_threads = os.cpu_count() or 1
    with ThreadPoolExecutor(n_threads) as pool:
        jobs = list(pool.map(_prepare, paths))
        _decode(jobs, n_threads)
        return list(pool.map(_Job.pixels, jobs))


def imread(path):
    """The array `imageio.v2.imread` gives for one PNG or JPEG file."""
    job = _prepare(path)
    _decode([job], 1)
    return job.pixels()


def read_png(path):
    """A PNG file as imageio's array (see the module's docstring)."""
    with open(path, "rb") as f:
        if f.read(8) != PNG_SIGNATURE:
            raise ValueError(f"{path}: not a PNG file")
    return imread(path)


def read_jpeg(path):
    """A JPEG file as imageio's (H, W) gray or (H, W, 3) RGB uint8 array."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG file")
    return imread(path)


def image_size(path):
    """(width, height) of a PNG or JPEG file, from its header."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] == PNG_SIGNATURE:
        w, h = struct.unpack(">II", buf[16:24])
        return int(w), int(h)
    if buf[:2] == b"\xff\xd8":
        w, h, _ = _jpeg_header(path, buf)
        return w, h
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
