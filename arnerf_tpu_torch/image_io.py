"""Image files without an image library (the GPU machine has neither OpenCV
nor PIL nor imageio nor OpenEXR).

Writers in numpy: 8-bit PNG, and OpenEXR as OpenEXR's RGB interface writes
it (HALF channels, ZIP). Readers: PNG (colour types 0, 2, 3, 4 and 6;
depths 1, 2, 4, 8 and 16; `tRNS` accepted) and baseline / extended
sequential JPEG, each returning the array that `imageio.v2.imread` returns
for the file: 16-bit RGB(A) reduced to its high bytes, 16-bit gray+alpha as
8-bit RGBA, 1-bit gray as bool, 2- and 4-bit gray scaled to 0-255, palette
images as RGB, `tRNS`, gamma and EXIF orientation ignored. And OpenEXR:
single-part scanline files with R, G, B (and A) channels of type HALF or
FLOAT, compressed with NONE, RLE, ZIPS or ZIP, in either line order and
with any data window, read as float32 (H, W, 3|4) in RGB(A) order, the
values of the file's data window. The PNG and ZIP streams are inflated by
Python's zlib; the unfilter, the JPEG decoder and the EXR chunk decoding
(RLE, the byte predictor, HALF to float) are the port's native code
(csrc/dataio.cpp, built at first use), which runs many files on a pool of
threads without the GIL. Adam7-interlaced PNGs, progressive, lossless,
arithmetic-coded or CMYK JPEGs, and tiled, multi-part or deep OpenEXR
files, other EXR compressions (PIZ, PXR24, B44(A), DWAA/B) and EXR files
without R, G and B raise, naming the file and what it found.
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


EXR_MAGIC = b"\x76\x2f\x31\x01"
# compression codes of the file format, and the scanlines of one chunk for
# those the port reads
EXR_CODECS = ("NONE", "RLE", "ZIPS", "ZIP", "PIZ", "PXR24", "B44", "B44A",
              "DWAA", "DWAB")
_EXR_LINES = {0: 1, 1: 1, 2: 1, 3: 16}
_EXR_TYPES = {0: "UINT", 1: "HALF", 2: "FLOAT"}
_EXR_ERRORS = {10: "corrupt OpenEXR chunk (its data does not fill its "
                   "scanlines)",
               11: "inconsistent OpenEXR chunk layout"}


def _exr_predict(raw: bytes) -> bytes:
    """OpenEXR's ZIP/RLE preprocessing: the even bytes, then the odd ones,
    delta-coded (ImfZip.cpp)."""
    b = np.frombuffer(raw, np.uint8)
    t = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
    d = t.copy()
    d[1:] = (t[1:] - t[:-1] + 128) & 0xFF
    return d.astype(np.uint8).tobytes()


def write_exr(path, img):
    """img: (H, W, 3) float RGB -> a single-part scanline OpenEXR file as
    OpenEXR's RgbaOutputFile writes RGB by default: HALF channels B, G, R
    (the format's alphabetical order), ZIP compression in chunks of 16
    scanlines, a chunk that does not shrink stored raw. Values beyond
    HALF's range become infinities, as OpenEXR's conversion makes them."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    chlist = b"".join(c + b"\0" + struct.pack("<iB3xii", 1, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (EXR_MAGIC + struct.pack("<i", 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", b"\3")
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    # per scanline: each channel's w values (B, G, R)
    with np.errstate(over="ignore"):
        planar = np.ascontiguousarray(
            img[:, :, ::-1].transpose(0, 2, 1)).astype("<f2")
    chunks = []
    for y in range(0, h, 16):
        raw = planar[y:y + 16].tobytes()
        packed = zlib.compress(_exr_predict(raw), 6)
        chunks.append(struct.pack("<ii", y, min(len(packed), len(raw)))
                      + (packed if len(packed) < len(raw) else raw))
    offsets = len(header) + 8 * len(chunks) + np.cumsum(
        [0] + [len(c) for c in chunks[:-1]], dtype=np.uint64)
    with open(path, "wb") as f:
        f.write(header + offsets.astype("<u8").tobytes() + b"".join(chunks))


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


def _cstring(buf, pos, path):
    end = buf.find(b"\0", pos)
    if end < 0:
        raise ValueError(f"{path}: truncated OpenEXR header")
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_exr(path, buf):
    """Header fields and offset table of a single-part scanline OpenEXR
    file; raises for what the reader does not take."""
    if buf[:4] != EXR_MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    version = struct.unpack_from("<I", buf, 4)[0]
    if version & 0xFF != 2:
        raise ValueError(f"{path}: OpenEXR format version {version & 0xFF} "
                         f"is not supported")
    for bit, kind in ((0x1000, "multi-part"), (0x800, "deep"),
                      (0x200, "tiled")):
        if version & bit:
            raise ValueError(f"{path}: {kind} OpenEXR files are not "
                             f"supported, only single-part scanline images")
    pos, attrs = 8, {}
    while True:
        if pos >= len(buf):
            raise ValueError(f"{path}: truncated OpenEXR header")
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _cstring(buf, pos, path)
        _, pos = _cstring(buf, pos, path)
        size = struct.unpack_from("<i", buf, pos)[0]
        attrs[name] = buf[pos + 4:pos + 4 + size]
        pos += 4 + size
    for name in ("channels", "compression", "dataWindow"):
        if name not in attrs:
            raise ValueError(f"{path}: OpenEXR header without {name}")
    comp = attrs["compression"][0]
    if comp not in _EXR_LINES:
        found = EXR_CODECS[comp] if comp < len(EXR_CODECS) else comp
        raise ValueError(f"{path}: OpenEXR {found} compression is not "
                         f"supported, only NONE, RLE, ZIPS and ZIP")
    chlist, p, channels = attrs["channels"], 0, []
    while p < len(chlist) and chlist[p] != 0:
        name, p = _cstring(chlist, p, path)
        ptype, xs, ys = struct.unpack_from("<i4xii", chlist, p)
        p += 16
        if (xs, ys) != (1, 1):
            raise ValueError(f"{path}: OpenEXR channel {name} is subsampled "
                             f"({xs}, {ys})")
        channels.append((name, ptype))
    names = [c for c, _ in channels]
    if not {"R", "G", "B"} <= set(names):
        raise ValueError(f"{path}: OpenEXR channels {names} lack R, G or "
                         f"B; only RGB and RGBA images are supported")
    for name, ptype in channels:
        if name in ("R", "G", "B", "A") and ptype not in (1, 2):
            raise ValueError(f"{path}: OpenEXR channel {name} is of type "
                             f"{_EXR_TYPES.get(ptype, ptype)}; colour "
                             f"channels must be HALF or FLOAT")
    xmin, ymin, xmax, ymax = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    n_chunks = -(-h // _EXR_LINES[comp])
    if w <= 0 or h <= 0 or pos + 8 * n_chunks > len(buf):
        raise ValueError(f"{path}: truncated or empty OpenEXR file")
    offsets = np.frombuffer(buf, "<u8", n_chunks, pos).astype(np.int64)
    return {"w": w, "h": h, "ymin": ymin, "comp": comp,
            "channels": channels, "offsets": offsets}


def _prepare_exr(path):
    """Read one OpenEXR file and make its decoder job: the descriptor of
    csrc/dataio.cpp's exr_decode, then the chunks (ZIP: inflated here)."""
    with open(path, "rb") as f:
        buf = f.read()
    info = _parse_exr(path, buf)
    w, h, comp = info["w"], info["h"], info["comp"]
    lines = _EXR_LINES[comp]
    types = [t for _, t in info["channels"]]
    out_c = 4 if "A" in [c for c, _ in info["channels"]] else 3
    dst = ["RGBA".index(c) if c in ("R", "G", "B", "A") else -1
           for c, _ in info["channels"]]
    row_bytes = sum(w * (2 if t == 1 else 4) for t in types)
    n_chunks = len(info["offsets"])
    pos = 8 * (6 + 2 * len(types) + 4 * n_chunks)
    entries, payloads = [], []
    for off in info["offsets"]:
        if off <= 0 or off + 8 > len(buf):
            raise ValueError(f"{path}: incomplete OpenEXR file (chunk "
                             f"offset {off})")
        y, size = struct.unpack_from("<ii", buf, off)
        row0 = y - info["ymin"]
        data = buf[off + 8:off + 8 + size]
        if not 0 <= row0 < h or row0 % lines or size < 0 \
                or len(data) != size:
            raise ValueError(f"{path}: corrupt OpenEXR chunk at scanline {y}")
        raw_size = min(lines, h - row0) * row_bytes
        if comp == 0 or size == raw_size:     # stored raw
            codec = 0
        elif comp == 1:
            codec = 1
        else:
            codec = 2
            try:
                data = zlib.decompress(data)
            except zlib.error as e:
                raise ValueError(f"{path}: corrupt OpenEXR ZIP chunk at "
                                 f"scanline {y} ({e})") from None
        entries += [row0, codec, pos, len(data)]
        payloads.append(data)
        pos += len(data)
    desc = np.array([w, h, len(types), out_c, lines, n_chunks, *types, *dst,
                     *entries], "<i8")
    return _Job(path, 2, desc.tobytes() + b"".join(payloads),
                np.empty((h, w, out_c), np.float32))


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
        arr(ctypes.c_int64, [j.out.nbytes for j in jobs]),
        (ctypes.c_int64 * (3 * n))(*[v for j in jobs for v in j.params]),
        status, n_threads)
    for j, st in zip(jobs, status):
        if st:
            msg = ("corrupt PNG scanline (unknown filter type)"
                   if j.kind == 0 else _JPEG_ERRORS.get(st, st)
                   if j.kind == 1 else _EXR_ERRORS.get(st, st))
            raise ValueError(f"{j.path}: {msg}")


def _read_many(paths, prepare):
    """Prepare (read, inflate) the files on a pool of threads, one a core,
    decode them in one native call, and return their arrays."""
    n_threads = os.cpu_count() or 1
    with ThreadPoolExecutor(n_threads) as pool:
        jobs = list(pool.map(prepare, paths))
        _decode(jobs, n_threads)
        return list(pool.map(_Job.pixels, jobs))


def imread_many(paths):
    """The arrays `imageio.v2.imread` gives for many PNG / JPEG files; the
    files are read, inflated and decoded in parallel, one thread a core."""
    return _read_many(paths, _prepare)


def imread(path):
    """The array `imageio.v2.imread` gives for one PNG or JPEG file."""
    job = _prepare(path)
    _decode([job], 1)
    return job.pixels()


def read_exr_many(paths):
    """Many OpenEXR files as float32 (H, W, 3|4) RGB(A) arrays (see the
    module's docstring), read and decoded in parallel."""
    return _read_many(paths, _prepare_exr)


def read_exr(path):
    """One OpenEXR file as a float32 (H, W, 3|4) RGB(A) array."""
    job = _prepare_exr(path)
    _decode([job], 1)
    return job.out


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
