"""Dense segment sums: the hash-grid table gradient (port of
arnerf_tpu/ops/segments.py).

`segment_sum(idx, vals, num_rows, pack)` computes
    out[idx[m], f] += v(vals[m, f]),   v = bf16 rounding if pack else identity
in float32, skipping rows with idx < 0 or idx >= num_rows. idx is (M,) or
(N, G): N samples of G updates each, sample-major, with vals (N*G, F). The
grouped shape is the hash-grid backward's layout (G = levels x corners); it
lets the kernel merge runs of equal rows down each column. For CUDA tensors
it launches the hand-written sm_90a kernel csrc/segment_sum.cu, the
counterpart of the Pallas `_hist_kernel` (a one-hot MXU matmul on the TPU)
and of the reference CUDA extension's atomicAdd accumulation. For CPU tensors
it runs the plain version `_segment_sum_torch` (`index_add_`, same rounding),
and on a CUDA tensor it launches or raises. The wrapper counts its launches.

`pack=True` is the quantisation of `_hist_kernel` and of the TPU sort path's
bf16 lane packing (segments.py:199-205, 275-291); `pack=False` is exact f32.
`segment_sum` honours `pack` on every device (its CPU branch is the
kernel's plain version). The hash-grid backward (ops/hashgrid.py) calls it
directly on the table's global rows. `dense_segment_sum_batched` keeps the
JAX package's level-local API; it quantises on the card only: on the CPU it
is exact, as the JAX package's method="auto" is there (a plain scatter,
segments.py:46-48, 212-215), and so is the hash grid's CPU backward, so
CPU training matches the JAX package's CPU training.

The JAX package's sort/cumsum pipeline and its `method`, `stable` and `group`
knobs exist only because the TPU's scatter is row-serialised; Hopper
scatters with atomics, so they have no counterpart here. `dense_segment_max`
(the occupancy grid's scatter-max) is `scatter_reduce_(..., "amax")`: its
JAX counterpart is an XLA sort, not a Pallas kernel.
"""

import ctypes

import torch

from .. import build

MAX_COLS = 16

# kernel launches by mode since the last reset (plain version calls do not
# count)
launches = {"pack": 0, "exact": 0}


def reset_launches():
    launches.update(pack=0, exact=0)


def _segment_sum_torch(idx, vals, num_rows: int, pack: bool):
    """Plain version: idx (M,) or (N, G), vals (M, F) float32 ->
    (num_rows, F) float32."""
    idx = idx.reshape(-1)
    ok = (idx >= 0) & (idx < num_rows)
    v = vals.float()
    if pack:
        v = v.to(torch.bfloat16).float()
    out = torch.zeros((num_rows, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, idx[ok].long(), v[ok])


def _library():
    lib = build.load("segment_sum")
    fn = lib.arnerf_segment_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.arnerf_segment_sum_error_string.argtypes = [ctypes.c_int]
        lib.arnerf_segment_sum_error_string.restype = ctypes.c_char_p
    return lib


def _segment_sum_cuda(idx, vals, num_rows: int, pack: bool):
    dev = vals.device
    if idx.device != dev:
        raise ValueError(f"segment_sum: idx is on {idx.device}, vals on {dev}")
    if idx.dtype != torch.int32 or idx.ndim not in (1, 2) \
            or not idx.is_contiguous():
        raise ValueError("segment_sum: idx must be a contiguous 1-D or 2-D "
                         f"int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if vals.dtype != torch.float32 or vals.ndim != 2:
        raise ValueError("segment_sum: vals must be a 2-D float32 tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    m, f = vals.shape
    n, groups = idx.shape if idx.ndim == 2 else (idx.shape[0], 1)
    if idx.numel() != m:
        raise ValueError(f"segment_sum: {idx.numel()} rows of idx for {m} "
                         f"rows of vals")
    if not 1 <= f <= MAX_COLS:
        raise ValueError(f"segment_sum: {f} columns, the kernel takes 1 to "
                         f"{MAX_COLS}")
    if idx.data_ptr() % 4 or vals.data_ptr() % 4:
        raise ValueError("segment_sum: inputs must be 4-byte aligned")
    out = torch.zeros((num_rows, f), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.arnerf_segment_sum(
            idx.data_ptr(), vals.data_ptr(), vals.stride(0), vals.stride(1),
            n, groups, f, num_rows, int(pack), out.data_ptr(), stream)
    if err:
        raise RuntimeError("segment_sum launch failed: "
                           + lib.arnerf_segment_sum_error_string(err).decode())
    launches["pack" if pack else "exact"] += 1
    return out


def segment_sum(idx, vals, num_rows: int, pack: bool = False):
    """out[t] = sum of v(vals[m]) over idx[m] == t, (num_rows, F) float32.

    idx (M,) integer rows, or (N, G) for N samples of G updates each,
    sample-major (int32 and contiguous on CUDA); vals (N*G, F) float32, any
    strides. CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    if vals.device.type == "cpu":
        return _segment_sum_torch(idx, vals, num_rows, pack)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {vals.device}")
    return _segment_sum_cuda(idx, vals, num_rows, pack)


def dense_segment_sum(idx, vals, num_rows: int, pack: bool = False):
    """out[t] = sum of vals[i] where idx[i] == t; (num_rows, F) in vals'
    dtype. idx (M,), vals (M, F)."""
    out = segment_sum(idx.to(torch.int32), vals.float(), num_rows, pack)
    return out.to(vals.dtype)


def dense_segment_sum_batched(idx, val_cols, sizes, pack: bool = True):
    """Per-level segment sums written into the concatenated table.

    idx: (L, M) level-LOCAL rows (idx[l] in [0, sizes[l]));
    val_cols: F tensors (L, M), or one (F, L, M) tensor (taken without a
    copy); sizes: per-level row counts.
    Returns (sum(sizes), F), the hash-table layout of ops/hashgrid.py. Each
    level's offset is added to its rows and one call sums all L*M updates.
    pack=True rounds each update to bf16 on the card (see the module
    note)."""
    cols = val_cols if torch.is_tensor(val_cols) else torch.stack(val_cols)
    f, L, M = cols.shape
    offs, total = [], 0
    for s in sizes:
        offs.append(total)
        total += int(s)
    offsets = torch.tensor(offs, dtype=torch.int64, device=idx.device)
    flat = (idx.to(torch.int64) + offsets[:, None]).reshape(-1)
    vals = cols.reshape(f, L * M).float().t()                 # (L*M, F) view
    out = segment_sum(flat.to(torch.int32), vals, total,
                      pack and vals.device.type == "cuda")
    return out.to(cols.dtype)


def dense_segment_max(idx, vals, num_rows: int, fill=0.0):
    """out[t] = max of vals[i] where idx[i] == t (or `fill` if none)."""
    out = torch.full((num_rows,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx.long(), vals, reduce="amax",
                               include_self=True)
