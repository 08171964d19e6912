// Segment sum (scatter-add) for Hopper (sm_90a): the hash-grid table gradient.
//
// Replaces the Pallas TPU kernel arnerf_tpu/ops/segments.py::_hist_kernel
// (launched by mxu_segment_sum, reached from dense_segment_sum_batched). It
// computes
//   out[idx[m], f] += v(vals[m, f])      m < M, f < F <= 16
// with v = round-to-nearest-even bf16 in pack mode (the quantisation of
// _hist_kernel and of the TPU sort path's lane packing) and the value itself
// in exact mode. Rows with idx < 0 or idx >= num_rows are skipped, as
// _hist_kernel skips its -1 padding. Accumulation is float32. The caller
// zeroes `out`.
//
// The TPU kernel is a one-hot matmul on the MXU because the TPU has no fast
// scatter; the reference CUDA extension accumulates with atomicAdd. Hopper
// has fast atomics in L2, so this is the scatter itself: one thread per
// update row, one atomicAdd (a RED, the result is unused) per column.
//
// Bound on an H100 SXM: it moves each update once (idx 4 B + F values x 4 B)
// and writes the table once, 3.35 TB/s; at the training step's shapes
// (F = 2, 4.2 M updates with stochastic corners, 33.5 M exact) that is
// 0.03-0.13 ms. What bounds it in practice is contention: the dense coarse
// levels (level 0 has 4,096 rows) take one update per sample each, so many
// atomics land on few addresses and serialise in L2. Privatising the dense
// levels in shared memory, or sorting by row first, is later work. The order
// of the atomics differs between runs, so float32 sums differ in their last
// bits from run to run.
//
// vals is read through two strides, so both an (M, F) row-major array and
// F columns of one (F, M) array are taken without a copy. Plain C interface,
// loaded with ctypes; the launch goes on the caller's stream and the
// function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;

template <bool kPack>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ idx,
                   const float* __restrict__ vals, int64_t stride_m,
                   int64_t stride_f, int64_t m_total, int n_cols,
                   int64_t num_rows, float* __restrict__ out) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= m_total) return;
  const int64_t row = idx[m];
  if (row < 0 || row >= num_rows) return;
  const float* v = vals + m * stride_m;
  float* o = out + row * n_cols;
  for (int f = 0; f < n_cols; ++f) {
    float x = v[f * stride_f];
    if constexpr (kPack) {
      x = __bfloat162float(__float2bfloat16_rn(x));
    }
    atomicAdd(o + f, x);
  }
}

}  // namespace

// idx (m,) int32 table rows; vals[i * stride_m + f * stride_f] float32;
// out (num_rows, n_cols) float32, zeroed by the caller. pack selects bf16
// rounding of each value. Returns a cudaError_t (0 on success).
extern "C" int arnerf_segment_sum(const int32_t* idx, const float* vals,
                                  int64_t stride_m, int64_t stride_f,
                                  int64_t m, int n_cols, int64_t num_rows,
                                  int pack, float* out, void* stream) {
  if (m <= 0) return 0;
  if (n_cols < 1 || n_cols > kMaxCols) return cudaErrorInvalidValue;
  const int64_t blocks = (m + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack) {
    segment_sum_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        idx, vals, stride_m, stride_f, m, n_cols, num_rows, out);
  } else {
    segment_sum_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        idx, vals, stride_m, stride_f, m, n_cols, num_rows, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* arnerf_segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
