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
// scatter; Hopper has atomics in L2, so this is the scatter itself.
//
// Bound on an H100 SXM: it moves each update once (idx 4 B + F values x 4 B)
// and writes the table once, 3.35 TB/s; at the training step's shapes
// (F = 2, 4.2 M updates with stochastic corners, 33.5 M exact) that is
// 0.03-0.13 ms. What bounds a plain one-atomic-per-value scatter is
// contention: the dense coarse levels (level 0 has 4,096 rows) take one
// update per sample each, and consecutive samples along a ray fall in the
// same coarse cell, so many atomics in flight hit one address and
// serialise in L2 (the earlier design, one thread per update and F scalar
// atomics, was 1.15-1.17x slower than index_add_).
//
// Design: the updates come as N samples of G updates each, sample-major
// (idx (N, G), a 1-D idx is G = 1), the layout of the hash-grid backward:
// G = levels x corners. A block loads a tile of 32R consecutive samples x C
// columns (C = min(G, 8)) into shared memory with coalesced loads (16-B
// vectors where the layout allows), rows padded to an odd word stride so
// that column reads are free of bank conflicts. Blocks take the column
// chunks one after another (all samples of chunk 0 first): in the path's
// sample-major order the atomics in flight would otherwise spread over
// every level's rows, the whole 45.7 MB table, and miss L2; one chunk of
// one level keeps them in its 4 MB. Each warp then walks one column
// (one level and corner) across 32 consecutive samples: equal rows sit in
// runs there. A lane is a run's head where its row differs from the
// previous lane's (__shfl_up_sync); a segmented shuffle scan sums each
// run's values (bf16-rounded first in pack mode), and the run's last lane
// issues one atomic for all F columns: a float2 vector atomic for F = 2, a
// float4 one where F % 4 == 0, scalar atomics otherwise. Runs that cross
// a 32-sample boundary take one atomic on each side. The order of the
// atomics differs between runs, so float32 sums differ in their last bits
// from run to run.
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
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;
// A tile is 32 * R samples x C columns with R * C * (1 + F) <= kTileWords
// (R <= kMaxGroups), plus one word of padding a sample for idx and for vals.
constexpr int kTileWords = 256;
constexpr int kMaxGroups = 8;
constexpr int kSmemWords = 32 * (kTileWords + 2 * kMaxGroups);
constexpr int kChunk = 8;            // columns of one tile (at most)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// kF: 2 (the hash grid's two features), else 0 (F read from n_cols, up to
// 16).
// kVec: idx and vals rows are loaded as 16-B vectors (the host checks the
// layout and alignment).
template <int kF, bool kPack, bool kVec>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const int32_t* __restrict__ idx,
                   const float* __restrict__ vals, int64_t stride_m,
                   int64_t stride_f, int64_t n_samples, int groups,
                   int n_cols, int64_t num_rows, int tile_cols,
                   int tile_groups, float* __restrict__ out) {
  constexpr int kRegs = kF ? kF : kMaxCols;
  const int F = kF ? kF : n_cols;
  __shared__ float smem[kSmemWords];

  // column chunks are the slow index: the blocks resident at one time work
  // on one chunk (one level of the hash grid), whose table rows stay in L2
  const int64_t tiles = (n_samples + 32 * tile_groups - 1) / (32 * tile_groups);
  const int64_t s0 = (blockIdx.x % tiles) * 32 * tile_groups;
  const int g0 = static_cast<int>(blockIdx.x / tiles) * tile_cols;
  const int cw = min(tile_cols, groups - g0);            // columns here
  const int S = 32 * tile_groups;                        // samples here
  const int sn = static_cast<int>(min(static_cast<int64_t>(S), n_samples - s0));
  const int pi = cw | 1;                                 // odd word strides
  const int pv = (cw * F) | 1;
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem);
  float* s_val = smem + S * pi;

  // ---- load the tile: idx (S, cw) and vals (S, cw * F) --------------------
  if constexpr (kVec) {
    const int q = cw / 4;
    for (int e = threadIdx.x; e < S * q; e += kThreads) {
      const int s = e / q, c = 4 * (e - s * q);
      int4 v = make_int4(-1, -1, -1, -1);
      if (s < sn)
        v = __ldg(reinterpret_cast<const int4*>(idx + (s0 + s) * groups + g0 +
                                                c));
      int32_t* d = s_idx + s * pi + c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
    const int qv = cw * F / 4;
    for (int e = threadIdx.x; e < sn * qv; e += kThreads) {
      const int s = e / qv, c = 4 * (e - s * qv);
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          vals + ((s0 + s) * groups + g0) * F + c));
      float* d = s_val + s * pv + c;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < S * cw; e += kThreads) {
      const int s = e / cw, c = e - s * cw;
      s_idx[s * pi + c] = s < sn ? __ldg(idx + (s0 + s) * groups + g0 + c) : -1;
    }
    const int w = cw * F;
    for (int e = threadIdx.x; e < sn * w; e += kThreads) {
      const int s = e / w, r = e - s * w;
      const int c = r / F, f = r - c * F;
      s_val[s * pv + r] =
          __ldg(vals + ((s0 + s) * groups + g0 + c) * stride_m + f * stride_f);
    }
  }
  __syncthreads();

  // ---- each warp: one column across 32 samples; merge runs of equal rows ---
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = warp; item < tile_groups * cw; item += kWarps) {
    const int grp = item / cw, c = item - grp * cw;
    const int s = 32 * grp + lane;
    int row = s_idx[s * pi + c];
    const bool ok = row >= 0 && row < num_rows;
    if (!ok) row = -1;
    float v[kRegs];
#pragma unroll
    for (int f = 0; f < kRegs; ++f) {
      if (kF || f < F) {
        const float x = ok ? s_val[s * pv + c * F + f] : 0.f;
        v[f] = kPack ? bf16_round(x) : x;
      }
    }
    const int prev = __shfl_up_sync(kFull, row, 1);
    const int next = __shfl_down_sync(kFull, row, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != row);
    const bool tail = lane == 31 || next != row;
    if (heads != kFull) {   // some run is longer than one update
      const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const bool take = lane - d >= start;
#pragma unroll
        for (int f = 0; f < kRegs; ++f) {
          if (kF || f < F) {
            const float u = __shfl_up_sync(kFull, v[f], d);
            if (take) v[f] += u;
          }
        }
      }
    }
    if (tail && row >= 0) {
      float* o = out + static_cast<int64_t>(row) * F;
      if constexpr (kF == 2) {
        atomicAdd(reinterpret_cast<float2*>(o), make_float2(v[0], v[1]));
      } else {
        if (F % 4 == 0) {
#pragma unroll
          for (int f = 0; f < kRegs; f += 4)
            if (f < F)
              atomicAdd(reinterpret_cast<float4*>(o + f),
                        make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]));
        } else {
#pragma unroll
          for (int f = 0; f < kRegs; ++f)
            if (f < F) atomicAdd(o + f, v[f]);
        }
      }
    }
  }
}

template <int kF, bool kPack>
void launch(bool vec, unsigned blocks, cudaStream_t s, const int32_t* idx,
            const float* vals, int64_t stride_m, int64_t stride_f,
            int64_t n, int groups, int n_cols, int64_t num_rows, int cols,
            int tile_groups, float* out) {
  if (vec) {
    segment_sum_kernel<kF, kPack, true><<<blocks, kThreads, 0, s>>>(
        idx, vals, stride_m, stride_f, n, groups, n_cols, num_rows, cols,
        tile_groups, out);
  } else {
    segment_sum_kernel<kF, kPack, false><<<blocks, kThreads, 0, s>>>(
        idx, vals, stride_m, stride_f, n, groups, n_cols, num_rows, cols,
        tile_groups, out);
  }
}

template <bool kPack>
void launch_f(int n_cols, bool vec, unsigned blocks, cudaStream_t s,
              const int32_t* idx, const float* vals, int64_t stride_m,
              int64_t stride_f, int64_t n, int groups, int64_t num_rows,
              int cols, int tile_groups, float* out) {
  if (n_cols == 2) {
    launch<2, kPack>(vec, blocks, s, idx, vals, stride_m, stride_f, n,
                     groups, n_cols, num_rows, cols, tile_groups, out);
  } else {
    launch<0, kPack>(vec, blocks, s, idx, vals, stride_m, stride_f, n,
                     groups, n_cols, num_rows, cols, tile_groups, out);
  }
}

}  // namespace

// idx (n, groups) int32 table rows, sample-major (n * groups updates);
// vals[m * stride_m + f * stride_f] float32 for update m; out (num_rows,
// n_cols) float32, zeroed by the caller. pack selects bf16 rounding of each
// value. Returns a cudaError_t (0 on success).
extern "C" int arnerf_segment_sum(const int32_t* idx, const float* vals,
                                  int64_t stride_m, int64_t stride_f,
                                  int64_t n, int groups, int n_cols,
                                  int64_t num_rows, int pack, float* out,
                                  void* stream) {
  if (n <= 0 || groups <= 0) return 0;
  if (n_cols < 1 || n_cols > kMaxCols) return cudaErrorInvalidValue;
  // tile: 32 * tile_groups samples x cols columns, tile_groups * cols *
  // (1 + F) <= kTileWords. kChunk columns are 32 B of idx a sample (whole
  // sectors) and one level's 8 corners in exact mode.
  const int cols = groups < kChunk ? groups : kChunk;
  int tile_groups = kTileWords / (cols * (1 + n_cols));
  if (tile_groups > kMaxGroups) tile_groups = kMaxGroups;
  const int64_t samples = 32 * tile_groups;
  const int64_t chunks = (groups + cols - 1) / cols;
  const int64_t blocks = (n + samples - 1) / samples * chunks;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool vec = groups % 4 == 0 && cols % 4 == 0 && stride_f == 1 &&
                   stride_m == n_cols &&
                   reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pack) {
    launch_f<true>(n_cols, vec, static_cast<unsigned>(blocks), s, idx, vals,
                   stride_m, stride_f, n, groups, num_rows, cols, tile_groups,
                   out);
  } else {
    launch_f<false>(n_cols, vec, static_cast<unsigned>(blocks), s, idx, vals,
                    stride_m, stride_f, n, groups, num_rows, cols, tile_groups,
                    out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* arnerf_segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
