// Exact hash-grid encode, forward, for Hopper (sm_90a): all levels of the
// multiresolution grid in one launch.
//
// Replaces no TPU kernel: the JAX package computes this encode with plain
// XLA (arnerf_tpu/ops/hashgrid.py::_encode_fwd_impl), and so did the port
// (ops/hashgrid.py::_encode_fwd_impl, kept as the plain version). It was
// added because the plain version led the view's device time: it builds the
// rows and weights as (N, L, 8) int64 and float32 tensors, some thirty
// elementwise kernels over them, then a gather and a sum.
//
// It computes, for each sample n and level l (F = 2 features):
//   x     = clamp(x[n], 0, 1)                         (each axis)
//   pos   = fma(x, s_l, 0.5), rounded once            (s_l: float32 scale)
//   i0    = min(max(floor(pos), 0), res_l - 2);  frac = pos - i0
//   row_c = dense ? ix + iy*r + iz*r*r
//                 : (ix ^ iy*2654435761 ^ iz*805459861) & (T - 1)   (uint32)
//           + offset_l,     corner c = (i, j, k) in ops/hashgrid._CORNERS
//   out[n, l*F + f] = sum_c table[row_c, f] * ((wx * wy) * wz)
// in the plain version's operation order: each product rounded, no
// contraction into FMAs, the corners summed in order. A bfloat16 table
// rounds the weight to bf16, each product to bf16, sums in float32 and
// rounds the sum to bf16, as the plain version's bf16 tensor ops do.
//
// What bounds it on an H100: per sample it reads 12 B of position and
// writes L*F values (128 B in f32 at 16 levels), 140 B a row from HBM:
// 0.044 ms for 2^20 rows at 3.35 TB/s. Its real cost is the L*8 corner
// loads of 8 B (4 B in bf16) a sample from a table of up to 45.7 MB, which
// mostly fits the 50 MB L2: 128 random 32-B sectors a sample at 16 levels.
// The coarse levels are small and stay in L1; the fine ones miss it.
//
// Design: one thread per (sample, level), levels fastest, so the L threads
// of a sample share its position (one broadcast load) and write its output
// row as one contiguous run: a warp stores 256 B with 8-B (f32) or 4-B
// (bf16) vectors, fully coalesced. Each thread issues its 8 corner loads
// before it uses any (read-only path, __ldg), so 8 loads a thread are in
// flight; the x-neighbours ix, ix+1 are adjacent rows on dense levels, and
// on hashed levels where ix is even, so they share a sector. Indices and
// weights live in registers; nothing of (N, L, 8) reaches memory. The level
// constants (scale, resolution, offset, hashed flags) come by value in the
// launch's parameters (__grid_constant__, no copy to the device per call)
// and are staged in shared memory once a block. The kernel allocates
// nothing, launches on the caller's stream, and the C function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

}  // namespace

// The levels of a grid, filled by the caller (ops/hashgrid.py mirrors this
// layout with ctypes).
struct ArnerfHashLevels {
  float scale[kMaxLevels];       // float32 value of cfg.scales[l]
  uint32_t res[kMaxLevels];      // cfg.resolutions[l]
  uint32_t offset[kMaxLevels];   // cfg.offsets[l], the level's first row
  uint32_t hashed;               // bit l set: level l is hashed
  uint32_t table_mask;           // T - 1
  int32_t n_levels;
};

namespace {

struct F32Table {
  using Row = float2;
  using Out = float2;
  __device__ static float2 load(const void* t, uint32_t row) {
    return __ldg(static_cast<const float2*>(t) + row);
  }
  __device__ static void add(float2 f, float w, float& a0, float& a1) {
    a0 = __fadd_rn(a0, __fmul_rn(f.x, w));
    a1 = __fadd_rn(a1, __fmul_rn(f.y, w));
  }
  __device__ static float2 finish(float a0, float a1) {
    return make_float2(a0, a1);
  }
};

struct Bf16Table {
  using Row = __nv_bfloat162;
  using Out = __nv_bfloat162;
  __device__ static __nv_bfloat162 load(const void* t, uint32_t row) {
    return __ldg(static_cast<const __nv_bfloat162*>(t) + row);
  }
  // bf16(w); each product of two bf16 values is exact in float32, then
  // rounded to bf16, as a bf16 tensor multiply rounds it
  __device__ static void add(__nv_bfloat162 f, float w, float& a0,
                             float& a1) {
    const float wb = __bfloat162float(__float2bfloat16_rn(w));
    const float2 v = __bfloat1622float2(f);
    a0 = __fadd_rn(a0, __bfloat162float(__float2bfloat16_rn(
                           __fmul_rn(v.x, wb))));
    a1 = __fadd_rn(a1, __bfloat162float(__float2bfloat16_rn(
                           __fmul_rn(v.y, wb))));
  }
  __device__ static __nv_bfloat162 finish(float a0, float a1) {
    return __floats2bfloat162_rn(a0, a1);
  }
};

template <typename Table>
__device__ __forceinline__ void encode(const float* __restrict__ x,
                                       const void* __restrict__ table,
                                       void* __restrict__ out, int64_t n,
                                       const ArnerfHashLevels& lv) {
  __shared__ float s_scale[kMaxLevels];
  __shared__ uint32_t s_res[kMaxLevels];
  __shared__ uint32_t s_offset[kMaxLevels];
  const int L = lv.n_levels;
  if (threadIdx.x < L) {
    s_scale[threadIdx.x] = lv.scale[threadIdx.x];
    s_res[threadIdx.x] = lv.res[threadIdx.x];
    s_offset[threadIdx.x] = lv.offset[threadIdx.x];
  }
  __syncthreads();

  const int local = threadIdx.x / L;            // blockDim.x = per * L
  const int level = threadIdx.x - local * L;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * (blockDim.x / L) +
                    local;
  if (s >= n) return;

  const float sc = s_scale[level];
  const uint32_t r = s_res[level];
  const float hi = static_cast<float>(r - 2);
  uint32_t i0[3];
  float w1[3], w0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float xd = fminf(fmaxf(__ldg(x + 3 * s + d), 0.f), 1.f);
    const float pos = __fmaf_rn(xd, sc, 0.5f);
    const float f0 = fminf(fmaxf(floorf(pos), 0.f), hi);
    w1[d] = __fsub_rn(pos, f0);                 // frac
    w0[d] = __fsub_rn(1.f, w1[d]);
    i0[d] = static_cast<uint32_t>(f0);
  }

  // the two x, y and z terms of the row, corner bit 0 and 1
  const bool hashed = (lv.hashed >> level) & 1u;
  uint32_t tx[2], ty[2], tz[2];
  tx[0] = i0[0];
  tx[1] = i0[0] + 1u;
  if (hashed) {
    ty[0] = i0[1] * kPrimeY;
    ty[1] = ty[0] + kPrimeY;
    tz[0] = i0[2] * kPrimeZ;
    tz[1] = tz[0] + kPrimeZ;
  } else {
    ty[0] = i0[1] * r;
    ty[1] = ty[0] + r;
    tz[0] = i0[2] * (r * r);
    tz[1] = tz[0] + r * r;
  }
  const uint32_t off = s_offset[level];

  typename Table::Row f[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, k = c & 1;
    const uint32_t row = hashed ? (tx[i] ^ ty[j] ^ tz[k]) & lv.table_mask
                                : tx[i] + ty[j] + tz[k];
    f[c] = Table::load(table, row + off);
  }
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int i = c >> 2, j = (c >> 1) & 1, k = c & 1;
    const float w = __fmul_rn(__fmul_rn(i ? w1[0] : w0[0],
                                        j ? w1[1] : w0[1]),
                              k ? w1[2] : w0[2]);
    Table::add(f[c], w, a0, a1);
  }
  static_cast<typename Table::Out*>(out)[s * L + level] =
      Table::finish(a0, a1);
}

// Two entry points, not one template, so that a device trace names them
// apart.
__global__ void __launch_bounds__(kThreads)
hashgrid_encode_f32_kernel(const float* __restrict__ x,
                           const void* __restrict__ table,
                           void* __restrict__ out, int64_t n,
                           const __grid_constant__ ArnerfHashLevels lv) {
  encode<F32Table>(x, table, out, n, lv);
}

__global__ void __launch_bounds__(kThreads)
hashgrid_encode_bf16_kernel(const float* __restrict__ x,
                            const void* __restrict__ table,
                            void* __restrict__ out, int64_t n,
                            const __grid_constant__ ArnerfHashLevels lv) {
  encode<Bf16Table>(x, table, out, n, lv);
}

}  // namespace

// x (n, 3) float32; table (rows, 2) float32, or bfloat16 if bf16, every
// row the levels index below `rows`; out (n, n_levels * 2) in the table's
// type. Returns a cudaError_t (0 on success).
extern "C" int arnerf_hashgrid_encode(const float* x, const void* table,
                                      void* out, int64_t n,
                                      const ArnerfHashLevels* levels,
                                      int bf16, void* stream) {
  if (n <= 0) return 0;
  const int L = levels->n_levels;
  if (L < 1 || L > kMaxLevels) return cudaErrorInvalidValue;
  const int per = kThreads / L;                  // samples a block
  const int64_t blocks = (n + per - 1) / per;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    hashgrid_encode_bf16_kernel<<<static_cast<unsigned>(blocks), per * L, 0,
                                  s>>>(x, table, out, n, *levels);
  } else {
    hashgrid_encode_f32_kernel<<<static_cast<unsigned>(blocks), per * L, 0,
                                 s>>>(x, table, out, n, *levels);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* arnerf_hashgrid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
