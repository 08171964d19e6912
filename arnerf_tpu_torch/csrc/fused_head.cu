// Fused NGP field head for Hopper (sm_90a), forward only.
//
// Replaces the Pallas TPU kernel arnerf_tpu/ops/fused_head.py::_head_kernel
// (launched by _head_pallas, public API fused_field_head). Per row it computes
//   h       = relu(feats @ W0) @ W1                            32 -> 64 -> 16
//   rgb_raw = relu(relu(sh @ V0[:16] + h @ V0[16:]) @ V1) @ V2  32 -> 64 -> 64 -> 3
// with operands rounded to the compute type at each layer input and every
// product summed in float32. Output activations stay outside the kernel.
//
// Cast points (bf16 mode), exactly those of _head_kernel: feats, each weight
// matrix, relu(feats @ W0), sh, h (before the V0[16:] product), and both rgb
// hidden activations are rounded with __float2bfloat16_rn; h itself is
// written in float32. A product of two bf16 values is exact in float32, so
// the bf16 dot with f32 accumulation is the same function on the tensor
// cores as on the CUDA cores; only the order of the f32 sums differs.
//
// Bound on an H100 SXM: 2 * 9,408 = 18.8 kFLOP a row. A bf16-feature row
// moves 204 B (feats 64, sh 64, h 64, rgb 12): at 2^18 rows 53 MB, 0.016 ms
// at 3.35 TB/s, against 0.005 ms of bf16 tensor-core work at 989 TFLOP/s.
// On the tensor cores the kernel is memory-bound; on the CUDA cores
// (67 TFLOP/s f32) it is compute-bound (0.074 ms of FMAs at 2^18 rows).
//
// bf16 mode: tensor cores (mma.sync.m16n8k16, bf16 in, f32 accumulate).
//   * Persistent blocks of 8 warps, as many as fit on the card, loop over
//     16-row tiles; each warp computes a whole tile, 76 MMAs: W0 16, W1 8,
//     V0 16 (one k16 chunk of sh, one of h), V1 32, V2 4 (padded to 8 wide).
//   * The weights are staged once per block in shared memory, rounded to
//     bf16 and transposed (output-major), rows padded by 16 B so that the
//     eight 16-B rows an ldmatrix phase reads fall in distinct banks. B
//     fragments come from ldmatrix inside the tile loop (asm volatile, so
//     the compiler cannot hoist 147 registers of weights out of the loop
//     and spill them, as it did with the first CUDA-core build).
//   * Activations never leave registers: the f32 accumulators of two
//     adjacent n8 tiles are, after relu and bf16 rounding, the A fragment
//     of one k16 chunk of the next layer (FullyFusedMLP's trick).
//   * Inputs: each lane loads one 16-B vector a row (bf16 feats: columns
//     8t..8t+7; f32 feats: 4t..4t+3 and 16+4t..; sh: 4t..4t+3) and uses it
//     directly as A fragment registers. That fixes a permutation of the k
//     order, which the staging applies to the rows of W0 and V0[:16]. The
//     next tile's inputs are loaded while this one computes.
//   * Outputs: h (64 B a row) and rgb (12 B a row) go through a per-warp
//     shared-memory tile and leave as coalesced 16-B stores. Rows past n
//     (the ragged tail) are loaded as zeros and never stored.
//   Earlier design (CUDA cores, one row a thread, 168 registers): at 2^18
//   rows 0.254 ms, 2^21+3 rows 1.79 ms on an H100 80GB HBM3, 700 W, slower
//   than the cuBLAS chain (0.21 ms); PERF.md holds this design's times.
//
// f32 mode: CUDA cores, the earlier design, kept because TF32 tensor cores
// would change f32 results. Each block stages all five weight matrices
// (9,408 floats) in shared memory; each thread owns one row and keeps its
// 64-wide activations in registers; every weight read is a shared-memory
// broadcast.
// There is deliberately no grid-stride loop: with one, the compiler hoists
// the loop-invariant shared-memory weights into registers and spills ~37 KB
// a thread (255 registers, 28 ms at 2M rows).
//
// The gradient recomputes through the plain version (ops/fused_head.py).
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the function returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIn = 32;     // hash-grid features (16 levels x 2)
constexpr int kHid = 64;    // hidden width of both MLPs
constexpr int kSig = 16;    // sigma-net output width
constexpr int kSh = 16;     // SH degree-4 basis
constexpr int kRgb = 3;
constexpr int kW0 = kIn * kHid;            // 2048
constexpr int kW1 = kHid * kSig;           // 1024
constexpr int kV0 = (kSh + kSig) * kHid;   // 2048
constexpr int kV1 = kHid * kHid;           // 4096
constexpr int kV2 = kHid * kRgb;           // 192
constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// f32 mode: CUDA cores
// ---------------------------------------------------------------------------

// acc[0:N] += a * W[row, 0:N] for a row of a shared-memory matrix whose
// width N is a multiple of 4 (float4 broadcast reads).
template <int N>
__device__ __forceinline__ void axpy_row(float a, const float* __restrict__ w,
                                         float* acc) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float4 v = w4[j];
    acc[4 * j + 0] = fmaf(a, v.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(a, v.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(a, v.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(a, v.w, acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
fused_head_f32_kernel(const float* __restrict__ feats,
                      const float* __restrict__ sh,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ v0,
                      const float* __restrict__ v1,
                      const float* __restrict__ v2, float* __restrict__ h_out,
                      float* __restrict__ rgb_out, int64_t n) {
  __shared__ __align__(16) float sW0[kW0];
  __shared__ __align__(16) float sW1[kW1];
  __shared__ __align__(16) float sV0[kV0];
  __shared__ __align__(16) float sV1[kV1];
  __shared__ __align__(16) float sV2[kV2];
  stage(sW0, w0, kW0);
  stage(sW1, w1, kW1);
  stage(sV0, v0, kV0);
  stage(sV1, v1, kV1);
  stage(sV2, v2, kV2);
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row < n) {
    // ---- sigma net: a = relu(feats @ W0); h = a @ W1 ----------------------
    float x[kIn];
    const float4* f4 = reinterpret_cast<const float4*>(feats + row * kIn);
#pragma unroll
    for (int i = 0; i < kIn / 4; ++i) {
      float4 v = f4[i];
      x[4 * i + 0] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
    float a[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) a[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kIn; ++k) axpy_row<kHid>(x[k], sW0 + k * kHid, a);
#pragma unroll
    for (int j = 0; j < kHid; ++j) a[j] = fmaxf(a[j], 0.f);

    float h[kSig];
#pragma unroll
    for (int j = 0; j < kSig; ++j) h[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) axpy_row<kSig>(a[k], sW1 + k * kSig, h);
    float4* h4 = reinterpret_cast<float4*>(h_out + row * kSig);
#pragma unroll
    for (int j = 0; j < kSig / 4; ++j)
      h4[j] = make_float4(h[4 * j], h[4 * j + 1], h[4 * j + 2], h[4 * j + 3]);

    // ---- rgb net: r = relu(sh @ V0[:16] + h @ V0[16:]) ---------------------
    float r[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) r[j] = 0.f;
    const float4* s4 = reinterpret_cast<const float4*>(sh + row * kSh);
#pragma unroll
    for (int i = 0; i < kSh / 4; ++i) {
      float4 s = s4[i];
      axpy_row<kHid>(s.x, sV0 + (4 * i + 0) * kHid, r);
      axpy_row<kHid>(s.y, sV0 + (4 * i + 1) * kHid, r);
      axpy_row<kHid>(s.z, sV0 + (4 * i + 2) * kHid, r);
      axpy_row<kHid>(s.w, sV0 + (4 * i + 3) * kHid, r);
    }
#pragma unroll
    for (int k = 0; k < kSig; ++k)
      axpy_row<kHid>(h[k], sV0 + (kSh + k) * kHid, r);
#pragma unroll
    for (int j = 0; j < kHid; ++j) r[j] = fmaxf(r[j], 0.f);

    // ---- r2 = relu(r @ V1); rgb = r2 @ V2 ----------------------------------
    float r2[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) r2[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) axpy_row<kHid>(r[k], sV1 + k * kHid, r2);
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) {
      const float rk = fmaxf(r2[k], 0.f);
      c0 = fmaf(rk, sV2[k * kRgb + 0], c0);
      c1 = fmaf(rk, sV2[k * kRgb + 1], c1);
      c2 = fmaf(rk, sV2[k * kRgb + 2], c2);
    }
    float* o = rgb_out + row * kRgb;
    o[0] = c0;
    o[1] = c1;
    o[2] = c2;
  }
}

// ---------------------------------------------------------------------------
// bf16 mode: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kTcThreads = kWarps * 32;
constexpr int kTile = 16;          // rows of one MMA tile
constexpr int kS32 = 32 + 8;       // smem row stride (bf16) of a K = 32 matrix
constexpr int kS64 = 64 + 8;       // smem row stride (bf16) of a K = 64 matrix
constexpr int kHS = kSig + 4;      // smem row stride (f32) of the h staging
constexpr int kMaxDevices = 64;

// Transposed bf16 weights (row n holds output n's K inputs in slot order)
// and each warp's output staging.
struct __align__(16) TcSmem {
  __nv_bfloat16 w0[kHid * kS32];
  __nv_bfloat16 w1[kSig * kS64];
  __nv_bfloat16 v0[kHid * kS32];
  __nv_bfloat16 v1[kHid * kS64];
  __nv_bfloat16 v2[8 * kS64];      // 3 outputs, zero-padded to 8
  float h[kWarps][kTile * kHS];
  float rgb[kWarps][kTile * kRgb];
};

// Slot (k position inside the MMA chunks) of input column p when a lane
// holds, for its row, 8 values v0..v7 taken as: chunk 0 a-pair (2t, 2t+1) =
// v0 v1, chunk 0 (2t+8, 2t+9) = v2 v3, chunk 1 likewise = v4..v7.
__device__ __forceinline__ int slot_of(int t, int v) {
  const int c = v >> 2, vv = v & 3;
  return 16 * c + (vv < 2 ? 2 * t + vv : 8 + 2 * t + (vv - 2));
}
// bf16 feats: lane t holds columns 8t..8t+7 (one 16-B load).
__device__ __forceinline__ int slot_feats_bf16(int p) {
  return slot_of(p >> 3, p & 7);
}
// f32 feats and sh: lane t holds columns 4t..4t+3 (and 16+4t..16+4t+3).
__device__ __forceinline__ int slot_feats_f32(int p) {
  return slot_of((p & 15) >> 2, 4 * (p >> 4) + (p & 3));
}

// dst[n * stride + slot(k)] = bf16(src[k * n_out + n]); coalesced reads.
template <typename Slot>
__device__ __forceinline__ void stage_t(__nv_bfloat16* __restrict__ dst,
                                        int stride,
                                        const float* __restrict__ src,
                                        int n_in, int n_out, Slot slot) {
  for (int i = threadIdx.x; i < n_in * n_out; i += kTcThreads) {
    const int k = i / n_out, c = i - k * n_out;
    dst[c * stride + slot(k)] = __float2bfloat16_rn(src[i]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4],
                                        const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] (NT n8 tiles) += A (16 x 16*KC, KC k16 chunks) @ W, with W^T in
// shared memory at wt (row stride S). One ldmatrix.x4 feeds two MMAs: two n
// tiles of one chunk, or (NT == 1) one n tile of two chunks.
template <int KC, int NT, int S>
__device__ __forceinline__ void gemm(float (&acc)[NT][4],
                                     const uint32_t (&a)[KC][4],
                                     const __nv_bfloat16* wt, int lane) {
  const int q = lane >> 3, r = lane & 7;
  uint32_t b[4];
  if constexpr (NT % 2 == 0) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        ldsm_x4(b, wt + (8 * (j + (q >> 1)) + r) * S + 16 * kc + 8 * (q & 1));
        mma_bf16(acc[j], a[kc], b[0], b[1]);
        mma_bf16(acc[j + 1], a[kc], b[2], b[3]);
      }
    }
  } else {
    static_assert(NT == 1 && KC % 2 == 0, "one n tile takes chunk pairs");
#pragma unroll
    for (int kc = 0; kc < KC; kc += 2) {
      ldsm_x4(b, wt + r * S + 16 * (kc + (q >> 1)) + 8 * (q & 1));
      mma_bf16(acc[0], a[kc], b[0], b[1]);
      mma_bf16(acc[0], a[kc + 1], b[2], b[3]);
    }
  }
}

// The accumulators of n tiles 2c and 2c+1, through relu and bf16 rounding,
// are the A fragment of k chunk c of the next layer.
template <int NT>
__device__ __forceinline__ void relu_to_a(uint32_t (&a)[NT / 2][4],
                                          const float (&acc)[NT][4]) {
#pragma unroll
  for (int c = 0; c < NT / 2; ++c) {
    a[c][0] = pack_bf16(fmaxf(acc[2 * c][0], 0.f), fmaxf(acc[2 * c][1], 0.f));
    a[c][1] = pack_bf16(fmaxf(acc[2 * c][2], 0.f), fmaxf(acc[2 * c][3], 0.f));
    a[c][2] = pack_bf16(fmaxf(acc[2 * c + 1][0], 0.f),
                        fmaxf(acc[2 * c + 1][1], 0.f));
    a[c][3] = pack_bf16(fmaxf(acc[2 * c + 1][2], 0.f),
                        fmaxf(acc[2 * c + 1][3], 0.f));
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// One lane's inputs of one tile: rows g and g+8 of the tile.
template <typename TF>
struct TileIn;

template <>
struct TileIn<__nv_bfloat16> {
  uint4 f[2];
  float4 s[2];
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ feats,
                                       const float* __restrict__ sh,
                                       int64_t row, int64_t n, int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t r = row + 8 * i;
      f[i] = r < n ? __ldg(reinterpret_cast<const uint4*>(feats + r * kIn) + t)
                   : make_uint4(0, 0, 0, 0);
      s[i] = r < n ? __ldg(reinterpret_cast<const float4*>(sh + r * kSh) + t)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void feats_a(uint32_t (&a)[2][4]) const {
    a[0][0] = f[0].x; a[0][1] = f[1].x; a[0][2] = f[0].y; a[0][3] = f[1].y;
    a[1][0] = f[0].z; a[1][1] = f[1].z; a[1][2] = f[0].w; a[1][3] = f[1].w;
  }
};

template <>
struct TileIn<float> {
  float4 f[2][2];
  float4 s[2];
  __device__ __forceinline__ void load(const float* __restrict__ feats,
                                       const float* __restrict__ sh,
                                       int64_t row, int64_t n, int t) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t r = row + 8 * i;
      const float4* p = reinterpret_cast<const float4*>(feats + r * kIn);
      f[i][0] = r < n ? __ldg(p + t) : z;
      f[i][1] = r < n ? __ldg(p + 4 + t) : z;
      s[i] = r < n ? __ldg(reinterpret_cast<const float4*>(sh + r * kSh) + t)
                   : z;
    }
  }
  __device__ __forceinline__ void feats_a(uint32_t (&a)[2][4]) const {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      a[c][0] = pack_bf16(f[0][c].x, f[0][c].y);
      a[c][1] = pack_bf16(f[1][c].x, f[1][c].y);
      a[c][2] = pack_bf16(f[0][c].z, f[0][c].w);
      a[c][3] = pack_bf16(f[1][c].z, f[1][c].w);
    }
  }
};

template <typename TF>
__global__ void __launch_bounds__(kTcThreads, 2)
fused_head_tc_kernel(const TF* __restrict__ feats, const float* __restrict__ sh,
                     const float* __restrict__ w0, const float* __restrict__ w1,
                     const float* __restrict__ v0, const float* __restrict__ v1,
                     const float* __restrict__ v2, float* __restrict__ h_out,
                     float* __restrict__ rgb_out, int64_t n) {
  __shared__ TcSmem sm;
  constexpr bool kBf16Feats = sizeof(TF) == 2;
  auto ident = [](int p) { return p; };
  stage_t(sm.w0, kS32, w0, kIn, kHid, [](int p) {
    return kBf16Feats ? slot_feats_bf16(p) : slot_feats_f32(p);
  });
  stage_t(sm.w1, kS64, w1, kHid, kSig, ident);
  stage_t(sm.v0, kS32, v0, kSh + kSig, kHid,
          [](int p) { return p < kSh ? slot_feats_f32(p) : p; });
  stage_t(sm.v1, kS64, v1, kHid, kHid, ident);
  for (int i = threadIdx.x; i < 8 * kS64; i += kTcThreads)
    sm.v2[i] = __float2bfloat16_rn(0.f);
  __syncthreads();
  stage_t(sm.v2, kS64, v2, kHid, kRgb, ident);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* hs = sm.h[warp];
  float* rs = sm.rgb[warp];
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  TileIn<TF> next;
  if (tile < tiles) next.load(feats, sh, tile * kTile + g, n, t);

#pragma unroll 1
  for (; tile < tiles; tile += step) {
    const TileIn<TF> in = next;
    const int64_t row0 = tile * kTile;
    if (tile + step < tiles)
      next.load(feats, sh, (tile + step) * kTile + g, n, t);

    // ---- sigma net: a1 = bf16(relu(feats @ W0)); h = a1 @ W1 --------------
    uint32_t a_in[2][4];
    in.feats_a(a_in);
    float acc[8][4];
    zero(acc);
    gemm<2, 8, kS32>(acc, a_in, sm.w0, lane);
    uint32_t a_hid[4][4];
    relu_to_a(a_hid, acc);
    float hacc[2][4];
    zero(hacc);
    gemm<4, 2, kS64>(hacc, a_hid, sm.w1, lane);

    // h leaves in f32 through the warp's staging tile, 16 B a lane
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float2*>(hs + g * kHS + 8 * j + 2 * t) =
          make_float2(hacc[j][0], hacc[j][1]);
      *reinterpret_cast<float2*>(hs + (g + 8) * kHS + 8 * j + 2 * t) =
          make_float2(hacc[j][2], hacc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < kTile * kSig / 4; i += 32) {
      const int r = i >> 2, q = i & 3;
      if (row0 + r < n)
        reinterpret_cast<float4*>(h_out + (row0 + r) * kSig)[q] =
            *reinterpret_cast<const float4*>(hs + r * kHS + 4 * q);
    }

    // ---- rgb net: A = [bf16(sh) | bf16(h)] --------------------------------
    a_in[0][0] = pack_bf16(in.s[0].x, in.s[0].y);
    a_in[0][1] = pack_bf16(in.s[1].x, in.s[1].y);
    a_in[0][2] = pack_bf16(in.s[0].z, in.s[0].w);
    a_in[0][3] = pack_bf16(in.s[1].z, in.s[1].w);
    a_in[1][0] = pack_bf16(hacc[0][0], hacc[0][1]);
    a_in[1][1] = pack_bf16(hacc[0][2], hacc[0][3]);
    a_in[1][2] = pack_bf16(hacc[1][0], hacc[1][1]);
    a_in[1][3] = pack_bf16(hacc[1][2], hacc[1][3]);
    zero(acc);
    gemm<2, 8, kS32>(acc, a_in, sm.v0, lane);
    relu_to_a(a_hid, acc);
    zero(acc);
    gemm<4, 8, kS64>(acc, a_hid, sm.v1, lane);
    relu_to_a(a_hid, acc);
    float racc[1][4];
    zero(racc);
    gemm<4, 1, kS64>(racc, a_hid, sm.v2, lane);

    // rgb: columns 0..2 of the padded n8 tile (lanes t = 0, 1)
    if (t == 0) {
      rs[g * kRgb + 0] = racc[0][0];
      rs[g * kRgb + 1] = racc[0][1];
      rs[(g + 8) * kRgb + 0] = racc[0][2];
      rs[(g + 8) * kRgb + 1] = racc[0][3];
    } else if (t == 1) {
      rs[g * kRgb + 2] = racc[0][0];
      rs[(g + 8) * kRgb + 2] = racc[0][2];
    }
    __syncwarp();
    if (row0 + kTile <= n) {
      if (lane < kTile * kRgb / 4)
        reinterpret_cast<float4*>(rgb_out + row0 * kRgb)[lane] =
            reinterpret_cast<const float4*>(rs)[lane];
    } else {
      const int valid = static_cast<int>(n - row0) * kRgb;
      for (int i = lane; i < valid; i += 32) rgb_out[row0 * kRgb + i] = rs[i];
    }
    __syncwarp();   // the staging tiles are rewritten by the next tile
  }
}

cudaError_t launch_f32(const float* feats, const float* sh, const float* w0,
                       const float* w1, const float* v0, const float* v1,
                       const float* v2, float* h, float* rgb, int64_t n,
                       cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fused_head_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      feats, sh, w0, w1, v0, v1, v2, h, rgb, n);
  return cudaGetLastError();
}

template <typename TF>
cudaError_t launch_tc(const void* feats, const float* sh, const float* w0,
                      const float* w1, const float* v0, const float* v1,
                      const float* v2, float* h, float* rgb, int64_t n,
                      cudaStream_t stream) {
  // blocks that fit on the card at once, asked once per device
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_head_tc_kernel<TF>, kTcThreads, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  int64_t blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > resident[dev]) blocks = resident[dev];
  fused_head_tc_kernel<TF><<<static_cast<unsigned>(blocks), kTcThreads, 0,
                             stream>>>(static_cast<const TF*>(feats), sh, w0,
                                       w1, v0, v1, v2, h, rgb, n);
  return cudaGetLastError();
}

}  // namespace

// feats (n, 32) float32, or bf16 (feats_bf16, bf16_mode only), sh (n, 16) float32, weights
// float32 row-major (in, out): W0 (32,64) W1 (64,16) V0 (32,64) V1 (64,64)
// V2 (64,3). Writes h (n, 16) and rgb (n, 3) float32. bf16_mode selects the
// compute type. Every pointer is 16-byte aligned. Returns a cudaError_t (0 on
// success).
extern "C" int arnerf_fused_head_forward(
    const void* feats, const float* sh, const float* w0, const float* w1,
    const float* v0, const float* v1, const float* v2, float* h, float* rgb,
    int64_t n, int feats_bf16, int bf16_mode, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_mode) {
    err = feats_bf16
        ? launch_tc<__nv_bfloat16>(feats, sh, w0, w1, v0, v1, v2, h, rgb, n, s)
        : launch_tc<float>(feats, sh, w0, w1, v0, v1, v2, h, rgb, n, s);
  } else if (feats_bf16) {
    err = cudaErrorInvalidValue;  // bf16 features come with bf16 compute
  } else {
    err = launch_f32(static_cast<const float*>(feats), sh, w0, w1, v0, v1, v2,
                     h, rgb, n, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* arnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
