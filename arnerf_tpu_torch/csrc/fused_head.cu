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
// f32 mode: CUDA cores. It replaces the same Pallas kernel
// (arnerf_tpu/ops/fused_head.py:42, _head_kernel) at the float32 compute
// type, the serving paths' default. Every product is an f32 FMA and every
// sum is in f32: TF32 tensor cores would change f32 results, so there is
// no mma here. It is bound by operations: 9,408 FMAs a row at 67 TFLOP/s,
// 0.0736 ms at 2^18 rows (its 268 B a row take 0.021 ms at 3.35 TB/s).
//   * Persistent blocks of 3 groups x 128 threads, one block an SM (the
//     count asked once per device). Each group is a pipeline over 64-row
//     tiles with its own named barrier; the three share the weights.
//   * The weights (W0..V1 as given, V2 padded to 4 columns) are staged
//     once per block by cp.async and stay in shared memory for the
//     block's life: 38 KB per SM, not per 128 rows.
//   * Each layer is a small GEMM of register-tiled outer products. For the
//     64-wide layers a thread owns 4 rows x 8 columns (rows tr + 16i,
//     columns 4tc.. and 32 + 4tc..); per 4 k it reads 4 activation and 8
//     weight float4s and does 128 FMAs (10.7 a shared load, against 3.8
//     and one for V2 in the earlier design). W1 (64 -> 16): 4 rows x 2
//     columns. V2 (64 -> 3, padded to 4): 2 threads a row, each half of
//     k, summed by a shuffle.
//   * Activations live in shared memory, row-major with strides padded to
//     4 banks a row (conflict-free float4 reads), in two buffers in turn
//     (feats -> P -> h in Q -> P -> Q -> rgb in P); relu is applied as
//     the accumulators are written back. Only 32 accumulators and 24
//     operands stay in registers.
//   * The next tile's feats and sh (the raw rows, zero-filled past n)
//     arrive by cp.async in the group's second input buffer while this
//     tile computes.
//   * h (64 B a row) and rgb (12 B a row) leave from shared memory as
//     coalesced 16-B stores; the ragged tail is masked.
//   * Every tile iteration passes named barriers that clobber memory, so
//     the loop-invariant weight reads cannot be hoisted out of the loop
//     into registers (they were, in a grid-stride loop without barriers:
//     255 registers, a 37 KB spill, 28 ms at 2M rows).
//   scripts/fused_head_f32_variants.py builds this kernel with other
//   group counts, tile rows and K unrolling and times them beside it.
//   Earlier design (one row a thread, activations in per-thread arrays,
//   weights staged again by every 128-row block, no overlap): at 2^18
//   rows 0.318-0.321 ms on an H100 80GB HBM3, 700 W, 23 % of the bound;
//   PERF.md holds its times and this design's.
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
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// f32 mode: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kGroups = 3;             // row-tile pipelines a block
constexpr int kMR = 4;                 // rows of a thread's register tile
constexpr int kRows = 64;              // rows of a tile
constexpr int kGroupThreads = kRows * 8 / kMR;   // 128: 4 warps
constexpr int kF32Threads = kGroups * kGroupThreads;
constexpr int kRG = kRows / kMR;       // row groups: rows tr + kRG i
constexpr int kSF = kIn + 4;           // shared row strides (floats), each a
constexpr int kSS = kSh + 4;           //   multiple of 4 banks: feats, sh,
constexpr int kSA = kHid + 4;          //   activations
// shared memory in floats: the weights, then per group two input stages
// and two activation buffers
constexpr int kOffW1 = kW0;
constexpr int kOffV0 = kOffW1 + kW1;
constexpr int kOffV1 = kOffV0 + kV0;
constexpr int kOffV2 = kOffV1 + kV1;
constexpr int kWeights = kOffV2 + kHid * 4;       // V2 padded to 4 columns
constexpr int kStage = kRows * (kSF + kSS);
constexpr int kAct = kRows * kSA;
constexpr int kGroupFloats = 2 * kStage + 2 * kAct;
constexpr int kF32Smem = (kWeights + kGroups * kGroupFloats) * 4;  // 228,352 B

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the 128 threads of group g (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kGroupThreads)
               : "memory");
}

// A tile's raw rows into one input stage: feats (row stride kSF), then sh
// (kSS); rows past n are zero-filled.
__device__ __forceinline__ void load_tile(float* stage,
                                          const float* __restrict__ feats,
                                          const float* __restrict__ sh,
                                          int64_t row0, int64_t n, int gt) {
#pragma unroll
  for (int c = gt; c < kRows * kIn / 4; c += kGroupThreads) {
    const int r = c / (kIn / 4), q = c % (kIn / 4);
    const bool valid = row0 + r < n;
    cp_async16(stage + r * kSF + 4 * q,
               feats + (valid ? row0 + r : 0) * kIn + 4 * q, valid);
  }
#pragma unroll
  for (int c = gt; c < kRows * kSh / 4; c += kGroupThreads) {
    const int r = c / (kSh / 4), q = c % (kSh / 4);
    const bool valid = row0 + r < n;
    cp_async16(stage + kRows * kSF + r * kSS + 4 * q,
               sh + (valid ? row0 + r : 0) * kSh + 4 * q, valid);
  }
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <>
struct Vec<2> {
  float v[2];
  __device__ __forceinline__ void load(const float* p) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
};

__device__ __forceinline__ float lane_of(const float4& x, int kk) {
  return kk == 0 ? x.x : kk == 1 ? x.y : kk == 2 ? x.z : x.w;
}

// acc[i][c] += sum_{k < K} a[row_i * SA + k] * w[k * SW + col_c] for the
// thread's 4 rows row_i = tr + 16 i and its NV vectors of V columns
// starting at V tc + 8 V j: per 4 k, 4 activation float4s, 4 NV weight
// vectors, 16 V NV FMAs, summed in k order.
template <int K, int SA, int SW, int V, int NV>
__device__ __forceinline__ void gemm(float (&acc)[kMR][V * NV],
                                     const float* a, const float* w, int tr,
                                     int tc) {
#pragma unroll
  for (int k = 0; k < K; k += 4) {
    float4 x[kMR];
#pragma unroll
    for (int i = 0; i < kMR; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (tr + kRG * i) * SA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Vec<V> wv[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j)
        wv[j].load(w + (k + kk) * SW + V * tc + 8 * V * j);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const float xi = lane_of(x[i], kk);
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[i][V * j + e] = fmaf(xi, wv[j].v[e], acc[i][V * j + e]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[kMR][N]) {
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int c = 0; c < N; ++c) acc[i][c] = 0.f;
}

// The accumulators of a 64-wide layer, through relu, into an activation
// buffer (row stride kSA).
__device__ __forceinline__ void write_relu(float* out,
                                           const float (&acc)[kMR][8], int tr,
                                           int tc) {
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(out + (tr + kRG * i) * kSA + 4 * tc + 32 * j) =
          make_float4(fmaxf(acc[i][4 * j], 0.f), fmaxf(acc[i][4 * j + 1], 0.f),
                      fmaxf(acc[i][4 * j + 2], 0.f),
                      fmaxf(acc[i][4 * j + 3], 0.f));
}

// A tile's rgb leaves as 16-B stores (its 64 x 3 floats are contiguous);
// the ragged tail, float by float.
__device__ __forceinline__ void store_rgb(float* __restrict__ rgb_out,
                                          const float* staged, int64_t row0,
                                          int64_t n, int gt) {
  if (row0 + kRows <= n) {
    if (gt < kRows * kRgb / 4)
      reinterpret_cast<float4*>(rgb_out + row0 * kRgb)[gt] =
          reinterpret_cast<const float4*>(staged)[gt];
  } else {
    const int valid = static_cast<int>(n - row0) * kRgb;
    for (int i = gt; i < valid; i += kGroupThreads)
      rgb_out[row0 * kRgb + i] = staged[i];
  }
}

__global__ void __launch_bounds__(kF32Threads, 1)
fused_head_f32_kernel(const float* __restrict__ feats,
                      const float* __restrict__ sh,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ v0,
                      const float* __restrict__ v1,
                      const float* __restrict__ v2, float* __restrict__ h_out,
                      float* __restrict__ rgb_out, int64_t n) {
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / kGroupThreads, gt = threadIdx.x % kGroupThreads;
  const int lane = gt & 31;
  const int tc = lane & 7, tr = 4 * (gt >> 5) + (lane >> 3);
  float* sw = smem;
  float* stages = smem + kWeights + g * kGroupFloats;
  float* P = stages + 2 * kStage;
  float* Q = P + kAct;

  const int64_t tiles = (n + kRows - 1) / kRows;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kGroups;
  // consecutive tiles go to different blocks (SMs) first
  int64_t tile = static_cast<int64_t>(g) * gridDim.x + blockIdx.x;

  // the weights, once per block; with them the group's first tile
  const float* const src[4] = {w0, w1, v0, v1};
  const int off[5] = {0, kOffW1, kOffV0, kOffV1, kOffV2};
#pragma unroll
  for (int m = 0; m < 4; ++m)
    for (int i = threadIdx.x; i < (off[m + 1] - off[m]) / 4; i += kF32Threads)
      cp_async16(sw + off[m] + 4 * i, src[m] + 4 * i, true);
  for (int i = threadIdx.x; i < kHid * 4; i += kF32Threads)
    sw[kOffV2 + i] = (i & 3) < kRgb ? v2[(i >> 2) * kRgb + (i & 3)] : 0.f;
  if (tile < tiles) load_tile(stages, feats, sh, tile * kRows, n, gt);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int buf = 0;
#pragma unroll 1
  for (; tile < tiles; tile += step, buf ^= 1) {
    const int64_t row0 = tile * kRows;
    const float* in = stages + buf * kStage;
    if (tile + step < tiles)
      load_tile(stages + (buf ^ 1) * kStage, feats, sh, row0 + step * kRows,
                n, gt);
    cp_async_commit();
    cp_async_wait<1>();   // this tile's rows have landed
    group_sync(g);

    // ---- sigma net: P = relu(feats @ W0); Q[:, :16] = h = P @ W1 -------
    float acc[kMR][8];
    zero_acc(acc);
    gemm<kIn, kSF, kHid, 4, 2>(acc, in, sw, tr, tc);
    write_relu(P, acc, tr, tc);
    group_sync(g);
    float hacc[kMR][2];
    zero_acc(hacc);
    gemm<kHid, kSA, kSig, 2, 1>(hacc, P, sw + kOffW1, tr, tc);
#pragma unroll
    for (int i = 0; i < kMR; ++i)
      *reinterpret_cast<float2*>(Q + (tr + kRG * i) * kSA + 2 * tc) =
          make_float2(hacc[i][0], hacc[i][1]);
    group_sync(g);

    // h leaves as 16-B stores, 4 a row
#pragma unroll
    for (int c = gt; c < kRows * kSig / 4; c += kGroupThreads) {
      const int r = c >> 2, q = c & 3;
      if (row0 + r < n)
        reinterpret_cast<float4*>(h_out + (row0 + r) * kSig)[q] =
            *reinterpret_cast<const float4*>(Q + r * kSA + 4 * q);
    }

    // ---- rgb net: P = relu(sh @ V0[:16] + h @ V0[16:]) -------------------
    zero_acc(acc);
    gemm<kSh, kSS, kHid, 4, 2>(acc, in + kRows * kSF, sw + kOffV0, tr, tc);
    gemm<kSig, kSA, kHid, 4, 2>(acc, Q, sw + kOffV0 + kSh * kHid, tr, tc);
    write_relu(P, acc, tr, tc);
    group_sync(g);
    // ---- Q = relu(P @ V1) --------------------------------------------------
    zero_acc(acc);
    gemm<kHid, kSA, kHid, 4, 2>(acc, P, sw + kOffV1, tr, tc);
    write_relu(Q, acc, tr, tc);
    group_sync(g);
    // ---- rgb = Q @ V2: two threads a row, each half of k ------------------
    {
      const int r = gt >> 1, half = gt & 1;
      const float* a = Q + r * kSA + (kHid / 2) * half;
      const float* w = sw + kOffV2 + (kHid / 2) * 4 * half;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
      for (int k = 0; k < kHid / 2; k += 4) {
        const float4 x = *reinterpret_cast<const float4*>(a + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 wv = *reinterpret_cast<const float4*>(w + 4 * (k + kk));
          const float xk = lane_of(x, kk);
          c0 = fmaf(xk, wv.x, c0);
          c1 = fmaf(xk, wv.y, c1);
          c2 = fmaf(xk, wv.z, c2);
        }
      }
      c0 += __shfl_xor_sync(0xffffffffu, c0, 1);
      c1 += __shfl_xor_sync(0xffffffffu, c1, 1);
      c2 += __shfl_xor_sync(0xffffffffu, c2, 1);
      if (half == 0) {
        P[r * kRgb + 0] = c0;
        P[r * kRgb + 1] = c1;
        P[r * kRgb + 2] = c2;
      }
    }
    group_sync(g);
    store_rgb(rgb_out, P, row0, n, gt);
    // the loop's first barrier guards P and this stage before reuse
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

// Blocks of the f32 kernel that fit on the current device at once (one an
// SM), asked once per device; the kernel's dynamic shared memory is
// allowed first.
cudaError_t f32_resident(int* blocks) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(fused_head_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kF32Smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fused_head_f32_kernel, kF32Threads, kF32Smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  *blocks = resident[dev];
  return cudaSuccess;
}

cudaError_t launch_f32(const float* feats, const float* sh, const float* w0,
                       const float* w1, const float* v0, const float* v1,
                       const float* v2, float* h, float* rgb, int64_t n,
                       cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = f32_resident(&resident);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kRows - 1) / kRows;
  int64_t blocks = (tiles + kGroups - 1) / kGroups;
  if (blocks > resident) blocks = resident;
  fused_head_f32_kernel<<<static_cast<unsigned>(blocks), kF32Threads,
                          kF32Smem, stream>>>(feats, sh, w0, w1, v0, v1, v2,
                                              h, rgb, n);
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

// The f32 kernel's launch shape on the current device: out[0] threads a
// block, out[1] dynamic shared memory bytes, out[2] registers a thread,
// out[3] resident blocks, out[4] rows of a tile, out[5] rows of one wave
// (resident blocks x groups x rows a tile). Returns a cudaError_t.
extern "C" int arnerf_fused_head_f32_shape(int64_t* out) {
  int resident = 0;
  cudaError_t err = f32_resident(&resident);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_head_f32_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kF32Threads;
  out[1] = kF32Smem;
  out[2] = attr.numRegs;
  out[3] = resident;
  out[4] = kRows;
  out[5] = static_cast<int64_t>(resident) * kGroups * kRows;
  return 0;
}

extern "C" const char* arnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
