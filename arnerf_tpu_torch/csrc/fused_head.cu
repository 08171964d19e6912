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
// float32 FMAs on the rounded values are the bf16 dot with f32 accumulation.
//
// Bound on an H100 SXM: per row 2 * 9,408 = 18.8 kFLOP, against ~268 B of
// traffic in f32 (feats 128 + sh 64 + outputs 76). On the CUDA cores
// (67 TFLOP/s f32) the kernel is compute-bound: at the 2M-row render round
// that is ~0.6 ms of arithmetic against ~0.17 ms of memory traffic. Moving
// the five products onto the tensor cores (mma / wgmma) is later work.
//
// Design: each block stages all five weight matrices (9,408 floats,
// 37.6 KB) in shared memory, already rounded to the compute type. Each
// thread owns exactly one row and keeps its 64-wide activations in
// registers; every weight read is a shared-memory broadcast (all lanes read
// the same address). There is deliberately no grid-stride loop: with one,
// the compiler hoists the loop-invariant shared-memory weights into
// registers and spills ~37 KB a thread to local memory (measured: 255
// registers, 28 ms at 2M rows). Staging once per 128 rows costs ~74 loads a
// thread against 9,408 FMAs. Threads past the ragged tail only help stage.
//
// Training needs a gradient here; the backward kernel comes with the
// training path. Plain C interface, loaded with ctypes; the launch goes on
// the caller's stream and the function returns cudaGetLastError().

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

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Load one row of 32 features (float32 or bf16) as float32.
__device__ __forceinline__ void load_feats(const float* __restrict__ p,
                                           float* x) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kIn / 4; ++i) {
    float4 v = p4[i];
    x[4 * i + 0] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_feats(
    const __nv_bfloat16* __restrict__ p, float* x) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < kIn / 8; ++i) {
    uint4 v = p4[i];
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(b[j]);
      x[8 * i + 2 * j + 0] = f.x;
      x[8 * i + 2 * j + 1] = f.y;
    }
  }
}

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

template <bool kBf16>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = rnd<kBf16>(src[i]);
}

template <bool kBf16, typename TF>
__global__ void __launch_bounds__(kThreads)
fused_head_kernel(const TF* __restrict__ feats, const float* __restrict__ sh,
                  const float* __restrict__ w0, const float* __restrict__ w1,
                  const float* __restrict__ v0, const float* __restrict__ v1,
                  const float* __restrict__ v2, float* __restrict__ h_out,
                  float* __restrict__ rgb_out, int64_t n) {
  __shared__ __align__(16) float sW0[kW0];
  __shared__ __align__(16) float sW1[kW1];
  __shared__ __align__(16) float sV0[kV0];
  __shared__ __align__(16) float sV1[kV1];
  __shared__ __align__(16) float sV2[kV2];
  stage<kBf16>(sW0, w0, kW0);
  stage<kBf16>(sW1, w1, kW1);
  stage<kBf16>(sV0, v0, kV0);
  stage<kBf16>(sV1, v1, kV1);
  stage<kBf16>(sV2, v2, kV2);
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row < n) {
    // ---- sigma net: a = relu(feats @ W0); h = a @ W1 ----------------------
    float x[kIn];
    load_feats(feats + row * kIn, x);
    float a[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) a[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kIn; ++k) axpy_row<kHid>(rnd<kBf16>(x[k]), sW0 + k * kHid, a);
#pragma unroll
    for (int j = 0; j < kHid; ++j) a[j] = rnd<kBf16>(fmaxf(a[j], 0.f));

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
      axpy_row<kHid>(rnd<kBf16>(s.x), sV0 + (4 * i + 0) * kHid, r);
      axpy_row<kHid>(rnd<kBf16>(s.y), sV0 + (4 * i + 1) * kHid, r);
      axpy_row<kHid>(rnd<kBf16>(s.z), sV0 + (4 * i + 2) * kHid, r);
      axpy_row<kHid>(rnd<kBf16>(s.w), sV0 + (4 * i + 3) * kHid, r);
    }
#pragma unroll
    for (int k = 0; k < kSig; ++k)
      axpy_row<kHid>(rnd<kBf16>(h[k]), sV0 + (kSh + k) * kHid, r);
#pragma unroll
    for (int j = 0; j < kHid; ++j) r[j] = rnd<kBf16>(fmaxf(r[j], 0.f));

    // ---- r2 = relu(r @ V1); rgb = r2 @ V2 ----------------------------------
    float r2[kHid];
#pragma unroll
    for (int j = 0; j < kHid; ++j) r2[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) axpy_row<kHid>(r[k], sV1 + k * kHid, r2);
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int k = 0; k < kHid; ++k) {
      const float rk = rnd<kBf16>(fmaxf(r2[k], 0.f));
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

template <bool kBf16, typename TF>
cudaError_t launch(const void* feats, const float* sh, const float* w0,
                   const float* w1, const float* v0, const float* v1,
                   const float* v2, float* h, float* rgb, int64_t n,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fused_head_kernel<kBf16, TF><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const TF*>(feats), sh, w0, w1, v0, v1, v2, h, rgb, n);
  return cudaGetLastError();
}

}  // namespace

// feats (n, 32) float32, or bf16 (feats_bf16, bf16_mode only), sh (n, 16) float32, weights
// float32 row-major (in, out): W0 (32,64) W1 (64,16) V0 (32,64) V1 (64,64)
// V2 (64,3). Writes h (n, 16) and rgb (n, 3) float32. bf16_mode selects the
// compute type. Returns a cudaError_t (0 on success).
extern "C" int arnerf_fused_head_forward(
    const void* feats, const float* sh, const float* w0, const float* w1,
    const float* v0, const float* v1, const float* v2, float* h, float* rgb,
    int64_t n, int feats_bf16, int bf16_mode, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_mode) {
    err = feats_bf16
        ? launch<true, __nv_bfloat16>(feats, sh, w0, w1, v0, v1, v2, h, rgb, n, s)
        : launch<true, float>(feats, sh, w0, w1, v0, v1, v2, h, rgb, n, s);
  } else if (feats_bf16) {
    err = cudaErrorInvalidValue;  // bf16 features come with bf16 compute
  } else {
    err = launch<false, float>(feats, sh, w0, w1, v0, v1, v2, h, rgb, n, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* arnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
