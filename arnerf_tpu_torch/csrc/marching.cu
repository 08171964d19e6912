// Test-time ray march for Hopper (sm_90a): one call of
// ops/marching.py::march_rays_test for every ray of the call, in one launch.
//
// Replaces no TPU kernel: the JAX package marches with plain XLA
// (arnerf_tpu/ops/marching.py::march_rays_test), and so did the port
// (ops/marching.py::_march_rays_test_plain, kept as the plain version). It
// was added because the plain version led the view's device time: it builds
// every candidate of a round as (N, K) float64 and int64 rows, packs each
// ray's eligible candidates to the front with a row sort, and takes some 150
// launches a call.
//
// What it computes, as the plain version does: from each ray's cursor t_cur,
// the first S occupied lattice points t(k) < t2 among steps k = 0..K-1
// (ops/stepping.py's lattice anchored at t_cur), their positions, steps and
// t, the count n_eff = min(found, S), zeros in the slots past n_eff (each
// zero the product of the plain version's padding candidate and 0), and the
// next cursor: the S-th sample's t + dt, else the scan end's, or t2 + 1 when
// the scan end reached t2. Two-level (a dilated supercell grid, one
// cascade): only the 8-step segments whose start lies in an occupied
// supercell and before t2 are scanned, the first seg_cap of them; with more,
// the scan ends one step before the (seg_cap+1)-th. The last segment may run
// past K - 1, as the plain version's does.
//
// Arithmetic: the plain version's float32 operations in its order, each
// product and sum rounded on its own (the _rn intrinsics, so nvcc contracts
// nothing into an FMA). ops/stepping.fma's one rounding is taken as the
// plain version takes it, through float64 (the product of two float32
// values is exact there). PyTorch's CUDA division of a tensor by a Python
// number multiplies by the float32 reciprocal, and its Python number over a
// tensor is the tensor's reciprocal times the number; both are repeated
// here. Its tensor-by-tensor division is IEEE's, which rcp64 and quotient
// reproduce without a division instruction. exp2f, log2f, expf and logf are
// the functions PyTorch's CUDA kernels call.
//
// What bounds it on an H100: per ray it reads 32 B (o, d, t_cur, t2) and
// writes 20 B a slot and 12 B more: at 65,536 rays and S = 32, 42 MB, 0.013
// ms at 3.35 TB/s. Its work is the candidate tests: a lattice point (one
// float64 multiply-add, or an expf on the exponential stretch), three
// float64 multiply-adds for the position, and a byte load from the
// occupancy grid (2 MB at 128^3, held in the 50 MB L2). How many tests a ray
// makes depends on the scene: it stops at its S-th sample.
//
// Design: one warp a ray, eight rays a block. The lanes test 32 candidates
// at a time; a __ballot_sync of the eligible ones and a __popc of the lanes
// below give each eligible lane its slot in ray order, which is what the
// plain version's sort computes, and the eligible lanes store their slots
// side by side. Two-level: the lanes test 32 segment starts at a time
// against the supercell grid (4 KB at 128^3, read through __ldg and held in
// L1: staging it in shared memory would read 512 B a ray for the ~64 B of
// lookups a ray makes), then the eligible segments of that ballot are
// tested 4 at a time, 8 steps each, lane = 8 * segment + step. A ray stops
// as soon as it has S samples; nothing of (N, K) reaches memory. The
// kernel allocates nothing, launches on the caller's stream, and the C
// function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// The call's constants, filled by the caller (ops/marching.py mirrors this
// layout with ctypes): float32 values, each rounded as the plain version
// rounds it.
struct ArnerfMarchParams {
  int64_t n_rays;
  int64_t t_cur_stride;    // element strides: t_cur, t2, and the rows and
  int64_t t2_stride;       // columns of rays_o and of rays_d
  int64_t o_stride[2];
  int64_t d_stride[2];
  int32_t n_candidates;    // K
  int32_t n_samples;       // S
  int32_t seg_cap;         // two-level only
  int32_t two_level;       // supercell pre-pass (occ_coarse, one cascade)
  int32_t exp_steps;       // exp_step_factor > 0
  int32_t cascades;
  int32_t grid_size;       // G
  int32_t coarse_size;     // G / 8
  // stepping.lattice_t
  float lat_dt_min;        // f32(min(dt_min, dt_max))
  float lat_dt_max;        // f32(dt_max)
  float lat_a;             // f32(A), A = dt_min / f
  float lat_b;             // f32(B), B = dt_max / f
  float lat_inv_dt_min;    // 1 / lat_dt_min
  float lat_log1pf;        // f32(log1p(f))
  float lat_inv_log1pf;    // 1 / lat_log1pf
  // stepping.calc_dt
  float step_factor;       // f32(f)
  float dt_min;            // f32(dt_min), not capped at dt_max
  float dt_max;            // f32(dt_max)
  // occupancy
  float scale;             // f32(scale): the cascades' bound's ceiling
  float inv_coarse_bound;  // 1 / f32(min(0.5, scale))
};

namespace {

constexpr int kWarps = 8;                 // rays a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = static_cast<float>(1e-12);   // the clamps' 1e-12

struct Ray {
  float o[3], d[3];
  float t1, t2;
  float k_a, t_a, k_b;    // the exponential lattice's knots (exp_steps)
};

// stepping.fma: a*b + c rounded once, through float64
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

// 1/x to within 2^-52 relative, for a positive normal float x: an estimate
// refined twice by Newton's method in float64. Rounded to float32 once, a
// value that close to a/b (a, b float32) is a/b correctly rounded, as IEEE
// division gives it: a quotient of two 24-bit significands that is not a
// float32 lies at least 2^-49 relative from every rounding boundary. So
// quotients need no div.rn.f32, whose slow path is a called subroutine
// (register spills around each call site).
__device__ __forceinline__ double rcp64(float x) {
  const double xd = x;
  double r = __fdividef(1.f, x);
  r = __fma_rn(r, __fma_rn(-xd, r, 1.0), r);
  return __fma_rn(r, __fma_rn(-xd, r, 1.0), r);
}

// a / b rounded once, for b > 0 normal. A subnormal quotient (|a/b| below
// 2^-126) may round otherwise unless b is a power of two.
__device__ __forceinline__ float quotient(float a, double rcp_b) {
  return __double2float_rn(__dmul_rn(static_cast<double>(a), rcp_b));
}

// torch.clamp(v, lo, hi): min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// stepping.lattice_t at step k
__device__ __forceinline__ float lattice(const ArnerfMarchParams& p,
                                         const Ray& r, int k) {
  const float kf = static_cast<float>(k);
  if (!p.exp_steps || kf <= r.k_a) return fma_once(kf, p.lat_dt_min, r.t1);
  if (kf <= r.k_b)
    return __fmul_rn(r.t_a,
                     expf(__fmul_rn(__fsub_rn(kf, r.k_a), p.lat_log1pf)));
  return fma_once(__fsub_rn(kf, r.k_b), p.lat_dt_max, p.lat_b);
}

// stepping.calc_dt
__device__ __forceinline__ float calc_dt(const ArnerfMarchParams& p,
                                         float t) {
  return clampf(__fmul_rn(t, p.step_factor), p.dt_min, p.dt_max);
}

// marching._points: o + t*d, each axis rounded once
__device__ __forceinline__ void point(const Ray& r, float t, float pos[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) pos[c] = fma_once(t, r.d[c], r.o[c]);
}

// cell index along one axis: clamp(0.5 * (q + 1) * n, 0, n - 1)
__device__ __forceinline__ int cell(float q, int n) {
  const float v = __fmul_rn(__fmul_rn(0.5f, __fadd_rn(q, 1.f)),
                            static_cast<float>(n));
  return static_cast<int>(clampf(v, 0.f, static_cast<float>(n - 1)));
}

// marching.occupancy_lookup
__device__ __forceinline__ bool occupied(const ArnerfMarchParams& p,
                                         const uint8_t* __restrict__ occ,
                                         const float pos[3], float dt) {
  int mip = 0;
  if (p.cascades > 1) {    // with one cascade both clamps give 0
    const float top = static_cast<float>(p.cascades - 1);
    const float mx = fmaxf(fmaxf(fabsf(pos[0]), fabsf(pos[1])),
                           fabsf(pos[2]));
    const float e_pos = floorf(log2f(fmaxf(mx, kTiny)));
    const float e_dt = floorf(log2f(fmaxf(
        __fmul_rn(dt, static_cast<float>(p.grid_size)), kTiny)));
    mip = max(static_cast<int>(clampf(__fadd_rn(e_pos, 2.f), 0.f, top)),
              static_cast<int>(clampf(__fadd_rn(e_dt, 1.f), 0.f, top)));
  }
  const double rcp = rcp64(
      fminf(exp2f(__fsub_rn(static_cast<float>(mip), 1.f)), p.scale));
  const int64_t G = p.grid_size;
  int64_t flat = mip;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    flat = flat * G + cell(quotient(pos[c], rcp), p.grid_size);
  return __ldg(occ + flat) != 0;
}

// the supercell of a segment's start (one cascade)
__device__ __forceinline__ bool coarse_occupied(
    const ArnerfMarchParams& p, const uint8_t* __restrict__ occ_coarse,
    const float pos[3]) {
  int flat = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    flat = flat * p.coarse_size +
           cell(__fmul_rn(pos[c], p.inv_coarse_bound), p.coarse_size);
  return __ldg(occ_coarse + flat) != 0;
}

struct Out {
  float* xyzs;     // this ray's (S, 3)
  float* deltas;   // (S,)
  float* ts;       // (S,)
  float* t_next;   // this ray's
};

// One test of up to 32 candidates, lane's at step k if `valid`: each
// eligible lane writes its slot. Returns true once S samples were found;
// the lane holding the S-th writes t_next.
__device__ __forceinline__ bool visit(const ArnerfMarchParams& p,
                                      const uint8_t* __restrict__ occ,
                                      const Ray& r, int k, bool valid,
                                      int lane, int& found, const Out& out) {
  float t = 0.f, dt = 0.f, pos[3] = {0.f, 0.f, 0.f};
  bool e = false;
  if (valid) {
    t = lattice(p, r, k);
    dt = calc_dt(p, t);
    point(r, t, pos);
    e = t < r.t2 && occupied(p, occ, pos, dt);
  }
  const unsigned m = __ballot_sync(kFull, e);
  if (e) {
    const int slot = found + __popc(m & ((1u << lane) - 1u));
    if (slot < p.n_samples) {
      out.ts[slot] = t;
      out.deltas[slot] = dt;
#pragma unroll
      for (int c = 0; c < 3; ++c) out.xyzs[3 * slot + c] = pos[c];
      if (slot == p.n_samples - 1) *out.t_next = __fadd_rn(t, dt);
    }
  }
  found += __popc(m);
  return found >= p.n_samples;
}

// No __launch_bounds__: with one of 256 threads ptxas holds the kernel at 64
// registers and spills 12 B; without, it takes 64 and spills nothing.
__global__ void march_rays_test_kernel(
    const float* __restrict__ rays_o, const float* __restrict__ rays_d,
    const float* __restrict__ t_cur, const float* __restrict__ t2,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ occ_coarse,
    float* __restrict__ xyzs, float* __restrict__ deltas,
    float* __restrict__ ts, int64_t* __restrict__ n_eff,
    float* __restrict__ t_next, const __grid_constant__ ArnerfMarchParams p) {
  const int lane = threadIdx.x & 31;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (ray >= p.n_rays) return;            // the whole warp
  const int S = p.n_samples, K = p.n_candidates;

  Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = __ldg(rays_o + ray * p.o_stride[0] + c * p.o_stride[1]);
    r.d[c] = __ldg(rays_d + ray * p.d_stride[0] + c * p.d_stride[1]);
  }
  r.t1 = __ldg(t_cur + ray * p.t_cur_stride);
  r.t2 = __ldg(t2 + ray * p.t2_stride);
  r.k_a = r.t_a = r.k_b = 0.f;
  if (p.exp_steps) {
    r.k_a = fmaxf(__fmul_rn(__fsub_rn(p.lat_a, r.t1), p.lat_inv_dt_min),
                  0.f);
    r.t_a = clampf(r.t1, p.lat_a, p.lat_b);
    const float ratio = __fmul_rn(quotient(1.f, rcp64(fmaxf(r.t_a, kTiny))),
                                  p.lat_b);
    r.k_b = __fadd_rn(r.k_a,
                      fmaxf(__fmul_rn(logf(ratio), p.lat_inv_log1pf), 0.f));
  }
  const Out out{xyzs + ray * S * 3, deltas + ray * S, ts + ray * S,
                t_next + ray};

  int found = 0;
  int scan_end = K - 1;     // the scan's last step
  int pad_k = K - 1;        // the plain version's padding candidate
  if (!p.two_level) {
    for (int base = 0; base < K; base += 32)
      if (visit(p, occ, r, base + lane, base + lane < K, lane, found, out))
        break;
  } else {
    const int K1 = (K + 7) / 8;
    int segs = 0, last_seg = K1 - 1;
    bool done = false;
    for (int base = 0; base < K1 && !done; base += 32) {
      const int j = base + lane;
      bool e = false;
      if (j < K1) {
        const float t = lattice(p, r, 8 * j);
        float pos[3];
        point(r, t, pos);
        e = t < r.t2 && coarse_occupied(p, occ_coarse, pos);
      }
      unsigned m = __ballot_sync(kFull, e);
      while (m) {
        if (segs == p.seg_cap) {       // a (seg_cap+1)-th segment: truncate
          scan_end = 8 * (base + __ffs(m) - 1) - 1;
          done = true;
          break;
        }
        const int n = min(min(__popc(m), 4), p.seg_cap - segs);
        unsigned mine = m;    // this lane's segment: set bit no. lane / 8
        for (int i = 0; i < (lane >> 3); ++i) mine &= mine - 1u;
        const int k = 8 * (base + __ffs(mine) - 1) + (lane & 7);
        if (visit(p, occ, r, k, (lane >> 3) < n, lane, found, out)) {
          done = true;
          break;
        }
        for (int i = 1; i < n; ++i) m &= m - 1u;
        last_seg = base + __ffs(m) - 1;
        m &= m - 1u;
        segs += n;
      }
    }
    // the padding column is the seg_cap-th selected segment's last step
    // when a ray has that many, else the last segment's
    pad_k = 8 * (segs == p.seg_cap ? last_seg : K1 - 1) + 7;
  }

  if (lane == 0) n_eff[ray] = min(found, S);
  if (found >= S) return;
  // fewer than S: zeros from the padding candidate, and the cursor from the
  // scan's end, parked past t2 once the scan reached it
  const float t_pad = lattice(p, r, pad_k);
  const float dt_pad = calc_dt(p, t_pad);
  float pos_pad[3];
  point(r, t_pad, pos_pad);
  for (int s = found + lane; s < S; s += 32) {
    out.ts[s] = __fmul_rn(t_pad, 0.f);
    out.deltas[s] = __fmul_rn(dt_pad, 0.f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out.xyzs[3 * s + c] = __fmul_rn(pos_pad[c], 0.f);
  }
  if (lane == 0) {
    const float t_end = lattice(p, r, scan_end);
    *out.t_next = t_end >= r.t2 ? __fadd_rn(r.t2, 1.f)
                                : __fadd_rn(t_end, calc_dt(p, t_end));
  }
}

}  // namespace

// rays_o, rays_d: (n, 3) float32; t_cur, t2: (n,) float32, each at the
// strides the parameters give; occ: (cascades * G^3,) bytes, 0 = empty;
// occ_coarse: ((G/8)^3,) bytes (two-level only, else unread); outputs
// contiguous: xyzs (n, S, 3), deltas, ts (n, S), n_eff (n,) int64, t_next
// (n,). Returns a cudaError_t (0 on success).
extern "C" int arnerf_march_rays_test(const float* rays_o, const float* rays_d,
                                      const float* t_cur, const float* t2,
                                      const uint8_t* occ,
                                      const uint8_t* occ_coarse, float* xyzs,
                                      float* deltas, float* ts, int64_t* n_eff,
                                      float* t_next,
                                      const ArnerfMarchParams* params,
                                      void* stream) {
  if (params->n_rays <= 0) return 0;
  if (params->n_samples < 1 || params->n_candidates < 1 ||
      (params->two_level && params->seg_cap < 1))
    return cudaErrorInvalidValue;
  const int64_t blocks = (params->n_rays + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  march_rays_test_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rays_o, rays_d, t_cur, t2, occ, occ_coarse, xyzs, deltas, ts, n_eff,
      t_next, *params);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* arnerf_march_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
