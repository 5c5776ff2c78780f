// Non-causal FAVOR+ (Performer) attention of the PCmer, one call per layer.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::performer_attention_pallas
// (body _performer_attn_kernel), including its per-row valid_frames key mask.
//
//   xf = x * d^-1/4,  dd[t, j] = xf[t] . proj[j],  diag[t] = |xf[t]|^2 / 2
//   query:  qf[t, j] = ratio * (exp(dd - diag - max_j dd) + 1e-4)
//   key:    kf[t, j] = ratio * exp(dd - diag + 1e-4), zero for t >= valid[b]
//   out[t]  = (qf[t] . ctx) / (qf[t] . ksum + 1e-8),
//   ctx = sum_t kf[t]^T v[t]  (m x d),  ksum = sum_t kf[t]  (m)
//
// Bound on the H100: operations. Per (batch row, head) the features and the
// two contractions are about 8 * T * m * d flops (m = 266, d = 64) on
// T * d * 16 bytes of q/k/v/out, ~34 flops per byte: above the fp32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20). The reference numerics are fp32,
// so the roof is the fp32 CUDA cores, not the tensor cores.
//
// Design: the TPU kernel ran one program per batch row with T whole in VMEM;
// one block per (row, head) would fill 8 of 132 SMs at B = 1. So T is split
// into 32-row tiles across blocks, in three launches on one stream:
//   1. context: one block per (key tile, row*head) forms the tile's key
//      features in shared memory and writes its partial (m, d) context and
//      m key sum; tiles at or past valid[b] exit at once.
//   2. reduce: sums the partials of each (row, head) over its valid tiles in
//      a fixed order (deterministic, no atomics).
//   3. query: one block per (query tile, row*head) holds the projection and
//      the reduced context (~135 KB) in shared memory, forms the query
//      features, the per-row max over the m features, the denominator and
//      the output rows.
// The feature products are register-tiled (8 rows x 5 features a thread,
// 13 shared loads per 40 FMAs); the projection's rows are padded to d+1
// floats so that lanes on consecutive features hit distinct banks. Any
// T >= 1 is taken: the TPU kernel's T % 128 and T <= 512 limits were its
// tiling and VMEM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;              // head dim
constexpr int kM = 266;             // random features, int(64 ln 64)
constexpr int kLD = kD + 1;         // padded row stride in shared memory
constexpr int kTT = 32;             // time rows per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kS = kM * kD + kM;    // one context: (m, d) then the m key sums
constexpr int kJQ = (kM + 3) / 4;   // context rows per thread in pass 1
constexpr float kStabEps = 1e-4f;
constexpr float kDenEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ void load_proj(const float* __restrict__ proj, float* s_proj) {
  for (int i = threadIdx.x; i < kM * kD; i += kThreads) {
    s_proj[(i / kD) * kLD + i % kD] = proj[i];
  }
}

// Rows [t0, t0 + n) of x (scaled by dn) into s_x and, if v is given, of v
// into s_v; rows n..kTT are zero.
__device__ void load_tile(const float* __restrict__ x, const float* __restrict__ v,
                          float* s_x, float* s_v, int t0, int n, float dn) {
  for (int i = threadIdx.x; i < kTT * kD; i += kThreads) {
    const int t = i / kD, c = i % kD;
    const bool in = t < n;
    s_x[t * kLD + c] = in ? x[(size_t)(t0 + t) * kD + c] * dn : 0.f;
    if (v != nullptr) s_v[t * kD + c] = in ? v[(size_t)(t0 + t) * kD + c] : 0.f;
  }
}

// diag[t] = 0.5 * |s_x[t]|^2, one warp per row.
__device__ void row_diag(const float* s_x, float* s_diag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < kTT; t += kWarps) {
    const float a = s_x[t * kLD + lane], b = s_x[t * kLD + lane + 32];
    const float s = warp_sum(a * a + b * b);
    if (lane == 0) s_diag[t] = 0.5f * s;
  }
}

// s_f[t][j] = s_x[t] . s_proj[j] for t < kTT, j < kM: each thread owns rows
// 8*ty .. 8*ty+7 and features tx + 64 q, q < 5.
__device__ void project_tile(const float* s_x, const float* s_proj, float* s_f) {
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
  float acc[8][5];
  int jj[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    jj[q] = min(tx + 64 * q, kM - 1);
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r][q] = 0.f;
  }
#pragma unroll 4
  for (int c = 0; c < kD; ++c) {
    float xv[8], pv[5];
#pragma unroll
    for (int r = 0; r < 8; ++r) xv[r] = s_x[(ty * 8 + r) * kLD + c];
#pragma unroll
    for (int q = 0; q < 5; ++q) pv[q] = s_proj[jj[q] * kLD + c];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 5; ++q) acc[r][q] = fmaf(xv[r], pv[q], acc[r][q]);
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int j = tx + 64 * q;
    if (j < kM) {
#pragma unroll
      for (int r = 0; r < 8; ++r) s_f[(ty * 8 + r) * kM + j] = acc[r][q];
    }
  }
}

constexpr size_t kContextSmem =
    sizeof(float) * (kM * kLD + kTT * kM + kTT * kLD + kTT * kD + kTT);

__global__ void __launch_bounds__(kThreads)
favor_context_kernel(const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ proj, const int* __restrict__ valid,
                     float* __restrict__ part, int H, int T, int n_tiles, float dn,
                     float ratio) {
  extern __shared__ float sm[];
  float* s_proj = sm;                  // kM x kLD
  float* s_f = s_proj + kM * kLD;      // kTT x kM
  float* s_x = s_f + kTT * kM;         // kTT x kLD
  float* s_v = s_x + kTT * kLD;        // kTT x kD
  float* s_diag = s_v + kTT * kD;      // kTT
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int limit = min(valid[bh / H], T);
  const int t0 = tile * kTT;
  if (t0 >= limit) return;  // past the valid length: no partial needed
  const int n = min(kTT, limit - t0);
  const size_t base = (size_t)bh * T * kD;

  load_proj(proj, s_proj);
  load_tile(k + base, v + base, s_x, s_v, t0, n, dn);
  __syncthreads();
  row_diag(s_x, s_diag);
  project_tile(s_x, s_proj, s_f);
  __syncthreads();
  for (int i = threadIdx.x; i < kTT * kM; i += kThreads) {
    const int t = i / kM;
    s_f[i] = t < n ? ratio * expf(s_f[i] - s_diag[t] + kStabEps) : 0.f;
  }
  __syncthreads();

  float* out = part + ((size_t)bh * n_tiles + tile) * kS;
  for (int j = threadIdx.x; j < kM; j += kThreads) {
    float s = 0.f;
    for (int t = 0; t < n; ++t) s += s_f[t * kM + j];
    out[kM * kD + j] = s;
  }
  // ctx[j][e] for e = tid % 64 and j = tid / 64 + 4 q
  const int e = threadIdx.x & 63, jg = threadIdx.x >> 6;
  float acc[kJQ];
#pragma unroll
  for (int q = 0; q < kJQ; ++q) acc[q] = 0.f;
  for (int t = 0; t < n; ++t) {
    const float vt = s_v[t * kD + e];
    const float* fr = s_f + t * kM + jg;
#pragma unroll
    for (int q = 0; q < kJQ; ++q) {
      if (jg + 4 * q < kM) acc[q] = fmaf(fr[4 * q], vt, acc[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kJQ; ++q) {
    if (jg + 4 * q < kM) out[(jg + 4 * q) * kD + e] = acc[q];
  }
}

__global__ void __launch_bounds__(kThreads)
favor_reduce_kernel(const float* __restrict__ part, const int* __restrict__ valid,
                    float* __restrict__ ctx, int H, int T, int n_tiles) {
  const int bh = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= kS) return;
  const int limit = min(valid[bh / H], T);
  const int nt = limit > 0 ? (limit + kTT - 1) / kTT : 0;
  const float* p = part + (size_t)bh * n_tiles * kS + idx;
  float s = 0.f;
  for (int tile = 0; tile < nt; ++tile) s += p[(size_t)tile * kS];
  ctx[(size_t)bh * kS + idx] = s;
}

constexpr size_t kQuerySmem =
    sizeof(float) * (kM * kLD + kS + kTT * kM + kTT * kLD + 2 * kTT);

__global__ void __launch_bounds__(kThreads)
favor_query_kernel(const float* __restrict__ q, const float* __restrict__ proj,
                   const float* __restrict__ ctx, float* __restrict__ out, int T,
                   float dn, float ratio) {
  extern __shared__ float sm[];
  float* s_proj = sm;                  // kM x kLD
  float* s_ctx = s_proj + kM * kLD;    // kM x kD, then kM key sums
  float* s_ksum = s_ctx + kM * kD;
  float* s_f = s_ctx + kS;             // kTT x kM
  float* s_x = s_f + kTT * kM;         // kTT x kLD
  float* s_diag = s_x + kTT * kLD;     // kTT
  float* s_row = s_diag + kTT;         // kTT: row max, then 1 / denominator
  const int tile = blockIdx.x, bh = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = tile * kTT;
  const int n = min(kTT, T - t0);
  const size_t base = (size_t)bh * T * kD;

  load_proj(proj, s_proj);
  const float* c = ctx + (size_t)bh * kS;
  for (int i = threadIdx.x; i < kS; i += kThreads) s_ctx[i] = c[i];
  load_tile(q + base, nullptr, s_x, nullptr, t0, n, dn);
  __syncthreads();
  row_diag(s_x, s_diag);
  project_tile(s_x, s_proj, s_f);
  __syncthreads();
  for (int t = warp; t < kTT; t += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < kM; j += 32) mx = fmaxf(mx, s_f[t * kM + j]);
    mx = warp_max(mx);
    if (lane == 0) s_row[t] = mx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTT * kM; i += kThreads) {
    const int t = i / kM;
    s_f[i] = ratio * (expf(s_f[i] - s_diag[t] - s_row[t]) + kStabEps);
  }
  __syncthreads();
  for (int t = warp; t < kTT; t += kWarps) {
    float s = 0.f;
    for (int j = lane; j < kM; j += 32) s = fmaf(s_f[t * kM + j], s_ksum[j], s);
    s = warp_sum(s);
    if (lane == 0) s_row[t] = 1.f / (s + kDenEps);
  }
  __syncthreads();
  // out[t][e] for e = tid % 64 and rows 8 * (tid / 64) .. + 7
  const int e = threadIdx.x & 63, tg = threadIdx.x >> 6;
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
  for (int j = 0; j < kM; ++j) {
    const float cv = s_ctx[j * kD + e];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = fmaf(s_f[(tg * 8 + r) * kM + j], cv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = tg * 8 + r;
    if (t < n) out[base + (size_t)(t0 + t) * kD + e] = acc[r] * s_row[t];
  }
}

}  // namespace

// q, k, v, out: (B, H, T, 64) fp32; proj: (266, 64) fp32; valid: (B,) int32;
// part: B * H * ceil(T / 32) * (266 * 65) floats of scratch; ctx: B * H *
// 266 * 65 floats of scratch.
extern "C" int performer_attention_launch(const float* q, const float* k, const float* v,
                                          const float* proj, const int* valid, float* part,
                                          float* ctx, float* out, int B, int H, int T,
                                          float dn, float ratio, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      favor_context_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kContextSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(favor_query_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kQuerySmem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + kTT - 1) / kTT;
  favor_context_kernel<<<dim3(n_tiles, B * H), kThreads, kContextSmem, s>>>(
      k, v, proj, valid, part, H, T, n_tiles, dn, ratio);
  favor_reduce_kernel<<<dim3((kS + kThreads - 1) / kThreads, B * H), kThreads, 0, s>>>(
      part, valid, ctx, H, T, n_tiles);
  favor_query_kernel<<<dim3(n_tiles, B * H), kThreads, kQuerySmem, s>>>(
      q, proj, ctx, out, T, dn, ratio);
  return (int)cudaGetLastError();
}
