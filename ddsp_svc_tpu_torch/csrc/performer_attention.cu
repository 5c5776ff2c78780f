// Non-causal FAVOR+ (Performer) attention of the PCmer, one launch per call.
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
// Design: one thread-block cluster per (batch row, head), one launch, no
// global scratch. T is cut into 32-row tiles; CTA r of a cluster of cs takes
// tiles r, r + cs, ... (cs the least power of two >= the tile count, at most
// 8, the portable cluster size: an H100 holds fewer than eight 16-CTA
// clusters, one head each of B = 1, and forced 16-CTA clusters ran slower
// there, tools/ab_torch_attention.py):
//   1. keys: each CTA forms its key tiles' features in shared memory (tiles
//      at or past valid[b] are skipped) and accumulates its partial (m, d)
//      context and m key sums in registers, then stores them to shared
//      memory;
//   2. cluster barrier; CTA r sums slice r of the context over the cluster's
//      CTAs through distributed shared memory, in rank order (deterministic,
//      no atomics), into its own copy;
//   3. cluster barrier; each CTA gathers the other slices from their owners,
//      arrives on the cluster barrier (it reads no peer after that) and waits
//      on it only before it exits, so that no CTA leaves while a peer still
//      reads its shared memory;
//   4. queries: each CTA forms its query tiles' features, row maxima and
//      denominators in registers and writes the output rows.
// The projection (rows padded to 68 floats: float4 reads of 8 consecutive
// rows hit distinct banks) and the first key, value and query tiles are
// staged with cp.async, all in flight before the first use. Every product is
// register-tiled over float4 reads: the projection 2 rows x 17 features a
// thread (19 shared loads per 136 FMAs), the context 17 features x 4
// columns (18 per 68), the output 4 rows x 4 columns over half the features
// (8 per 64; the two halves are summed through shared memory in a fixed
// order). The features are padded to 272 = 17 x 16 (zero past 266). On an
// H100 (tools/ab_torch_attention.py) the projection takes ~4.6 us a tile and
// each contraction ~4.5, ~85 % of the kernel; the projection in 3xTF32 on
// mma.sync ran no faster and doubled the error against the plain version.
// Any T >= 1 is taken: the TPU kernel's T % 128 and T <= 512 limits were its
// tiling and VMEM.
//
// The same body cut at the reduction, for a sequence sharded over time
// (parallel/timeparallel.py), where the key sums cross devices:
//   moments_kernel: phases 1-2 over a key range [key_lo, key_hi) of each
//     batch row, the summed context and key sums written to device memory
//     (same clusters, tiles and rank order as favor_kernel, so the range
//     [0, valid) reproduces its context bit for bit);
//   apply_kernel: phase 4 from a context and key sums in device memory
//     (every shard's, all-reduced), one CTA per query tile, no cluster.
// Nothing new is computed. Bound as above: the moments are the key half of
// the operations, the apply the query half.
//
// The bf16-operand form (performer_attention_pallas(mxu_bf16=True), the
// PCmer under model.bf16 at inference): the same three kernels (kMxu), on
// q, k, v of fp32 or bf16 (read upcast; In). They round to bf16, to
// nearest even, exactly the operands JAX's kernel rounds: the projection
// after scaling by d^-0.25 (:537-538; once, as it is staged), q and k
// before the feature products (:465/:469; x itself, unscaled, the diagonal
// from the unrounded x: |x|^2 / 2 d^-1/2, :477-478), kf and v before the
// context product (:488), k_sum and qf before the denominator (:493), ctx
// and qf before the numerator (:497). The exponentials, k_sum's own sum
// (from the unrounded kf) and the division stay fp32, and every product
// sums in fp32: a product of two bf16 values is exact in fp32, so these
// FMAs give what a bf16 tensor-core product with an fp32 accumulator gives,
// up to the order of the sums. The context's cluster sum is rounded as its
// owner stores it, so a peer may read it before or after: rounding twice
// changes nothing. The moments stay fp32 (as summed over shards, before
// JAX's rounding); the apply rounds the all-reduced context and key sums as
// it stages them, so a time-sharded run rounds where the single launch
// does. The products stay on the CUDA cores here, as in the fp32 form.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;               // head dim
constexpr int kM = 266;              // random features, int(64 ln 64)
constexpr int kMP = 272;             // features padded to 17 x 16
constexpr int kJQ = kMP / 16;        // features a projection or context thread holds
constexpr int kPS = kD + 4;          // projection / q / k row stride in shared memory
constexpr int kFS = kMP;             // feature row stride (272 = 16 mod 32 banks)
constexpr int kTT = 32;              // time rows per tile
constexpr int kThreads = 256;
constexpr int kCtx = kMP * kD + kMP;  // one context: (272, 64), then the 272 key sums
constexpr int kCtx4 = kCtx / 4;
constexpr int kGather = (kCtx4 + kThreads - 1) / kThreads;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr float kStabEps = 1e-4f;
constexpr float kDenEps = 1e-8f;

struct Smem {
  float proj[kMP * kPS];  // rows kM.. zero
  float ctx[kCtx];        // this CTA's partial, then the cluster's sum
  float f[kTT * kFS];     // one tile's features
  float xk[kTT * kPS];    // key tile
  float xq[kTT * kPS];    // query tile
  float v[kTT * kD];      // value tile; in the query phase the second half-sum
  float inv[kTT];         // 1 / denominator of each query row
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// v rounded to bf16 (to nearest even) and back.
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 bf16r4(float4 v) {
  return make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
}

// An element read upcast exactly to fp32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// The projection's 266 rows into s_proj (row stride kPS), by cp.async; for
// kMxu scaled by dn and rounded to bf16 (plain loads).
template <bool kMxu>
__device__ void stage_proj(const float* __restrict__ proj, float* s_proj, float dn) {
  for (int i = threadIdx.x; i < kM * (kD / 4); i += kThreads) {
    float* dst = s_proj + (i >> 4) * kPS + 4 * (i & 15);
    if constexpr (kMxu) {
      const float4 p = reinterpret_cast<const float4*>(proj)[i];
      *reinterpret_cast<float4*>(dst) =
          bf16r4(make_float4(p.x * dn, p.y * dn, p.z * dn, p.w * dn));
    } else {
      cp_async16(dst, proj + 4 * i);
    }
  }
  for (int i = threadIdx.x; i < (kMP - kM) * kPS; i += kThreads) s_proj[kM * kPS + i] = 0.f;
}

// Rows [t0, t0 + n) of x (row stride st elements) into s (row stride ld),
// fp32 by cp.async, bf16 upcast by plain loads; rows n..kTT zero.
template <class In>
__device__ void stage_rows(const In* __restrict__ x, long long st, int t0, int n, float* s,
                           int ld) {
  for (int i = threadIdx.x; i < kTT * (kD / 4); i += kThreads) {
    const int r = i >> 4, c = 4 * (i & 15);
    float* dst = s + r * ld + c;
    if (r >= n) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if constexpr (std::is_same<In, float>::value) {
      cp_async16(dst, x + (t0 + r) * st + c);
    } else {
      const In* src = x + (t0 + r) * st + c;
      *reinterpret_cast<float4*>(dst) =
          make_float4(to_f32(src[0]), to_f32(src[1]), to_f32(src[2]), to_f32(src[3]));
    }
  }
}

// acc[r][q] = xf[tg + 16 r] . proj[jl + 16 q] and sq[r] = |xf[tg + 16 r]|^2
// for thread (tg, jl) = (tid / 16, tid % 16), xf = x * dn. kMxu: acc[r][q] =
// bf16(x) . proj (s_proj holds proj * dn rounded) and sq[r] = |x|^2.
template <bool kMxu>
__device__ __forceinline__ void project(const float* s_x, const float* s_proj, float dn,
                                        float (&acc)[2][kJQ], float (&sq)[2]) {
  const int tg = threadIdx.x >> 4, jl = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sq[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kJQ; ++q) acc[r][q] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < kD; c += 4) {
    float4 xv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xv[r] = *reinterpret_cast<const float4*>(s_x + (tg + 16 * r) * kPS + c);
      if (!kMxu) xv[r] = make_float4(xv[r].x * dn, xv[r].y * dn, xv[r].z * dn, xv[r].w * dn);
      sq[r] = fmaf(xv[r].x, xv[r].x, sq[r]);
      sq[r] = fmaf(xv[r].y, xv[r].y, sq[r]);
      sq[r] = fmaf(xv[r].z, xv[r].z, sq[r]);
      sq[r] = fmaf(xv[r].w, xv[r].w, sq[r]);
      if (kMxu) xv[r] = bf16r4(xv[r]);
    }
#pragma unroll
    for (int q = 0; q < kJQ; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(s_proj + (jl + 16 * q) * kPS + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[r][q] = fmaf(xv[r].x, p.x, acc[r][q]);
        acc[r][q] = fmaf(xv[r].y, p.y, acc[r][q]);
        acc[r][q] = fmaf(xv[r].z, p.z, acc[r][q]);
        acc[r][q] = fmaf(xv[r].w, p.w, acc[r][q]);
      }
    }
  }
}

// The diagonal |xf|^2 / 2 from project's sq: for kMxu sq is |x|^2 and
// the factor JAX's 0.5 / sqrt(d) (exact: 1/16 at d = 64).
template <bool kMxu>
__device__ __forceinline__ float diagonal(float sq) {
  return kMxu ? sq * (0.5f / 8.0f) : 0.5f * sq;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Phase 1 over the keys [lo, hi): this CTA's partial context and key sums
// over its tiles (rank, rank + cs, ... among those that meet the range,
// tiles aligned to row 0, rows outside the range zero features), stored to
// s.ctx. The tile `first` is already staged in s.xk / s.v. Context thread
// (jc, eq) = (tid / 16, tid % 16) owns features jc + 16 q, columns 4 eq..+3.
// kMxu: the context from kf and v rounded to bf16 as they are read, the key
// sums from the unrounded kf.
template <bool kMxu, class In>
__device__ __forceinline__ void key_partials(const In* __restrict__ k,
                                             const In* __restrict__ v, long long st, int lo,
                                             int hi, int first, int cs, Smem& s, float dn,
                                             float ratio) {
  const int tg = threadIdx.x >> 4, jl = threadIdx.x & 15;
  const int jc = threadIdx.x >> 4, eq = threadIdx.x & 15;
  const int n_end = (hi + kTT - 1) / kTT;
  float4 cacc[kJQ];
#pragma unroll
  for (int i = 0; i < kJQ; ++i) cacc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float ksum[2] = {0.f, 0.f};  // features tid and 256 + tid
  for (int tile = first; tile < n_end; tile += cs) {
    const int t0 = tile * kTT, r0 = max(0, lo - t0), r1 = min(kTT, hi - t0);
    if (tile != first) {
      stage_rows(k, st, t0, r1, s.xk, kPS);
      stage_rows(v, st, t0, r1, s.v, kD);
      cp_async_wait_all();
      __syncthreads();
    }
    float acc[2][kJQ], sq[2];
    project<kMxu>(s.xk, s.proj, dn, acc, sq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tg + 16 * r;
      const float diag = diagonal<kMxu>(sq[r]);
#pragma unroll
      for (int i = 0; i < kJQ; ++i) {
        const int j = jl + 16 * i;
        s.f[t * kFS + j] =
            (t >= r0 && t < r1 && j < kM) ? ratio * expf(acc[r][i] - diag + kStabEps) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int t = r0; t < r1; ++t) {
      float4 vv = *reinterpret_cast<const float4*>(s.v + t * kD + 4 * eq);
      if (kMxu) vv = bf16r4(vv);
#pragma unroll
      for (int i = 0; i < kJQ; ++i) {
        const float f = s.f[t * kFS + jc + 16 * i];
        fma4(cacc[i], kMxu ? bf16r(f) : f, vv);
      }
    }
    for (int t = r0; t < r1; ++t) {
      ksum[0] += s.f[t * kFS + threadIdx.x];
      if (threadIdx.x < kMP - kThreads) ksum[1] += s.f[t * kFS + kThreads + threadIdx.x];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kJQ; ++i) {
    *reinterpret_cast<float4*>(s.ctx + (jc + 16 * i) * kD + 4 * eq) = cacc[i];
  }
  s.ctx[kMP * kD + threadIdx.x] = ksum[0];
  if (threadIdx.x < kMP - kThreads) s.ctx[kMP * kD + kThreads + threadIdx.x] = ksum[1];
}

// The first tile of CTA `rank` among the tiles that meet [lo, ...): the
// least tile >= lo / kTT that is rank modulo cs.
__device__ __forceinline__ int first_tile(int lo, int rank, int cs) {
  const int skip = max(0, lo / kTT - rank);
  return rank + cs * ((skip + cs - 1) / cs);
}

// Phase 2: float4 slice `rank` of the context (and key sums) summed over
// the cluster's CTAs in rank order (deterministic, no atomics), each sum
// handed to put(i, sum). Call after a cluster barrier.
template <class Put>
__device__ __forceinline__ void cluster_slice_sum(cg::cluster_group& cluster, Smem& s, int rank,
                                                  int cs, int per, Put put) {
  const int lo = rank * per, hi = min(kCtx4, lo + per);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    float4 part[kMaxCluster];
#pragma unroll
    for (int p = 0; p < kMaxCluster; ++p) {
      if (p < cs) part[p] = reinterpret_cast<const float4*>(cluster.map_shared_rank(s.ctx, p))[i];
    }
    float4 sum = part[0];
#pragma unroll
    for (int p = 1; p < kMaxCluster; ++p) {
      if (p < cs) sum = add4(sum, part[p]);
    }
    put(i, sum);
  }
}

// Phase 4 for one query tile, rows [t0, t0 + n) (staged in s.xq when
// `staged`), with the whole context and key sums in s.ctx: the features,
// row maxima and denominators in registers, then the output rows of out_bh
// ((T, 64) of this batch row and head). Output thread (jh, to, eq) =
// (tid / 128, tid / 16 % 8, tid % 16) owns rows to + 8 r, columns 4 eq..+3,
// over features [136 jh, 136 jh + 136). kMxu: s.ctx holds the context and
// key sums rounded to bf16, and qf is rounded as it is formed.
template <bool kMxu, class In>
__device__ __forceinline__ void query_tile(const In* __restrict__ q, long long st, int t0,
                                           int n, bool staged, Smem& s, float dn, float ratio,
                                           float* __restrict__ out_bh) {
  const int tg = threadIdx.x >> 4, jl = threadIdx.x & 15, eq = threadIdx.x & 15;
  const int jh = threadIdx.x >> 7, to = (threadIdx.x >> 4) & 7;
  const float* ksum_s = s.ctx + kMP * kD;
  if (!staged) {
    stage_rows(q, st, t0, n, s.xq, kPS);
    cp_async_wait_all();
    __syncthreads();
  }
  float acc[2][kJQ], sq[2];
  project<kMxu>(s.xq, s.proj, dn, acc, sq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = tg + 16 * r;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kJQ; ++i) {
      if (jl + 16 * i < kM) mx = fmaxf(mx, acc[r][i]);
    }
    mx = half_warp_max(mx);
    const float diag = diagonal<kMxu>(sq[r]);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < kJQ; ++i) {
      const int j = jl + 16 * i;
      float f = j < kM ? ratio * (expf(acc[r][i] - diag - mx) + kStabEps) : 0.f;
      if (kMxu) f = bf16r(f);
      den = fmaf(f, ksum_s[j], den);
      s.f[t * kFS + j] = f;
    }
    den = half_warp_sum(den);
    if (jl == 0) s.inv[t] = 1.f / (den + kDenEps);
  }
  __syncthreads();
  float4 o[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int j0 = jh * (kMP / 2);
#pragma unroll 2
  for (int j = j0; j < j0 + kMP / 2; j += 4) {
    float4 c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) c[u] = *reinterpret_cast<const float4*>(s.ctx + (j + u) * kD + 4 * eq);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 f = *reinterpret_cast<const float4*>(s.f + (to + 8 * r) * kFS + j);
      fma4(o[r], f.x, c[0]);
      fma4(o[r], f.y, c[1]);
      fma4(o[r], f.z, c[2]);
      fma4(o[r], f.w, c[3]);
    }
  }
  if (jh == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(s.v + (to + 8 * r) * kD + 4 * eq) = o[r];
    }
  }
  __syncthreads();
  if (jh == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = to + 8 * r;
      if (t < n) {
        const float4 h = *reinterpret_cast<const float4*>(s.v + t * kD + 4 * eq);
        const float w = s.inv[t];
        const float4 y = add4(o[r], h);
        *reinterpret_cast<float4*>(out_bh + ((size_t)t0 + t) * kD + 4 * eq) =
            make_float4(y.x * w, y.y * w, y.z * w, y.w * w);
      }
    }
  }
  __syncthreads();
}

template <bool kMxu, class In>
__global__ void __launch_bounds__(kThreads, 1)
favor_kernel(const In* __restrict__ q, const In* __restrict__ k,
             const In* __restrict__ v, const float* __restrict__ proj,
             const int* __restrict__ valid, int valid_all, float* __restrict__ out,
             int H, int T, long long sb, long long sh, long long st, float dn,
             float ratio) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int bh = blockIdx.y, b = bh / H;
  const int limit = max(0, min(valid != nullptr ? valid[b] : valid_all, T));
  const int n_key = (limit + kTT - 1) / kTT, n_tiles = (T + kTT - 1) / kTT;
  const size_t base = (size_t)b * sb + (size_t)(bh - b * H) * sh;

  // every copy this CTA needs first, in flight together
  stage_proj<kMxu>(proj, s.proj, dn);
  if (rank < n_key) {
    const int n = min(kTT, limit - rank * kTT);
    stage_rows(k + base, st, rank * kTT, n, s.xk, kPS);
    stage_rows(v + base, st, rank * kTT, n, s.v, kD);
  }
  if (rank < n_tiles) stage_rows(q + base, st, rank * kTT, min(kTT, T - rank * kTT), s.xq, kPS);
  cp_async_wait_all();
  __syncthreads();

  // 1. keys: the context of this CTA's tiles
  key_partials<kMxu>(k + base, v + base, st, 0, limit, rank, cs, s, dn, ratio);

  // 2. slice `rank` of the context summed over the cluster, into own copy
  cluster.sync();
  float4* own = reinterpret_cast<float4*>(s.ctx);
  const int per = (kCtx4 + cs - 1) / cs;
  cluster_slice_sum(cluster, s, rank, cs, per,
                    [&](int i, float4 sum) { own[i] = kMxu ? bf16r4(sum) : sum; });

  // 3. the other slices from their owners
  cluster.sync();
  float4 got[kGather];
#pragma unroll
  for (int u = 0; u < kGather; ++u) {
    const int i = threadIdx.x + u * kThreads, owner = i / per;
    if (i < kCtx4 && owner != rank) {
      got[u] = reinterpret_cast<const float4*>(cluster.map_shared_rank(s.ctx, owner))[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kGather; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kCtx4 && i / per != rank) own[i] = got[u];
  }
  cluster_arrive();
  __syncthreads();

  // 4. queries
  float* out_bh = out + (size_t)bh * T * kD;
  for (int tile = rank; tile < n_tiles; tile += cs) {
    const int t0 = tile * kTT;
    query_tile<kMxu>(q + base, st, t0, min(kTT, T - t0), tile == rank, s, dn, ratio, out_bh);
  }
  cluster_wait();
}

// The key half of favor_kernel (phases 1-2), for one shard of a
// time-sharded sequence: the context sum_t kf[t]^T v[t] (266, 64) and key
// sums sum_t kf[t] (266) over the keys [key_lo, key_hi) of each batch row,
// written to ctx (B, H, 266, 64) and ksum (B, H, 266). Same cluster size,
// tiles and rank-order sum as favor_kernel, so the range [0, valid) gives
// its context bit for bit.
template <bool kMxu, class In>
__global__ void __launch_bounds__(kThreads, 1)
moments_kernel(const In* __restrict__ k, const In* __restrict__ v,
               const float* __restrict__ proj, const int* __restrict__ key_lo, int lo_all,
               const int* __restrict__ key_hi, int hi_all, float* __restrict__ ctx,
               float* __restrict__ ksum, int H, int T, long long sb, long long sh,
               long long st, float dn, float ratio) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int bh = blockIdx.y, b = bh / H;
  const int lo = max(0, min(key_lo != nullptr ? key_lo[b] : lo_all, T));
  const int hi = max(lo, min(key_hi != nullptr ? key_hi[b] : hi_all, T));
  const size_t base = (size_t)b * sb + (size_t)(bh - b * H) * sh;
  const int first = first_tile(lo, rank, cs);

  stage_proj<kMxu>(proj, s.proj, dn);
  if (first * kTT < hi) {
    const int n = min(kTT, hi - first * kTT);
    stage_rows(k + base, st, first * kTT, n, s.xk, kPS);
    stage_rows(v + base, st, first * kTT, n, s.v, kD);
  }
  cp_async_wait_all();
  __syncthreads();

  key_partials<kMxu>(k + base, v + base, st, lo, hi, first, cs, s, dn, ratio);

  cluster.sync();
  float* ctx_bh = ctx + (size_t)bh * kM * kD;
  float* ksum_bh = ksum + (size_t)bh * kM;
  const int per = (kCtx4 + cs - 1) / cs;
  cluster_slice_sum(cluster, s, rank, cs, per, [&](int i, float4 sum) {
    const int e = 4 * i;
    if (e < kMP * kD) {
      if (e / kD < kM) *reinterpret_cast<float4*>(ctx_bh + e) = sum;
    } else {
      const int j = e - kMP * kD;
      const float part[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < kM) ksum_bh[j + u] = part[u];
      }
    }
  });
  // no CTA leaves while a peer still reads its shared memory
  cluster.sync();
}

// The query half of favor_kernel (phase 4), for one shard: out rows of the
// query tile blockIdx.x of each (batch row, head) from the context and key
// sums summed over every shard (moments_kernel's outputs, all-reduced).
// One CTA a tile, no cluster.
template <bool kMxu, class In>
__global__ void __launch_bounds__(kThreads, 1)
apply_kernel(const In* __restrict__ q, const float* __restrict__ proj,
             const float* __restrict__ ctx, const float* __restrict__ ksum,
             float* __restrict__ out, int H, int T, long long sb, long long sh,
             long long st, float dn, float ratio) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tile = blockIdx.x, bh = blockIdx.y, b = bh / H;
  const size_t base = (size_t)b * sb + (size_t)(bh - b * H) * sh;
  const int t0 = tile * kTT, n = min(kTT, T - t0);

  stage_proj<kMxu>(proj, s.proj, dn);
  const float* ctx_bh = ctx + (size_t)bh * kM * kD;
  for (int i = threadIdx.x; i < kM * (kD / 4); i += kThreads) {
    cp_async16(s.ctx + 4 * i, ctx_bh + 4 * i);
  }
  for (int i = threadIdx.x; i < (kMP - kM) * kD; i += kThreads) s.ctx[kM * kD + i] = 0.f;
  for (int j = threadIdx.x; j < kMP; j += kThreads) {
    const float ks = j < kM ? ksum[(size_t)bh * kM + j] : 0.f;
    s.ctx[kMP * kD + j] = kMxu ? bf16r(ks) : ks;
  }
  stage_rows(q + base, st, t0, n, s.xq, kPS);
  cp_async_wait_all();
  __syncthreads();
  if (kMxu) {  // the all-reduced context rounded where the single launch rounds it
    float4* c4 = reinterpret_cast<float4*>(s.ctx);
    for (int i = threadIdx.x; i < kM * (kD / 4); i += kThreads) c4[i] = bf16r4(c4[i]);
    __syncthreads();
  }

  query_tile<kMxu>(q + base, st, t0, n, true, s, dn, ratio, out + (size_t)bh * T * kD);
}

// Every kernel: the fp32 form's, then the bf16-operand form's on fp32 and on
// bf16 q, k, v (favor, moments, apply each), in performer_attention_info's
// order.
const void* const* all_kernels() {
  static const void* const fns[] = {
      (const void*)favor_kernel<false, float>, (const void*)moments_kernel<false, float>,
      (const void*)apply_kernel<false, float>, (const void*)favor_kernel<true, float>,
      (const void*)moments_kernel<true, float>, (const void*)apply_kernel<true, float>,
      (const void*)favor_kernel<true, __nv_bfloat16>,
      (const void*)moments_kernel<true, __nv_bfloat16>,
      (const void*)apply_kernel<true, __nv_bfloat16>};
  return fns;
}
constexpr int kKernels = 9;

// The dynamic shared memory of every kernel, set once per process.
cudaError_t setup() {
  for (int i = 0; i < kKernels; ++i) {
    const cudaError_t err = cudaFuncSetAttribute(
        all_kernels()[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// CTAs per cluster: the least power of two >= the tile count, at most 8.
int cluster_size(int T) {
  const int n_tiles = (T + kTT - 1) / kTT;
  int cs = 1;
  while (cs < n_tiles && cs < kMaxCluster) cs *= 2;
  return cs;
}

// One launch of `kernel` in clusters of cluster_size(T) CTAs along x, one
// cluster per (batch row, head).
template <class... Params, class... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), int BH, int T, void* stream,
                             Args... args) {
  const int cs = cluster_size(T);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, BH, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kMxu, class In>
int favor_launch(const void* q, const void* k, const void* v, const float* proj,
                 const int* valid, float* out, int valid_all, int B, int H, int T,
                 long long sb, long long sh, long long st, float dn, float ratio, void* stream) {
  static const cudaError_t once = setup();
  if (once != cudaSuccess) return (int)once;
  if (B * H == 0 || T == 0) return 0;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_clustered(favor_kernel<kMxu, In>, B * H, T, stream,
                               static_cast<const In*>(q), static_cast<const In*>(k),
                               static_cast<const In*>(v), proj, valid, valid_all, out, H, T, sb,
                               sh, st, dn, ratio);
}

template <bool kMxu, class In>
int moments_launch(const void* k, const void* v, const float* proj, const int* key_lo,
                   int lo_all, const int* key_hi, int hi_all, float* ctx, float* ksum, int B,
                   int H, int T, long long sb, long long sh, long long st, float dn,
                   float ratio, void* stream) {
  static const cudaError_t once = setup();
  if (once != cudaSuccess) return (int)once;
  if (B * H == 0) return 0;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_clustered(moments_kernel<kMxu, In>, B * H, T, stream,
                               static_cast<const In*>(k), static_cast<const In*>(v), proj,
                               key_lo, lo_all, key_hi, hi_all, ctx, ksum, H, T, sb, sh, st, dn,
                               ratio);
}

template <bool kMxu, class In>
int apply_launch(const void* q, const float* proj, const float* ctx, const float* ksum,
                 float* out, int B, int H, int T, long long sb, long long sh, long long st,
                 float dn, float ratio, void* stream) {
  static const cudaError_t once = setup();
  if (once != cudaSuccess) return (int)once;
  if (B * H == 0 || T == 0) return 0;
  if (B * H > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + kTT - 1) / kTT, B * H, 1);
  apply_kernel<kMxu, In><<<grid, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(
      static_cast<const In*>(q), proj, ctx, ksum, out, H, T, sb, sh, st, dn, ratio);
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster size a launch at T takes, then the kernel's registers per
// thread, local-memory (spilled) bytes per thread and dynamic shared memory
// per CTA. which: 0 the single launch, 1 the moments, 2 the apply kernel;
// + 3 the bf16-operand form's on fp32 q, k, v, + 6 on bf16 ones.
extern "C" int performer_attention_info(int T, int which, int* out) {
  static const cudaError_t once = setup();
  if (once != cudaSuccess) return (int)once;
  if (which < 0 || which >= kKernels) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, all_kernels()[which]);
  if (err != cudaSuccess) return (int)err;
  out[0] = which % 3 == 2 ? 1 : cluster_size(T);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)sizeof(Smem);
  return 0;
}

// q, k, v: (B, H, T, 64) fp32 views with unit column stride and batch, head
// and time strides sb, sh, st (floats; multiples of 4, 16-byte aligned
// base); out: (B, H, T, 64) contiguous; proj: (266, 64). valid: (B,) int32
// on the card, or null to take valid_all for every row.
extern "C" int performer_attention_launch(const float* q, const float* k, const float* v,
                                          const float* proj, const int* valid, float* out,
                                          int valid_all, int B, int H, int T, long long sb,
                                          long long sh, long long st, float dn, float ratio,
                                          void* stream) {
  return favor_launch<false, float>(q, k, v, proj, valid, out, valid_all, B, H, T, sb, sh, st,
                                    dn, ratio, stream);
}

// The bf16-operand form: q, k, v fp32, or bf16 when in_bf16 (strides in
// elements, as above); the rest as performer_attention_launch.
extern "C" int performer_attention_mxu_bf16_launch(const void* q, const void* k, const void* v,
                                                   const float* proj, const int* valid,
                                                   float* out, int valid_all, int B, int H, int T,
                                                   long long sb, long long sh, long long st,
                                                   float dn, float ratio, int in_bf16,
                                                   void* stream) {
  return in_bf16 ? favor_launch<true, __nv_bfloat16>(q, k, v, proj, valid, out, valid_all, B, H,
                                                     T, sb, sh, st, dn, ratio, stream)
                 : favor_launch<true, float>(q, k, v, proj, valid, out, valid_all, B, H, T, sb,
                                             sh, st, dn, ratio, stream);
}

// k, v: views as q, k, v above; key_lo / key_hi: (B,) int32 on the card, or
// null to take lo_all / hi_all for every row (clipped to [0, T], an empty
// range gives zeros); ctx: (B, H, 266, 64) and ksum (B, H, 266) contiguous,
// 16-byte aligned.
extern "C" int performer_attention_moments_launch(
    const float* k, const float* v, const float* proj, const int* key_lo, int lo_all,
    const int* key_hi, int hi_all, float* ctx, float* ksum, int B, int H, int T, long long sb,
    long long sh, long long st, float dn, float ratio, void* stream) {
  return moments_launch<false, float>(k, v, proj, key_lo, lo_all, key_hi, hi_all, ctx, ksum, B,
                                      H, T, sb, sh, st, dn, ratio, stream);
}

// The bf16-operand form's moments (fp32 sums of the rounded kf and v);
// in_bf16 as above.
extern "C" int performer_attention_moments_mxu_bf16_launch(
    const void* k, const void* v, const float* proj, const int* key_lo, int lo_all,
    const int* key_hi, int hi_all, float* ctx, float* ksum, int B, int H, int T, long long sb,
    long long sh, long long st, float dn, float ratio, int in_bf16, void* stream) {
  return in_bf16 ? moments_launch<true, __nv_bfloat16>(k, v, proj, key_lo, lo_all, key_hi,
                                                       hi_all, ctx, ksum, B, H, T, sb, sh, st,
                                                       dn, ratio, stream)
                 : moments_launch<true, float>(k, v, proj, key_lo, lo_all, key_hi, hi_all, ctx,
                                               ksum, B, H, T, sb, sh, st, dn, ratio, stream);
}

// q: a view as above; ctx (B, H, 266, 64) and ksum (B, H, 266) contiguous,
// 16-byte aligned; out: (B, H, T, 64) contiguous.
extern "C" int performer_attention_apply_launch(const float* q, const float* proj,
                                                const float* ctx, const float* ksum,
                                                float* out, int B, int H, int T, long long sb,
                                                long long sh, long long st, float dn,
                                                float ratio, void* stream) {
  return apply_launch<false, float>(q, proj, ctx, ksum, out, B, H, T, sb, sh, st, dn, ratio,
                                    stream);
}

// The bf16-operand form's apply (the context and key sums rounded as they
// are staged); in_bf16 as above.
extern "C" int performer_attention_apply_mxu_bf16_launch(const void* q, const float* proj,
                                                         const float* ctx, const float* ksum,
                                                         float* out, int B, int H, int T,
                                                         long long sb, long long sh,
                                                         long long st, float dn, float ratio,
                                                         int in_bf16, void* stream) {
  return in_bf16 ? apply_launch<true, __nv_bfloat16>(q, proj, ctx, ksum, out, B, H, T, sb, sh,
                                                     st, dn, ratio, stream)
                 : apply_launch<true, float>(q, proj, ctx, ksum, out, B, H, T, sb, sh, st, dn,
                                             ratio, stream);
}
