// The resblock trio of a narrow NSF-HiFiGAN stage, with the f0-source
// injection conv folded in.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::fused_resblocks_inject_pallas
// (impl _fused_resblocks_fwd_impl, body _fused_rb_kernel / _trio_chain /
// _rb_conv_cf) and, with har == nullptr, fused_resblocks_pallas.
//
//   x0  = x + noise_conv(har)      noise_conv: kernel ksrc (2 s_src, or 1),
//                                  stride s_src, padding s_src / 2
//   out = mean over k in {3, 7, 11} of chain_k(x0),
//   chain_k: for d in dilations: h += conv_k(leaky(conv_k,d(leaky(h))))
//   every conv zero-pads at the sequence end (or at a row's valid length).
//
// Bound on the H100: operations. A stage does 2 C^2 * 6 * (3 + 7 + 11)
// flops per sample (1.03 MFLOP at C = 64) on 8 C bytes of input and output:
// fp32 CUDA-core work far above the ridge. The TPU kernel's point was to
// keep the 18 conv intermediates out of HBM; so is this one's.
//
// Design: one block per (time tile, batch row). The block holds two (C, W)
// activation buffers in shared memory, the chain state h and the
// temporary t, for a tile of W = TILE + 2 * 64 columns (the 64-column halo
// covers the widest chain's receptive margin, 60). W is chosen per C so the
// buffers fill ~170-200 KB of the 227 KB a block may use (the TPU kernel's
// 8192-wide tiles do not fit): W = 320, 640, 1280, 2560 for C = 64, 32, 16,
// 8. Each warp owns 8 output channels x 10 columns per lane (80 fp32
// accumulators a thread), reads its inputs from shared memory conflict-free
// (lanes on consecutive columns) and its weights, laid out (C_in, tap,
// C_out), as warp-uniform float4 loads from shared memory: a stage's trio
// weights are 3.4 MB at C = 64, far past shared memory, so they stream
// through it (below). The products are fp32 FMAs: a 3xTF32 tensor-core
// version measured 13% faster but 20x less
// accurate (9.4e-5 against the 1e-4 tolerance at C = 64; the tensor cores'
// accumulation truncates), see PERF.md. The weights of each conv stream
// through shared memory in chunks of 4 input channels, double-buffered
// with cp.async so that the next chunk's L2 latency hides under this
// chunk's FMAs (8-14% faster than reading them through L1, bit-identical).
// Masking follows the sequence exactly: x0 and every conv output are zero
// past the valid length, so h stays zero there and no conv input needs a
// mask. The trio mean is kept in registers. Halo columns are recomputed by
// neighbouring tiles (W / TILE = 1.67 at C = 64); skipping each conv's
// unneeded columns with branches in the FMA loop measured 2.2x slower, so
// that wants compile-time column ranges.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCoT = 8;    // output channels per warp
constexpr int kTT = 10;    // columns per lane
constexpr int kHalo = 64;
constexpr int kPad = 32;   // zero columns on each side of a buffer row
constexpr int kCh = 4;     // input channels per staged weight chunk
constexpr int kMaxK = 11;

template <int C>
struct Geometry {
  static constexpr int kChannelGroups = C / kCoT;
  static constexpr int kTimeGroups = kWarps / kChannelGroups;
  static constexpr int W = kTimeGroups * 32 * kTT;
  static constexpr int kTile = W - 2 * kHalo;
  static constexpr int S = W + 2 * kPad;  // row stride of a buffer
  static constexpr int kChunk = kCh * kMaxK * C;  // floats per weight buffer
  static constexpr size_t kSmem = (2ull * C * S + 2ull * kChunk) * sizeof(float);
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, 0.1f * v); }

struct Args {
  const float* x;     // (B, C, T)
  const float* har;   // (B, T_final) or nullptr
  const float* wnc;   // (C, ksrc)
  const float* bnc;   // (C,)
  const float* w[3];  // (n_dil, 2, C_in, k, C_out)
  const float* b[3];  // (n_dil, 2, C)
  const int* valid;   // (B,) or nullptr
  float* out;         // (B, C, T)
  int T, t_final, s_src, ksrc;
  int dil[3];
};

// One conv over the tile, all W columns. conv1 (kFirst) reads
// leaky(src) and stores leaky(conv) * mask into dst; conv2 reads src as it
// is and adds conv * mask into dst (the residual). s_w: two weight buffers.
template <int C, int K, bool kFirst>
__device__ void conv_pass(const float* src, float* dst, const float* __restrict__ w,
                          const float* __restrict__ bias, float* s_w, int d, int g0,
                          int limit) {
  using G = Geometry<C>;
  constexpr int kChunk = kCh * K * C;
  constexpr int kChunks = C / kCh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int co0 = (warp % G::kChannelGroups) * kCoT;
  const int col0 = (warp / G::kChannelGroups) * 32 * kTT + lane;

  auto stage = [&](int c) {
    const float* gw = w + (size_t)c * kChunk;
    float* sw = s_w + (c & 1) * G::kChunk;
    for (int i = threadIdx.x * 4; i < kChunk; i += kThreads * 4) cp_async16(sw + i, gw + i);
    cp_async_commit();
  };

  float acc[kCoT][kTT];
#pragma unroll
  for (int o = 0; o < kCoT; ++o) {
    const float bo = bias[co0 + o];
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[o][j] = bo;
  }
  stage(0);
  for (int c = 0; c < kChunks; ++c) {
    if (c + 1 < kChunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sw = s_w + (c & 1) * G::kChunk + co0;
#pragma unroll 1
    for (int cc = 0; cc < kCh; ++cc) {
      const float* row = src + (c * kCh + cc) * G::S + kPad + col0;
      const float* wr = sw + cc * K * C;
#pragma unroll
      for (int tap = 0; tap < K; ++tap) {
        const int off = (tap - (K - 1) / 2) * d;
        const float4 w0 = *reinterpret_cast<const float4*>(wr + tap * C);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + tap * C + 4);
        const float wv[kCoT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < kTT; ++j) {
          float v = row[off + 32 * j];
          if (kFirst) v = leaky(v);
#pragma unroll
          for (int o = 0; o < kCoT; ++o) acc[o][j] = fmaf(wv[o], v, acc[o][j]);
        }
      }
    }
    __syncthreads();  // this buffer is restaged two chunks on
  }
#pragma unroll
  for (int j = 0; j < kTT; ++j) {
    const int col = col0 + 32 * j;
    const int g = g0 + col;
    const bool in = g >= 0 && g < limit;
#pragma unroll
    for (int o = 0; o < kCoT; ++o) {
      float* p = dst + (co0 + o) * G::S + kPad + col;
      if (kFirst) {
        *p = in ? leaky(acc[o][j]) : 0.f;
      } else if (in) {
        *p += acc[o][j];
      }
    }
  }
}

template <int C, int K>
__device__ void run_chain(const Args& a, float* h, float* t, float* s_w, const float* w,
                          const float* b, int g0, int limit) {
  for (int i = 0; i < 3; ++i) {
    conv_pass<C, K, true>(h, t, w + (size_t)(2 * i) * C * K * C, b + 2 * i * C, s_w,
                          a.dil[i], g0, limit);
    __syncthreads();
    conv_pass<C, K, false>(t, h, w + (size_t)(2 * i + 1) * C * K * C,
                           b + (2 * i + 1) * C, s_w, 1, g0, limit);
    __syncthreads();
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) resblocks_kernel(Args a) {
  using G = Geometry<C>;
  extern __shared__ float sm[];
  float* h = sm;
  float* t = sm + C * G::S;
  float* s_w = sm + 2 * C * G::S;
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * G::kTile - kHalo;  // sequence index of column 0
  const int limit = a.valid != nullptr ? min(a.valid[bi], a.T) : a.T;
  const float* x = a.x + (size_t)bi * C * a.T;
  const float* har = a.har != nullptr ? a.har + (size_t)bi * a.t_final : nullptr;

  // t starts as zeros, pads included, and the pads of h are zeroed: no conv
  // writes a pad column, and columns a conv skips keep finite values
  for (int i = threadIdx.x; i < C * G::S; i += kThreads) t[i] = 0.f;
  for (int i = threadIdx.x; i < C * 2 * kPad; i += kThreads) {
    const int r = i / (2 * kPad), c = i % (2 * kPad);
    h[r * G::S + (c < kPad ? c : G::W + c)] = 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int co0 = (warp % G::kChannelGroups) * kCoT;
  const int col0 = (warp / G::kChannelGroups) * 32 * kTT + lane;
  float mean[kCoT][kTT];
#pragma unroll
  for (int o = 0; o < kCoT; ++o)
#pragma unroll
    for (int j = 0; j < kTT; ++j) mean[o][j] = 0.f;

  for (int r = 0; r < 3; ++r) {
    __syncthreads();  // the previous chain is done with h and t
    // h = x0, zero outside [0, limit)
    for (int i = threadIdx.x; i < C * G::W; i += kThreads) {
      const int c = i / G::W, col = i % G::W;
      const int g = g0 + col;
      float v = 0.f;
      if (g >= 0 && g < limit) {
        v = x[(size_t)c * a.T + g];
        if (har != nullptr) {
          float s = a.bnc[c];
          const int h0 = g * a.s_src - a.s_src / 2;
          for (int tau = 0; tau < a.ksrc; ++tau) {
            const int hi = h0 + tau;
            if (hi >= 0 && hi < a.t_final) s = fmaf(a.wnc[c * a.ksrc + tau], har[hi], s);
          }
          v += s;
        }
      }
      h[c * G::S + kPad + col] = v;
    }
    __syncthreads();
    if (r == 0) run_chain<C, 3>(a, h, t, s_w, a.w[0], a.b[0], g0, limit);
    else if (r == 1) run_chain<C, 7>(a, h, t, s_w, a.w[1], a.b[1], g0, limit);
    else run_chain<C, 11>(a, h, t, s_w, a.w[2], a.b[2], g0, limit);
    // each thread reads back the h columns its own conv2 epilogue wrote
#pragma unroll
    for (int o = 0; o < kCoT; ++o)
#pragma unroll
      for (int j = 0; j < kTT; ++j)
        mean[o][j] += h[(co0 + o) * G::S + kPad + col0 + 32 * j];
  }

  float* out = a.out + (size_t)bi * C * a.T;
#pragma unroll
  for (int j = 0; j < kTT; ++j) {
    const int col = col0 + 32 * j;
    const int g = g0 + col;
    if (col >= kHalo && col < kHalo + G::kTile && g < a.T) {
#pragma unroll
      for (int o = 0; o < kCoT; ++o) out[(size_t)(co0 + o) * a.T + g] = mean[o][j] / 3.0f;
    }
  }
}

template <int C>
int launch(const Args& a, int B, cudaStream_t stream) {
  using G = Geometry<C>;
  cudaError_t err = cudaFuncSetAttribute(
      resblocks_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + G::kTile - 1) / G::kTile, B);
  resblocks_kernel<C><<<grid, kThreads, G::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (B, C, T) fp32; har: (B, T_final) or null (no injection), with
// wnc (C, ksrc) and bnc (C,); w_r: (3, 2, C, k_r, C) for k_r = 3, 7, 11;
// b_r: (3, 2, C); valid: (B,) int32 sample counts or null. C in 8/16/32/64.
extern "C" int resblocks_launch(const float* x, const float* har, const float* wnc,
                                const float* bnc, const float* w0, const float* w1,
                                const float* w2, const float* b0, const float* b1,
                                const float* b2, const int* valid, float* out, int B,
                                int C, int T, int t_final, int s_src, int ksrc, int d0,
                                int d1, int d2, void* stream) {
  Args a{x, har, wnc, bnc, {w0, w1, w2}, {b0, b1, b2}, valid, out,
         T, t_final, s_src, ksrc, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
