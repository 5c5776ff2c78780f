// The ResBlock1 convolution chain on a time tile held in shared memory,
// shared by the narrow-stage NSF-HiFiGAN kernels: the trio
// (resblocks.cu), one chain (resblock_chain.cu) and the whole stage
// (fused_stage.cu).
//
// A block owns one (time tile, batch row). It holds two (C, W) fp32
// activation buffers in shared memory, the chain state h and the temporary
// t, for a tile of W = TILE + 2 * 64 columns (the 64-column halo covers the
// widest chain's receptive margin, 60). W is chosen per C so the buffers
// fill ~170-200 KB of the 227 KB a block may use: W = 320, 640, 1280, 2560
// for C = 64, 32, 16, 8. Each warp owns 8 output channels x 10 columns per
// lane (80 fp32 accumulators a thread), reads its inputs from shared memory
// conflict-free (lanes on consecutive columns) and its weights, laid out
// (C_in, tap, C_out), as warp-uniform float4 loads from shared memory. The
// weights of each conv stream through shared memory in chunks of 4 input
// channels, double-buffered with cp.async so that the next chunk's L2
// latency hides under this chunk's FMAs. The products are fp32 FMAs.
// Every conv output is zero past the sequence's (or the row's valid)
// length, so h stays zero there and no conv input needs a mask. Halo
// columns are recomputed by neighbouring tiles.
#pragma once

#include <cuda_runtime.h>

namespace rbconv {

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

// This thread's first output channel and first column of the tile; its
// columns are col0 + 32 j, j < kTT.
template <int C>
__device__ __forceinline__ int thread_co0() {
  return ((threadIdx.x >> 5) % Geometry<C>::kChannelGroups) * kCoT;
}

template <int C>
__device__ __forceinline__ int thread_col0() {
  return ((threadIdx.x >> 5) / Geometry<C>::kChannelGroups) * 32 * kTT + (threadIdx.x & 31);
}

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

// Zero all of t, pads included, and the pads of h: no conv writes a pad
// column, and columns a conv skips keep finite values.
template <int C>
__device__ void zero_buffers(float* h, float* t) {
  using G = Geometry<C>;
  for (int i = threadIdx.x; i < C * G::S; i += kThreads) t[i] = 0.f;
  for (int i = threadIdx.x; i < C * 2 * kPad; i += kThreads) {
    const int r = i / (2 * kPad), c = i % (2 * kPad);
    h[r * G::S + (c < kPad ? c : G::W + c)] = 0.f;
  }
}

// One conv over the tile, all W columns. conv1 (kFirst) reads
// leaky(src) and stores leaky(conv) * mask into dst; conv2 reads src as it
// is and adds conv * mask into dst (the residual). s_w: two weight buffers.
// w: (C_in, K, C_out); g0: sequence index of column 0; limit: the length.
template <int C, int K, bool kFirst>
__device__ void conv_pass(const float* src, float* dst, const float* __restrict__ w,
                          const float* __restrict__ bias, float* s_w, int d, int g0,
                          int limit) {
  using G = Geometry<C>;
  constexpr int kChunk = kCh * K * C;
  constexpr int kChunks = C / kCh;
  const int co0 = thread_co0<C>();
  const int col0 = thread_col0<C>();

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

// One ResBlock1 chain on h (t is its temporary): for each of the three
// dilations, h += conv_k(leaky(conv_k,d(leaky(h)))). w: (3, 2, C_in, K,
// C_out); b: (3, 2, C). Each thread's conv2 epilogue writes the same h
// columns the thread reads back afterwards.
template <int C, int K>
__device__ void run_chain(float* h, float* t, float* s_w, const float* w, const float* b,
                          int d0, int d1, int d2, int g0, int limit) {
  const int dil[3] = {d0, d1, d2};
  for (int i = 0; i < 3; ++i) {
    conv_pass<C, K, true>(h, t, w + (size_t)(2 * i) * C * K * C, b + 2 * i * C, s_w,
                          dil[i], g0, limit);
    __syncthreads();
    conv_pass<C, K, false>(t, h, w + (size_t)(2 * i + 1) * C * K * C,
                           b + (2 * i + 1) * C, s_w, 1, g0, limit);
    __syncthreads();
  }
}

// The chain of kernel size k (3, 7 or 11), dispatched at run time.
template <int C>
__device__ void run_chain_k(int k, float* h, float* t, float* s_w, const float* w,
                            const float* b, int d0, int d1, int d2, int g0, int limit) {
  if (k == 3) run_chain<C, 3>(h, t, s_w, w, b, d0, d1, d2, g0, limit);
  else if (k == 7) run_chain<C, 7>(h, t, s_w, w, b, d0, d1, d2, g0, limit);
  else run_chain<C, 11>(h, t, s_w, w, b, d0, d1, d2, g0, limit);
}

// The trio's kernel sizes in chain order.
__device__ __forceinline__ int trio_k(int r) { return r == 0 ? 3 : r == 1 ? 7 : 11; }

__device__ __forceinline__ void fill_regs(float (&v)[kCoT][kTT], float x) {
#pragma unroll
  for (int o = 0; o < kCoT; ++o)
#pragma unroll
    for (int j = 0; j < kTT; ++j) v[o][j] = x;
}

// acc += this thread's own h entries: the columns its conv2 epilogue wrote,
// so no barrier is needed after the chain.
template <int C>
__device__ __forceinline__ void add_own_h(const float* h, float (&acc)[kCoT][kTT]) {
  const int co0 = thread_co0<C>(), col0 = thread_col0<C>();
#pragma unroll
  for (int o = 0; o < kCoT; ++o)
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[o][j] += h[(co0 + o) * Geometry<C>::S + kPad + col0 + 32 * j];
}

// out[c, g] = scale * v for this thread's interior columns (not halo) that
// lie inside [0, T). out: (C, T) of this batch row.
template <int C>
__device__ __forceinline__ void store_interior(float* out, const float (&v)[kCoT][kTT],
                                               float scale, int g0, int T) {
  const int co0 = thread_co0<C>(), col0 = thread_col0<C>();
#pragma unroll
  for (int j = 0; j < kTT; ++j) {
    const int col = col0 + 32 * j;
    const int g = g0 + col;
    if (col >= kHalo && col < kHalo + Geometry<C>::kTile && g < T) {
#pragma unroll
      for (int o = 0; o < kCoT; ++o) out[(size_t)(co0 + o) * T + g] = v[o][j] * scale;
    }
  }
}

// The Generator's f0-source injection conv at output column g: kernel ksrc
// (2 s_src, or 1), stride s_src, padding s_src / 2, over har (T_final,).
__device__ __forceinline__ float noise_conv_at(const float* har, const float* wnc_c, float bnc_c,
                                               int g, int s_src, int ksrc, int t_final) {
  float s = bnc_c;
  const int h0 = g * s_src - s_src / 2;
  for (int tau = 0; tau < ksrc; ++tau) {
    const int hi = h0 + tau;
    if (hi >= 0 && hi < t_final) s = fmaf(wnc_c[tau], har[hi], s);
  }
  return s;
}

template <int C, typename Kernel, typename Args>
int launch_tiles(Kernel kernel, const Args& a, int T, int B, cudaStream_t stream) {
  using G = Geometry<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + G::kTile - 1) / G::kTile, B);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rbconv
