// A whole narrow NSF-HiFiGAN stage in one kernel: leaky(0.1) -> the
// transposed-conv upsample -> + the f0-source injection conv -> the mean of
// the three ResBlock1 chains.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::fused_stage_pallas (impl
// _fused_stage_fwd_impl, body _fused_stage_kernel).
//
//   up[g]  = b_up + sum_ci sum_kap w_up[ci, :, kap] leaky(x_pre[ci, m]),
//            over g = m u - p + kap (ConvTranspose1d, kernel k = 2u, stride u,
//            padding p = (k - u) / 2)
//   x0[g]  = up[g] + noise_conv(har)[g]          (as csrc/resblocks.cu)
//   out    = mean over k in {3, 7, 11} of chain_k(x0)
//
// Bound on the H100: operations, the trio's 2 C^2 * 6 * 21 flops per
// output sample plus 2 * 2C * C * 2 for the transposed conv (~3 % more).
// Compared with the transposed conv on cuDNN followed by the trio kernel,
// the stage's input is read at its own rate (x_pre, 2C channels at T_out /
// u: the bytes of the C-channel activation it replaces, divided by u / 2),
// and the upsampled activation is neither written nor read apart from the
// x0 scratch below.
//
// Design: csrc/resblock_conv.cuh, the trio kernel's tile and conv chain,
// with another fill of h. For output column g with phase r = (g + p) mod u
// and m0 = (g + p - r) / u, the transposed conv reads exactly two
// pre-upsample columns per input channel: x_pre[m0] with tap r and
// x_pre[m0 - 1] with tap r + u. Since u divides 32 and the tile start, each
// thread's ten columns (32 apart) share one phase, so it loads 2 x 8 weights
// per input channel (through L1; 2C * k * C floats, 131 KB at C = 64, k = 4)
// and reads the x_pre window, leaky'd and staged into the t buffer (which
// the chain only needs after the fill) as C input channels x (W / u + 2)
// columns at a time. x0 is computed once per tile and kept for the second
// and third chains in a per-tile scratch in device memory (each thread
// writes and reads back its own entries, 1.67x the output's bytes at C =
// 64, mostly in L2). Computing it again before each chain costs two more
// fills (~6 % of the stage's FMAs, at a lower rate than the chain's), and
// keeping it in registers beside the trio mean would add 80 to a thread's
// 160 (the mean and a conv's accumulators) out of 255: a version that
// redid the fill, with the mean live across it, already spilled at 255.

#include "resblock_conv.cuh"

namespace {

using namespace rbconv;

struct Args {
  const float* x;    // (B, 2C, T_in), the stage's input before the leaky
  const float* har;  // (B, T_final)
  const float* wup;  // (2C, k, C): (C_in, tap, C_out), k = 2u
  const float* bup;  // (C,)
  const float* wnc;  // (C, ksrc)
  const float* bnc;  // (C,)
  const float* w[3];  // (3, 2, C_in, k_r, C_out)
  const float* b[3];  // (3, 2, C)
  float* out;         // (B, C, T_out)
  float* x0;          // (B, n_tiles, C, W): each tile's x0
  int t_in, T, u, p, t_final, s_src, ksrc;
  int dil[3];
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// h = x0 on all W columns of the tile, zero outside [0, T), and each
// thread's own entries also into x0s (C, W). Uses t as the staging buffer
// of the x_pre window; leaves t zero.
template <int C>
__device__ void fill_stage(const Args& a, const float* x, const float* har, float* h,
                           float* t, float* x0s, int g0) {
  using G = Geometry<C>;
  const int co0 = thread_co0<C>(), col0 = thread_col0<C>();
  const int u = a.u, k = 2 * a.u;
  const int nx = G::W / u + 2;
  const int mbase = floor_div(g0 + a.p, u) - 1;  // x_pre index of window column 0
  const int r = ((g0 + col0 + a.p) % u + u) % u;  // this thread's phase
  int ml[kTT];  // window column of m0 for each of this thread's columns
#pragma unroll
  for (int j = 0; j < kTT; ++j) ml[j] = (g0 + col0 + 32 * j + a.p - r) / u - mbase;

  float acc[kCoT][kTT];
  fill_regs(acc, 0.f);
  for (int half = 0; half < 2; ++half) {
    __syncthreads();  // t is free (the chain before, or the first half, is done)
    for (int i = threadIdx.x; i < C * nx; i += kThreads) {
      const int c = i / nx, m = mbase + i % nx;
      t[i] = (m >= 0 && m < a.t_in) ? leaky(x[(size_t)(half * C + c) * a.t_in + m]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < C; ++c) {
      const float* wr = a.wup + ((size_t)(half * C + c) * k + r) * C + co0;
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(wr));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(wr + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(wr + u * C));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(wr + u * C + 4));
      const float wa[kCoT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wb[kCoT] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float* xr = t + c * nx;
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
        const float va = xr[ml[j]], vb = xr[ml[j] - 1];
#pragma unroll
        for (int o = 0; o < kCoT; ++o) acc[o][j] = fmaf(wb[o], vb, fmaf(wa[o], va, acc[o][j]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kTT; ++j) {
    const int col = col0 + 32 * j;
    const int g = g0 + col;
    const bool in = g >= 0 && g < a.T;
#pragma unroll
    for (int o = 0; o < kCoT; ++o) {
      const int c = co0 + o;
      const float v = in ? acc[o][j] + a.bup[c] +
                               noise_conv_at(har, a.wnc + c * a.ksrc, a.bnc[c], g, a.s_src,
                                             a.ksrc, a.t_final)
                         : 0.f;
      h[c * G::S + kPad + col] = v;
      x0s[c * G::W + col] = v;
    }
  }
  __syncthreads();  // every thread is done reading the staged window
  for (int i = threadIdx.x; i < C * G::S; i += kThreads) t[i] = 0.f;
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) fused_stage_kernel(Args a) {
  using G = Geometry<C>;
  extern __shared__ float sm[];
  float* h = sm;
  float* t = sm + C * G::S;
  float* s_w = sm + 2 * C * G::S;
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * G::kTile - kHalo;  // sequence index of column 0
  const float* x = a.x + (size_t)bi * 2 * C * a.t_in;
  const float* har = a.har + (size_t)bi * a.t_final;
  float* x0s = a.x0 + ((size_t)bi * gridDim.x + blockIdx.x) * C * G::W;
  zero_buffers<C>(h, t);
  fill_stage<C>(a, x, har, h, t, x0s, g0);
  run_chain<C, 3>(h, t, s_w, a.w[0], a.b[0], a.dil[0], a.dil[1], a.dil[2], g0, a.T);
  // the mean starts after the fill, so it holds no registers there
  float mean[kCoT][kTT];
  fill_regs(mean, 0.f);
  add_own_h<C>(h, mean);
  const int co0 = thread_co0<C>(), col0 = thread_col0<C>();
  for (int r = 1; r < 3; ++r) {
    // h = x0 again: each thread its own entries, as it wrote them
#pragma unroll
    for (int o = 0; o < kCoT; ++o)
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
        const int col = col0 + 32 * j;
        h[(co0 + o) * G::S + kPad + col] = x0s[(co0 + o) * G::W + col];
      }
    __syncthreads();
    run_chain_k<C>(trio_k(r), h, t, s_w, a.w[r], a.b[r], a.dil[0], a.dil[1], a.dil[2], g0,
                   a.T);
    add_own_h<C>(h, mean);
  }
  store_interior<C>(a.out + (size_t)bi * C * a.T, mean, 1.0f / 3.0f, g0, a.T);
}

template <int C>
long long scratch_floats(int B, int T) {
  using G = Geometry<C>;
  return (long long)B * ((T + G::kTile - 1) / G::kTile) * C * G::W;
}

}  // namespace

// x: (B, 2C, T_in) fp32; har: (B, T_final); wup: (2C, 2u, C); bup: (C,);
// wnc: (C, ksrc); bnc: (C,); w_r: (3, 2, C, k_r, C) for k_r = 3, 7, 11; b_r:
// (3, 2, C); out: (B, C, T_out), T_out = (T_in - 1) u - 2p + 2u; x0: scratch
// of fused_stage_scratch_floats(B, C, T_out) floats. C in 8/16/32/64, u in
// 1/2/4/8 (a divisor of 32 and of every tile start).
extern "C" int fused_stage_launch(const float* x, const float* har, const float* wup,
                                  const float* bup, const float* wnc, const float* bnc,
                                  const float* w0, const float* w1, const float* w2,
                                  const float* b0, const float* b1, const float* b2,
                                  float* out, float* x0, int B, int C, int t_in, int T, int u, int p,
                                  int t_final, int s_src, int ksrc, int d0, int d1, int d2,
                                  void* stream) {
  if (u != 1 && u != 2 && u != 4 && u != 8) return (int)cudaErrorInvalidValue;
  Args a{x, har, wup, bup, wnc, bnc, {w0, w1, w2}, {b0, b1, b2}, out, x0,
         t_in, T, u, p, t_final, s_src, ksrc, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: return launch_tiles<8>(fused_stage_kernel<8>, a, T, B, s);
    case 16: return launch_tiles<16>(fused_stage_kernel<16>, a, T, B, s);
    case 32: return launch_tiles<32>(fused_stage_kernel<32>, a, T, B, s);
    case 64: return launch_tiles<64>(fused_stage_kernel<64>, a, T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" long long fused_stage_scratch_floats(int B, int C, int T) {
  switch (C) {
    case 8: return scratch_floats<8>(B, T);
    case 16: return scratch_floats<16>(B, T);
    case 32: return scratch_floats<32>(B, T);
    case 64: return scratch_floats<64>(B, T);
    default: return -1;
  }
}
