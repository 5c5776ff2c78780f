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
// Design: the trio kernel (resblocks.cu) on csrc/resblock_mma.cuh, with
// another fill of h. As in the TPU kernel (_upconv_phase_taps), the
// transposed conv splits by phase: output column g with phase r = (g + p)
// mod u and m0 = (g + p - r) / u reads two pre-upsample columns per input
// channel, x_pre[m0] with tap r and x_pre[m0 - 1] with tap r + u. Since u
// divides the tile start, the tile's columns u j + rho (rho < u) share one
// phase, and over them the transposed conv is one GEMM, M = C, K = 2 taps x
// 2C input channels, N = W / u columns, whose B operand reads the leaky'd
// x_pre window at consecutive columns: one more implicit GEMM in 3xTF32 on
// the tensor cores (mma_k_step), with its own fragment-ordered weights
// (the convs of ops/kernels.py::stage_up_convs, laid out by mma_fragments
// in the chains' gather). Taking the columns phase by phase,
// each warp's run of n8 tiles (W / 8 columns) lies in one phase, since u
// divides 8, and reads its phase's A fragments straight from global memory
// (they differ between warps, so they are not staged). The window, C input
// channels at a time by W / u + 2 columns, is staged in t (the chains only
// need t afterwards, and conv_pass needs its pads zero, so t is zeroed
// again). The transposed conv is 3.2 % of the stage's flops; x0 is computed
// once per tile and kept for the second and third chains in a per-tile
// scratch in device memory (C x W floats a tile, 1.67x the output's bytes
// at C = 64, mostly in L2), copied back into h before each. The trio mean
// is summed in the output.
//
// The bf16-operand form (fused_stage_pallas(mxu_bf16=True), the
// Generator's fused_mxu_bf16 on an fp32 stage: the chains' weights cast at
// :1649, each conv's input at :919/:951): the chains on the core's bf16
// k-steps (mma.sync.m16n8k16, weights from
// ops/kernels.py::mma_fragments_bf16); the transposed conv, the injection,
// x0 and the carries stay fp32, as in JAX.

#include "resblock_mma.cuh"

namespace {

using namespace rbmma;

struct Args {
  const float* x;     // (B, 2C, T_in), the stage's input before the leaky
  const float* har;   // (B, T_final)
  const float* wup;   // (u, 2, 2, C / 8, M / 16, 2, 32, 4): fragment order
  const float* bup;   // (C,)
  const float* wnc;   // (C, ksrc)
  const float* bnc;   // (C,)
  const float* w[3];  // (3, 2, k_r, C / 8, M / 16, 2, 32, 4): fragment order
                      // (the bf16 form: packed bf16 words, mma_fragments_bf16)
  const float* b[3];  // (3, 2, C)
  float* out;         // (B, C, T_out)
  float* x0;          // (B, n_tiles, C, W): each tile's x0
  int t_in, T, u, p, t_final, s_src, ksrc;
  int dil[3];
};

// h = x0 on all W columns of the tile, zero outside [0, T), and the same
// into x0s (C, W). Uses all of t for the x_pre window. x: (2C, T_in) and
// har: (T_final,) of this batch row. wup: for each phase r, a conv of two
// taps (r and r + u) over each half of the input channels, in fragment
// order (half, tap, C / 8, M / 16, 2, 32, 4).
template <int C>
__device__ void fill_stage(const Args& a, const float* x, const float* har, float* h,
                           float* t, float* x0s, int g0) {
  using G = Geometry<C>;
  constexpr int kMT = G::kMTiles, kNT = G::kNTiles;
  constexpr int kSteps = 2 * G::kGroups;  // k-steps of one half: 2 taps x C / 8
  constexpr int kRows = C < 16 ? 1 : 2;   // rows of an m tile a thread holds
  const int u = a.u, lane = threadIdx.x & 31;
  const int per_phase = G::W / u;
  const int q0 = (threadIdx.x >> 5) * kNT * 8;  // the warp's first column, phase by phase
  const int rho = q0 / per_phase;  // its columns are u j + rho of the tile
  const int j0 = q0 % per_phase;   // the j of its first column
  const int nx = per_phase + 2;    // window column i holds x_pre[g0 / u - 1 + i]
  // B fragment (row lane % 4 of a k8 group, column lane / 4 of an n8 tile):
  // tap 0 reads x_pre[m0], window column j + 1 + (rho + p) / u; tap 1 the
  // column before
  const float* b_lane = t + (lane & 3) * G::S + j0 + (lane >> 2) + 1 + (rho + a.p) / u;
  const float* w_lane =
      a.wup + (size_t)((rho + a.p) % u) * 2 * conv_floats<C>(2) + lane * 4;

  Frags<C> acc, part;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  for (int half = 0; half < 2; ++half) {
    __syncthreads();  // every warp is done with the previous half's window
    for (int col = threadIdx.x; col < nx; col += kThreads) {
      const int m = g0 / u - 1 + col;
      const bool in = m >= 0 && m < a.t_in;
      const float* xm = x + (size_t)half * C * a.t_in + m;
      float v[C];  // every load in flight before the first store
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = in ? xm[(size_t)c * a.t_in] : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) t[c * G::S + col] = leaky(v[c]);
    }
    __syncthreads();
    const float* w_half = w_lane + half * conv_floats<C>(2);
    auto k_step = [&](int s, auto zero_start) {
      const int tap = s / G::kGroups, grp = s % G::kGroups;
      mma_k_step<C, false, decltype(zero_start)::value>(
          part, w_half + s * G::kStepFloats, b_lane + grp * 8 * G::S - tap);
    };
#pragma unroll 1
    for (int s0 = 0; s0 < kSteps; s0 += kChunk) {
      k_step(s0, std::true_type{});
#pragma unroll 1
      for (int s = s0 + 1; s < min(s0 + kChunk, kSteps); ++s) k_step(s, std::false_type{});
      add_frags<C>(acc, part);
    }
  }

  // + b_up + noise_conv(har) (kernel ksrc, stride s_src, padding s_src / 2),
  // tap by tap, each tap's loads of har for all this thread's columns in
  // flight at once. Output (mt, nt, 2 hf + e) is channel 16 mt + row0 + 8 hf
  // at column u (jt + 8 nt + e) + rho.
  const int row0 = frag_row0(), jt = j0 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < kRows; ++hf) {
      const int c = mt * 16 + row0 + 8 * hf;
      const float b = a.bup[c] + a.bnc[c];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[mt][nt][2 * hf + e] += b;
    }
  for (int tau = 0; tau < a.ksrc; ++tau) {
    float w[kMT][kRows], hv[kNT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < kRows; ++hf) w[mt][hf] = a.wnc[(mt * 16 + row0 + 8 * hf) * a.ksrc + tau];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hi = (g0 + u * (jt + nt * 8 + e) + rho) * a.s_src - a.s_src / 2 + tau;
        hv[nt][e] = hi >= 0 && hi < a.t_final ? har[hi] : 0.f;
      }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hf = 0; hf < kRows; ++hf)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[mt][nt][2 * hf + e] = fmaf(w[mt][hf], hv[nt][e], acc[mt][nt][2 * hf + e]);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = u * (jt + nt * 8 + e) + rho;
      const bool in = g0 + col >= 0 && g0 + col < a.T;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int hf = 0; hf < kRows; ++hf) {
          const int c = mt * 16 + row0 + 8 * hf;
          const float o = in ? acc[mt][nt][2 * hf + e] : 0.f;
          h[c * G::S + kPad + col] = o;
          x0s[c * G::W + col] = o;
        }
    }
}

template <int C, bool kMxu>
__global__ void __launch_bounds__(kThreads, 1) fused_stage_kernel(Args a) {
  using G = Geometry<C>;
  extern __shared__ float sm[];
  float* h = sm;
  float* t = sm + C * G::S;
  float* s_w = sm + 2 * C * G::S;
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * G::kTile - kHalo;  // sequence index of column 0
  float* x0s = a.x0 + ((size_t)bi * gridDim.x + blockIdx.x) * C * G::W;
  float* out = a.out + (size_t)bi * C * a.T;
  fill_stage<C>(a, a.x + (size_t)bi * 2 * C * a.t_in, a.har + (size_t)bi * a.t_final, h, t,
                x0s, g0);
  __syncthreads();  // every warp is done with the window in t
  zero_buffers<C>(h, t);
  const int d0 = a.dil[0], d1 = a.dil[1], d2 = a.dil[2];
  for (int r = 0; r < 3; ++r) {
    if (r > 0) {  // h = x0 again, all loads in flight at once
      constexpr int kRow4 = G::W / 4, kLoads = C * kRow4 / kThreads;
      static_assert(C * kRow4 % kThreads == 0, "copy split");
      __syncthreads();  // the previous chain is done with h
      float4 v[kLoads];
#pragma unroll
      for (int n = 0; n < kLoads; ++n)
        v[n] = reinterpret_cast<const float4*>(x0s)[n * kThreads + threadIdx.x];
#pragma unroll
      for (int n = 0; n < kLoads; ++n) {
        const int i = n * kThreads + threadIdx.x;
        *reinterpret_cast<float4*>(h + (i / kRow4) * G::S + kPad + 4 * (i % kRow4)) = v[n];
      }
      __syncthreads();
    }
    if (r == 0) run_chain<C, 3, kMxu>(h, t, s_w, a.w[0], a.b[0], d0, d1, d2, g0, a.T);
    else if (r == 1) run_chain<C, 7, kMxu>(h, t, s_w, a.w[1], a.b[1], d0, d1, d2, g0, a.T);
    else run_chain<C, 11, kMxu>(h, t, s_w, a.w[2], a.b[2], d0, d1, d2, g0, a.T);
    accumulate_mean<C>(h, out, r, g0, a.T);
  }
}

template <bool kMxu>
int launch(const Args& a, int B, int C, int T, cudaStream_t s) {
  switch (C) {
    case 8: return launch_tiles<8>(fused_stage_kernel<8, kMxu>, a, T, B, s);
    case 16: return launch_tiles<16>(fused_stage_kernel<16, kMxu>, a, T, B, s);
    case 32: return launch_tiles<32>(fused_stage_kernel<32, kMxu>, a, T, B, s);
    case 64: return launch_tiles<64>(fused_stage_kernel<64, kMxu>, a, T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kMxu>
int info(int C, int* out) {
  switch (C) {
    case 8: return kernel_info<8>(fused_stage_kernel<8, kMxu>, out);
    case 16: return kernel_info<16>(fused_stage_kernel<16, kMxu>, out);
    case 32: return kernel_info<32>(fused_stage_kernel<32, kMxu>, out);
    case 64: return kernel_info<64>(fused_stage_kernel<64, kMxu>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C>
long long scratch_floats(int B, int T) {
  using G = Geometry<C>;
  return (long long)B * ((T + G::kTile - 1) / G::kTile) * C * G::W;
}

}  // namespace

// x: (B, 2C, T_in) fp32; har: (B, T_final); wup: the transposed conv's
// (2C, C, 2u) weights in fragment order (u, 2, 2, C / 8, M / 16, 2, 32, 4)
// (ops/kernels.py::mma_fragments of stage_up_convs); bup: (C,); wnc: (C, ksrc); bnc:
// (C,); w_r: chain r's (3, 2) convs of kernel size k_r = 3, 7, 11 in
// fragment order (ops/kernels.py::mma_fragments); b_r: (3, 2, C); out: (B,
// C, T_out), T_out = (T_in - 1) u - 2p + 2u; x0: scratch of
// fused_stage_scratch_floats(B, C, T_out) floats. C in 8/16/32/64, u in
// 1/2/4/8 (a divisor of 8, and of every tile start).
extern "C" int fused_stage_launch(const float* x, const float* har, const float* wup,
                                  const float* bup, const float* wnc, const float* bnc,
                                  const float* w0, const float* w1, const float* w2,
                                  const float* b0, const float* b1, const float* b2,
                                  float* out, float* x0, int B, int C, int t_in, int T, int u,
                                  int p, int t_final, int s_src, int ksrc, int d0, int d1,
                                  int d2, void* stream) {
  if (u != 1 && u != 2 && u != 4 && u != 8) return (int)cudaErrorInvalidValue;
  Args a{x, har, wup, bup, wnc, bnc, {w0, w1, w2}, {b0, b1, b2}, out, x0,
         t_in, T, u, p, t_final, s_src, ksrc, {d0, d1, d2}};
  return launch<false>(a, B, C, T, (cudaStream_t)stream);
}

// The bf16-operand form: w_r in the bf16 fragment order of
// ops/kernels.py::mma_fragments_bf16 (wup stays in the tf32 one); the rest
// as fused_stage_launch.
extern "C" int fused_stage_mxu_bf16_launch(const float* x, const float* har, const float* wup,
                                           const float* bup, const float* wnc, const float* bnc,
                                           const void* w0, const void* w1, const void* w2,
                                           const float* b0, const float* b1, const float* b2,
                                           float* out, float* x0, int B, int C, int t_in, int T,
                                           int u, int p, int t_final, int s_src, int ksrc,
                                           int d0, int d1, int d2, void* stream) {
  if (u != 1 && u != 2 && u != 4 && u != 8) return (int)cudaErrorInvalidValue;
  Args a{x, har, wup, bup, wnc, bnc,
         {static_cast<const float*>(w0), static_cast<const float*>(w1),
          static_cast<const float*>(w2)},
         {b0, b1, b2}, out, x0, t_in, T, u, p, t_final, s_src, ksrc, {d0, d1, d2}};
  return launch<true>(a, B, C, T, (cudaStream_t)stream);
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

// The compiled kernel at width C: out[0] registers per thread, out[1]
// local-memory bytes per thread (spills), out[2] dynamic shared memory per
// block.
extern "C" int fused_stage_info(int C, int* out) { return info<false>(C, out); }

// As fused_stage_info, for the bf16-operand form.
extern "C" int fused_stage_mxu_bf16_info(int C, int* out) { return info<true>(C, out); }
