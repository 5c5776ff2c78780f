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
// Design: csrc/resblock_conv.cuh (the tile geometry and the conv chain,
// shared with resblock_chain.cu and fused_stage.cu). A 3xTF32 tensor-core
// version measured 13% faster but 20x less accurate (9.4e-5 against the
// 1e-4 tolerance at C = 64; the tensor cores' accumulation truncates), see
// PERF.md. Staging the weights through shared memory with cp.async is
// 8-14% faster than reading them through L1, bit-identical. The trio mean
// is kept in registers. Halo columns are recomputed by neighbouring tiles
// (W / TILE = 1.67 at C = 64); skipping each conv's unneeded columns with
// branches in the FMA loop measured 2.2x slower, so that wants
// compile-time column ranges.

#include "resblock_conv.cuh"

namespace {

using namespace rbconv;

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
  zero_buffers<C>(h, t);

  float mean[kCoT][kTT];
  fill_regs(mean, 0.f);
  for (int r = 0; r < 3; ++r) {
    __syncthreads();  // the previous chain is done with h and t
    // h = x0, zero outside [0, limit)
    for (int i = threadIdx.x; i < C * G::W; i += kThreads) {
      const int c = i / G::W, col = i % G::W;
      const int g = g0 + col;
      float v = 0.f;
      if (g >= 0 && g < limit) {
        v = x[(size_t)c * a.T + g];
        if (har != nullptr)
          v += noise_conv_at(har, a.wnc + c * a.ksrc, a.bnc[c], g, a.s_src, a.ksrc, a.t_final);
      }
      h[c * G::S + kPad + col] = v;
    }
    __syncthreads();
    run_chain_k<C>(trio_k(r), h, t, s_w, a.w[r], a.b[r], a.dil[0], a.dil[1], a.dil[2], g0,
                   limit);
    add_own_h<C>(h, mean);
  }
  store_interior<C>(a.out + (size_t)bi * C * a.T, mean, 1.0f / 3.0f, g0, a.T);
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
    case 8: return launch_tiles<8>(resblocks_kernel<8>, a, T, B, s);
    case 16: return launch_tiles<16>(resblocks_kernel<16>, a, T, B, s);
    case 32: return launch_tiles<32>(resblocks_kernel<32>, a, T, B, s);
    case 64: return launch_tiles<64>(resblocks_kernel<64>, a, T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
