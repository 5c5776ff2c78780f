// One ResBlock1 chain of a narrow NSF-HiFiGAN stage, without the trio mean.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::fused_resblock_chain_pallas
// (impl _fused_resblocks_fwd_impl with one kernel size).
//
//   out = chain_k(x): for d in dilations: x += conv_k(leaky(conv_k,d(leaky(x))))
//   every conv zero-pads at the sequence end.
//
// Bound on the H100: operations. The chain does 2 C^2 * 6 * k flops per
// sample on 8 C bytes of input and output (0.34 MFLOP per sample at C = 64,
// k = 7): fp32 CUDA-core work far above the ridge. Like the TPU kernel it
// keeps the six conv intermediates out of device memory.
//
// Design: csrc/resblock_conv.cuh, the trio kernel's tile and conv chain
// with one chain per tile and no mean; K is a template parameter. Widths C
// = 8, 16, 32, 64 only: at C = 256 the two activation tiles alone would need
// more shared memory than a block has (ROADMAP.md lists the wide form).

#include "resblock_conv.cuh"

namespace {

using namespace rbconv;

struct Args {
  const float* x;  // (B, C, T)
  const float* w;  // (3, 2, C_in, K, C_out)
  const float* b;  // (3, 2, C)
  float* out;      // (B, C, T)
  int T;
  int dil[3];
};

template <int C, int K>
__global__ void __launch_bounds__(kThreads, 1) resblock_chain_kernel(Args a) {
  using G = Geometry<C>;
  extern __shared__ float sm[];
  float* h = sm;
  float* t = sm + C * G::S;
  float* s_w = sm + 2 * C * G::S;
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * G::kTile - kHalo;  // sequence index of column 0
  const float* x = a.x + (size_t)bi * C * a.T;
  zero_buffers<C>(h, t);
  for (int i = threadIdx.x; i < C * G::W; i += kThreads) {
    const int c = i / G::W, col = i % G::W;
    const int g = g0 + col;
    h[c * G::S + kPad + col] = (g >= 0 && g < a.T) ? x[(size_t)c * a.T + g] : 0.f;
  }
  __syncthreads();
  run_chain<C, K>(h, t, s_w, a.w, a.b, a.dil[0], a.dil[1], a.dil[2], g0, a.T);
  float v[kCoT][kTT];
  fill_regs(v, 0.f);
  add_own_h<C>(h, v);
  store_interior<C>(a.out + (size_t)bi * C * a.T, v, 1.0f, g0, a.T);
}

template <int C>
int launch_c(const Args& a, int K, int B, cudaStream_t s) {
  switch (K) {
    case 3: return launch_tiles<C>(resblock_chain_kernel<C, 3>, a, a.T, B, s);
    case 7: return launch_tiles<C>(resblock_chain_kernel<C, 7>, a, a.T, B, s);
    case 11: return launch_tiles<C>(resblock_chain_kernel<C, 11>, a, a.T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, T) fp32; w: (3, 2, C, K, C) (dilation, conv, C_in, tap,
// C_out); b: (3, 2, C). C in 8/16/32/64, K in 3/7/11.
extern "C" int resblock_chain_launch(const float* x, const float* w, const float* b,
                                     float* out, int B, int C, int T, int K, int d0,
                                     int d1, int d2, void* stream) {
  Args a{x, w, b, out, T, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: return launch_c<8>(a, K, B, s);
    case 16: return launch_c<16>(a, K, B, s);
    case 32: return launch_c<32>(a, K, B, s);
    case 64: return launch_c<64>(a, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
