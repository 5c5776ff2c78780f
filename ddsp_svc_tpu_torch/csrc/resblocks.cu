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
// flops per sample (1.03 MFLOP at C = 64) on 8 C bytes of input and output.
// The TPU kernel's point was to keep the 18 conv intermediates out of HBM;
// so is this one's. Each conv runs as the TPU kernel's one
// (C_out, k C_in) @ (k C_in, W) product, here an implicit GEMM on the
// tensor cores in 3xTF32 with fp32 re-accumulation (csrc/resblock_mma.cuh,
// which says why mma.sync and not wgmma). The trio mean is summed in the
// output. Halo columns are recomputed by neighbouring tiles (W / TILE =
// 1.67 at C = 64).

#include "resblock_mma.cuh"

namespace {

using namespace rbmma;

struct Args {
  const float* x;     // (B, C, T)
  const float* har;   // (B, T_final) or nullptr
  const float* wnc;   // (C, ksrc)
  const float* bnc;   // (C,)
  const float* w[3];  // (n_dil, 2, k, C_in / 8, M / 16, 2, 32, 4): fragment order
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

  for (int r = 0; r < 3; ++r) {
    __syncthreads();  // the previous chain is done with h and t
    fill_x0<C>(h, x, har, a.wnc, a.bnc, a.T, a.t_final, a.s_src, a.ksrc, g0, limit);
    __syncthreads();
    const int d0 = a.dil[0], d1 = a.dil[1], d2 = a.dil[2];
    if (r == 0) run_chain<C, 3>(h, t, s_w, a.w[0], a.b[0], d0, d1, d2, g0, limit);
    else if (r == 1) run_chain<C, 7>(h, t, s_w, a.w[1], a.b[1], d0, d1, d2, g0, limit);
    else run_chain<C, 11>(h, t, s_w, a.w[2], a.b[2], d0, d1, d2, g0, limit);
    accumulate_mean<C>(h, a.out + (size_t)bi * C * a.T, r, g0, a.T);
  }
}

template <int C>
int info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, resblocks_kernel<C>);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)Geometry<C>::kSmem;
  return (int)err;
}

}  // namespace

// x, out: (B, C, T) fp32; har: (B, T_final) or null (no injection), with
// wnc (C, ksrc) and bnc (C,); w_r: chain r's (3, 2) convs of kernel size
// k_r = 3, 7, 11, each in fragment order (k_r, C / 8, M / 16, 2, 32, 4),
// M = max(C, 16) (ops/kernels.py::mma_fragments); b_r: (3, 2, C); valid: (B,)
// int32 sample counts or null. C in 8/16/32/64.
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

// The compiled kernel at width C: out[0] registers per thread, out[1]
// local-memory bytes per thread (spills), out[2] dynamic shared memory per
// block.
extern "C" int resblocks_info(int C, int* out) {
  switch (C) {
    case 8: return info<8>(out);
    case 16: return info<16>(out);
    case 32: return info<32>(out);
    case 64: return info<64>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

