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
//
// The bf16-input form (JAX runs the same kernel on a bf16 stage: x, and in
// the full-bf16 Generator har, are bf16; both are upcast at the kernel's
// input and the output is rounded once to bf16, _fused_resblocks_fwd_impl
// :1186/:1200/:1294). Here the fill reads bf16 and converts exactly into
// the fp32 tile; the tile, the 3xTF32 core and the fp32 weights are the fp32
// form's. The trio mean cannot be summed in a bf16 output without rounding
// its partial sums, so chains 0 and 1 sum into an fp32 scratch (B, C, T)
// and chain 2 writes (sum + h) / 3 rounded to nearest even.
//
// The bf16-operand form (fused_resblocks_inject_pallas(mxu_bf16=True), the
// Generator's fused_mxu_bf16: the weights cast to bf16 at :1233, each
// conv's input at :919/:951, fp32 accumulation, h, the residual carries,
// the injection conv and the biases fp32): the same kernel with the chains
// on the core's bf16 k-steps (resblock_mma.cuh, mma.sync.m16n8k16), one MMA
// per tap and 16 input channels in place of six tf32 ones, on either input
// type (JAX passes fused_mxu_bf16 to bf16 stages too). Its weights are
// ops/kernels.py::mma_fragments_bf16's. Bound as above, at the bf16
// tensor-core rate (989 TFLOP/s, twice TF32's; the 3xTF32 form issues
// three TF32 products per fp32 one).

#include "resblock_mma.cuh"

namespace {

using namespace rbmma;

struct Args {
  const void* x;      // (B, C, T) of XT
  const void* har;    // (B, T_final) of HT, or nullptr
  const float* wnc;   // (C, ksrc)
  const float* bnc;   // (C,)
  const float* w[3];  // (n_dil, 2, k, C_in / 8, M / 16, 2, 32, 4): fragment order
                      // (the bf16 form: packed bf16 words, mma_fragments_bf16)
  const float* b[3];  // (n_dil, 2, C)
  const int* valid;   // (B,) or nullptr
  float* acc;         // (B, C, T) fp32: the trio mean's partial sums (the output for fp32)
  void* out;          // (B, C, T) of XT
  int T, t_final, s_src, ksrc;
  int dil[3];
};

// The trio mean after chain `chain`: in the output itself for fp32; for a
// bf16 output, chains 0 and 1 in the fp32 scratch and chain 2 rounded into
// the output (the same entries of both, row for row).
template <int C, typename XT>
__device__ __forceinline__ void trio_mean(const float* h, float* acc, XT* out, int chain,
                                          int g0, int T) {
  if constexpr (std::is_same<XT, float>::value) {
    accumulate_mean<C>(h, out, chain, g0, T);
  } else {
    for_own_interior<C>(h, acc, g0, T, [chain, acc, out](float* o, float v) {
      if (chain < 2) *o = chain == 0 ? v : *o + v;
      else out[o - acc] = __float2bfloat16_rn((*o + v) * (1.0f / 3.0f));
    });
  }
}

template <int C, typename XT, typename HT, bool kMxu>
__global__ void __launch_bounds__(kThreads, 1) resblocks_kernel(Args a) {
  using G = Geometry<C>;
  extern __shared__ float sm[];
  float* h = sm;
  float* t = sm + C * G::S;
  float* s_w = sm + 2 * C * G::S;
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * G::kTile - kHalo;  // sequence index of column 0
  const int limit = a.valid != nullptr ? min(a.valid[bi], a.T) : a.T;
  const size_t row = (size_t)bi * C * a.T;
  const XT* x = static_cast<const XT*>(a.x) + row;
  const HT* har = a.har != nullptr ? static_cast<const HT*>(a.har) + (size_t)bi * a.t_final
                                   : nullptr;
  zero_buffers<C>(h, t);

  for (int r = 0; r < 3; ++r) {
    __syncthreads();  // the previous chain is done with h and t
    fill_x0<C, XT, HT>(h, x, har, a.wnc, a.bnc, a.T, a.t_final, a.s_src, a.ksrc, g0, limit);
    __syncthreads();
    const int d0 = a.dil[0], d1 = a.dil[1], d2 = a.dil[2];
    if (r == 0) run_chain<C, 3, kMxu>(h, t, s_w, a.w[0], a.b[0], d0, d1, d2, g0, limit);
    else if (r == 1) run_chain<C, 7, kMxu>(h, t, s_w, a.w[1], a.b[1], d0, d1, d2, g0, limit);
    else run_chain<C, 11, kMxu>(h, t, s_w, a.w[2], a.b[2], d0, d1, d2, g0, limit);
    trio_mean<C, XT>(h, a.acc + row, static_cast<XT*>(a.out) + row, r, g0, a.T);
  }
}

template <typename XT, typename HT, bool kMxu = false>
int launch(const Args& a, int B, int C, cudaStream_t s) {
  switch (C) {
    case 8: return launch_tiles<8>(resblocks_kernel<8, XT, HT, kMxu>, a, a.T, B, s);
    case 16: return launch_tiles<16>(resblocks_kernel<16, XT, HT, kMxu>, a, a.T, B, s);
    case 32: return launch_tiles<32>(resblocks_kernel<32, XT, HT, kMxu>, a, a.T, B, s);
    case 64: return launch_tiles<64>(resblocks_kernel<64, XT, HT, kMxu>, a, a.T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename XT, typename HT, bool kMxu = false>
int info(int C, int* out) {
  switch (C) {
    case 8: return kernel_info<8>(resblocks_kernel<8, XT, HT, kMxu>, out);
    case 16: return kernel_info<16>(resblocks_kernel<16, XT, HT, kMxu>, out);
    case 32: return kernel_info<32>(resblocks_kernel<32, XT, HT, kMxu>, out);
    case 64: return kernel_info<64>(resblocks_kernel<64, XT, HT, kMxu>, out);
    default: return (int)cudaErrorInvalidValue;
  }
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
  Args a{x, har, wnc, bnc, {w0, w1, w2}, {b0, b1, b2}, valid, out, out,
         T, t_final, s_src, ksrc, {d0, d1, d2}};
  return launch<float, float>(a, B, C, (cudaStream_t)stream);
}

// The bf16-input form: x, out (B, C, T) bf16; har (B, T_final) bf16 when
// har_bf16, else fp32, or null; acc (B, C, T) fp32 scratch; the rest as
// resblocks_launch.
extern "C" int resblocks_bf16_launch(const void* x, const void* har, int har_bf16,
                                     const float* wnc, const float* bnc, const float* w0,
                                     const float* w1, const float* w2, const float* b0,
                                     const float* b1, const float* b2, const int* valid,
                                     float* acc, void* out, int B, int C, int T,
                                     int t_final, int s_src, int ksrc, int d0, int d1,
                                     int d2, void* stream) {
  Args a{x, har, wnc, bnc, {w0, w1, w2}, {b0, b1, b2}, valid, acc, out,
         T, t_final, s_src, ksrc, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  return har_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, B, C, s)
                  : launch<__nv_bfloat16, float>(a, B, C, s);
}

// The compiled kernel at width C: out[0] registers per thread, out[1]
// local-memory bytes per thread (spills), out[2] dynamic shared memory per
// block.
extern "C" int resblocks_info(int C, int* out) { return info<float, float>(C, out); }

// As resblocks_info, for the bf16-input form (har bf16 when har_bf16).
extern "C" int resblocks_bf16_info(int C, int har_bf16, int* out) {
  return har_bf16 ? info<__nv_bfloat16, __nv_bfloat16>(C, out)
                  : info<__nv_bfloat16, float>(C, out);
}

// The bf16-operand form: x, out (B, C, T) fp32, or bf16 when x_bf16 (then
// har bf16 when har_bf16, else fp32, and acc (B, C, T) fp32 scratch; for
// fp32 x acc may be null); w_r: chain r's convs in the bf16 fragment order
// (k_r, max(C, 16) / 16, M / 16, 32, 8) of packed bf16
// (ops/kernels.py::mma_fragments_bf16); the rest as resblocks_launch.
extern "C" int resblocks_mxu_bf16_launch(const void* x, int x_bf16, const void* har,
                                         int har_bf16, const float* wnc, const float* bnc,
                                         const void* w0, const void* w1, const void* w2,
                                         const float* b0, const float* b1, const float* b2,
                                         const int* valid, float* acc, void* out, int B, int C,
                                         int T, int t_final, int s_src, int ksrc, int d0,
                                         int d1, int d2, void* stream) {
  const float* w[3] = {static_cast<const float*>(w0), static_cast<const float*>(w1),
                       static_cast<const float*>(w2)};
  Args a{x, har, wnc, bnc, {w[0], w[1], w[2]}, {b0, b1, b2}, valid,
         x_bf16 ? acc : static_cast<float*>(out), out, T, t_final, s_src, ksrc, {d0, d1, d2}};
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16) return launch<float, float, true>(a, B, C, s);
  return har_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, true>(a, B, C, s)
                  : launch<__nv_bfloat16, float, true>(a, B, C, s);
}

// As resblocks_info, for the bf16-operand form on fp32 or bf16 x.
extern "C" int resblocks_mxu_bf16_info(int C, int x_bf16, int har_bf16, int* out) {
  if (!x_bf16) return info<float, float, true>(C, out);
  return har_bf16 ? info<__nv_bfloat16, __nv_bfloat16, true>(C, out)
                  : info<__nv_bfloat16, float, true>(C, out);
}
