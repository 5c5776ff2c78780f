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
// k = 7), far above the ridge. Like the TPU kernel it keeps the six conv
// intermediates out of device memory.
//
// Design: the trio kernel (resblocks.cu) with one chain and no mean, on
// csrc/resblock_mma.cuh: each conv an implicit GEMM on the tensor cores in
// 3xTF32 with fp32 re-accumulation, the weights in fragment order
// (ops/kernels.py::mma_fragments of the one chain); K is a template
// parameter. Widths C = 8, 16, 32, 64 only: at C = 256 the two activation
// tiles alone would need more shared memory than a block has (ROADMAP.md
// lists the wide form).
//
// The bf16-operand form (fused_resblock_chain_pallas(mxu_bf16=True), its
// default there): the chain on the core's bf16 k-steps (resblock_mma.cuh),
// weights from ops/kernels.py::mma_fragments_bf16. On no path; chip_smoke.py
// holds it against its plain version.

#include "resblock_mma.cuh"

namespace {

using namespace rbmma;

struct Args {
  const float* x;  // (B, C, T)
  const float* w;  // (3, 2, K, C_in / 8, M / 16, 2, 32, 4): fragment order
  const float* b;  // (3, 2, C)
  float* out;      // (B, C, T)
  int T;
  int dil[3];
};

template <int C, int K, bool kMxu>
__global__ void __launch_bounds__(kThreads, 1) resblock_chain_kernel(Args a) {
  using G = Geometry<C>;
  extern __shared__ float sm[];
  float* h = sm;
  float* t = sm + C * G::S;
  float* s_w = sm + 2 * C * G::S;
  const int bi = blockIdx.y;
  const int g0 = blockIdx.x * G::kTile - kHalo;  // sequence index of column 0
  zero_buffers<C>(h, t);
  fill_x0<C, float, float>(h, a.x + (size_t)bi * C * a.T, nullptr, nullptr, nullptr, a.T, 0, 0,
                          0, g0, a.T);
  __syncthreads();
  run_chain<C, K, kMxu>(h, t, s_w, a.w, a.b, a.dil[0], a.dil[1], a.dil[2], g0, a.T);
  store_interior<C>(h, a.out + (size_t)bi * C * a.T, g0, a.T);
}

template <int C, bool kMxu>
int launch_c(const Args& a, int K, int B, cudaStream_t s) {
  switch (K) {
    case 3: return launch_tiles<C>(resblock_chain_kernel<C, 3, kMxu>, a, a.T, B, s);
    case 7: return launch_tiles<C>(resblock_chain_kernel<C, 7, kMxu>, a, a.T, B, s);
    case 11: return launch_tiles<C>(resblock_chain_kernel<C, 11, kMxu>, a, a.T, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C, bool kMxu>
int info_c(int K, int* out) {
  switch (K) {
    case 3: return kernel_info<C>(resblock_chain_kernel<C, 3, kMxu>, out);
    case 7: return kernel_info<C>(resblock_chain_kernel<C, 7, kMxu>, out);
    case 11: return kernel_info<C>(resblock_chain_kernel<C, 11, kMxu>, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kMxu>
int launch(const Args& a, int C, int K, int B, cudaStream_t s) {
  switch (C) {
    case 8: return launch_c<8, kMxu>(a, K, B, s);
    case 16: return launch_c<16, kMxu>(a, K, B, s);
    case 32: return launch_c<32, kMxu>(a, K, B, s);
    case 64: return launch_c<64, kMxu>(a, K, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kMxu>
int info(int C, int K, int* out) {
  switch (C) {
    case 8: return info_c<8, kMxu>(K, out);
    case 16: return info_c<16, kMxu>(K, out);
    case 32: return info_c<32, kMxu>(K, out);
    case 64: return info_c<64, kMxu>(K, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (B, C, T) fp32; w: the chain's (3, 2) convs of kernel size K in
// fragment order (K, C / 8, M / 16, 2, 32, 4), M = max(C, 16)
// (ops/kernels.py::mma_fragments); b: (3, 2, C). C in 8/16/32/64, K in
// 3/7/11.
extern "C" int resblock_chain_launch(const float* x, const float* w, const float* b,
                                     float* out, int B, int C, int T, int K, int d0,
                                     int d1, int d2, void* stream) {
  Args a{x, w, b, out, T, {d0, d1, d2}};
  return launch<false>(a, C, K, B, (cudaStream_t)stream);
}

// The bf16-operand form: w in the bf16 fragment order (K, max(C, 16) / 16,
// M / 16, 32, 8) of packed bf16 (ops/kernels.py::mma_fragments_bf16); the
// rest as resblock_chain_launch.
extern "C" int resblock_chain_mxu_bf16_launch(const float* x, const void* w, const float* b,
                                              float* out, int B, int C, int T, int K, int d0,
                                              int d1, int d2, void* stream) {
  Args a{x, static_cast<const float*>(w), b, out, T, {d0, d1, d2}};
  return launch<true>(a, C, K, B, (cudaStream_t)stream);
}

// The compiled kernel at width C and kernel size K: out[0] registers per
// thread, out[1] local-memory bytes per thread (spills), out[2] dynamic
// shared memory per block.
extern "C" int resblock_chain_info(int C, int K, int* out) { return info<false>(C, K, out); }

// As resblock_chain_info, for the bf16-operand form.
extern "C" int resblock_chain_mxu_bf16_info(int C, int K, int* out) {
  return info<true>(C, K, out);
}
