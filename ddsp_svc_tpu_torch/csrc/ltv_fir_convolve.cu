// The framed linear convolution of frequency_filter (the LTV-FIR filters of
// the Sins and CombSub synthesizers), as half-length real FFTs.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::ltv_fir_convolve_pallas
// (_ltv_conv_fwd_impl, body _ltv_conv_kernel).
//
//   out[r] = irfft(rfft(a[r], n) * rfft(h[r], n), n)
//
// for a Bartlett-windowed audio frame a[r] (frame samples) and its impulse
// response h[r] (ir samples), n >= frame + ir - 1 a power of two, so the
// result is their linear convolution (n samples, the tail zero). The
// imaginary parts of the DC and Nyquist bins of the product are zero by
// construction (irfft drops them).
//
// Bound on the H100: bytes. Per row it reads frame + ir floats and writes n
// (~16 KB at frame 1024, ir 1022, n 2048) for three real n-point FFTs
// (~7.5 n log2 n flops, ~10 flops per byte), below the fp32 ridge of ~20.
//
// Design: each real transform of length n runs as an l = n/2-point complex
// FFT (fft_pow2.cuh) of the row's even and odd samples, z[i] = x[2i] +
// j x[2i+1]. The block's threads for a row split in two groups of l/16:
// one transforms a, the other h, at once (radix 16, three passes at l =
// 1024), each reading its row straight from device memory in the first
// pass and loading nothing for the zero padding past frame and ir (half of
// each transform's input at n = 2048). a and h stay in separate transforms:
// h's scale is far from the audio's, and a shared transform rounds the
// smaller at the larger's scale (packing the combsub adjoint's two outputs
// so cost 8x its tolerance on the smaller one; combsub_spectral.cu). Then
// each thread takes bin pairs (k, l-k): the real split of both spectra,
// their product P, and the inverse's packing Z'[k] = Pe[k] + j Po[k] (the
// spectra of the even and odd output samples) in place of a's spectrum.
// All the row's threads run the inverse l-point FFT (radix 8) and its last
// pass writes out[2i], out[2i+1] = z'[i] / l to device memory. Shared
// memory: two padded l-point spectra, 17 KB per row at n = 2048, two rows
// per 256-thread block.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_pow2.cuh"

namespace {

constexpr int kThreads = 256;

// L = n / 2 points per transform; L / 8 threads per row
template <int L>
__global__ void __launch_bounds__(L / 8 > kThreads ? L / 8 : kThreads)
ltv_fir_convolve_kernel(const float* __restrict__ a, const float* __restrict__ h,
                        float* __restrict__ out, int rows, int frame, int ir) {
  extern __shared__ float2 smem[];
  constexpr int n = 2 * L, tpr = L / 8;  // threads per row: two groups of L / 16
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  const bool live = row < rows;  // a spare slot still takes part in the syncs
  const size_t r = live ? row : 0;
  float2* sa = smem + 2 * slot * padded(L);
  float2* sh = sa + padded(L);

  // forward: group 0 transforms a, group 1 h
  const int group = t / (L / 16);
  const float* src = group ? h + r * ir : a + r * frame;
  const int len = group ? ir : frame;
  float2* s = group ? sh : sa;
  fft_pow2<L, false>(
      s, t - group * (L / 16),
      [=](int i) {
        return make_float2(2 * i < len ? src[2 * i] : 0.f,
                           2 * i + 1 < len ? src[2 * i + 1] : 0.f);
      },
      [s](int i, float2 v) { s[pad(i)] = v; });
  __syncthreads();

  // the spectra's product, packed for the inverse, bin pairs (k, L - k)
  for (int k = t; k <= L / 2; k += tpr) {
    const int j = k == 0 ? 0 : L - k;
    float sn, cs;
    sincospif(2.0f * (float)k / (float)n, &sn, &cs);
    const float2 w = make_float2(cs, -sn);  // exp(-2 pi i k / n)
    float2 ak, aj, hk, hj;
    real_split(sa[pad(k)], sa[pad(j)], w, ak, aj);
    real_split(sh[pad(k)], sh[pad(j)], w, hk, hj);
    const float2 pk = cmul(ak, hk), pj = cmul(aj, hj);  // P[k], P[L - k]
    float2 zk, zj;
    real_pack(pk, pj, w, zk, zj);
    sa[pad(k)] = zk;
    if (k != 0) sa[pad(j)] = zj;
  }
  __syncthreads();

  // the inverse on all the row's threads: L / 8 of them, radix 8
  float2* o = reinterpret_cast<float2*>(out + (size_t)row * n);
  fft_pow2<L, true, 8>(sa, t, [sa](int i) { return sa[pad(i)]; },
                       [=](int i, float2 v) {
                         if (live) o[i] = cscale(v, 1.0f / L);
                       });
}

template <int L>
int launch(const float* a, const float* h, float* out, int rows, int frame,
           int ir, cudaStream_t stream) {
  constexpr int tpr = L / 8;
  constexpr int per_block = tpr >= kThreads ? 1 : kThreads / tpr;
  constexpr size_t smem = (size_t)per_block * 2 * padded(L) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      ltv_fir_convolve_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + per_block - 1) / per_block;
  ltv_fir_convolve_kernel<L><<<blocks, per_block * tpr, smem, stream>>>(
      a, h, out, rows, frame, ir);
  return (int)cudaGetLastError();
}

template <int L>
int launch_l(int l, const float* a, const float* h, float* out, int rows,
             int frame, int ir, cudaStream_t stream) {
  if (l == L) return launch<L>(a, h, out, rows, frame, ir, stream);
  if constexpr (L < 2048) return launch_l<2 * L>(l, a, h, out, rows, frame, ir, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a: (rows, frame) fp32; h: (rows, ir); out: (rows, n), n a power of two in
// [64, 4096] (ops/kernels.py::LTV_MAX_N) and >= frame + ir - 1.
extern "C" int ltv_fir_convolve_launch(const float* a, const float* h, float* out,
                                       int rows, int frame, int ir, int n,
                                       void* stream) {
  if (rows == 0) return 0;
  return launch_l<32>(n / 2, a, h, out, rows, frame, ir, (cudaStream_t)stream);
}
