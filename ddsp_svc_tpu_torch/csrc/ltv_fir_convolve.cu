// The framed linear convolution of frequency_filter (the LTV-FIR filters of
// the Sins and CombSub synthesizers), one frame row per block.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::ltv_fir_convolve_pallas
// (_ltv_conv_fwd_impl, body _ltv_conv_kernel).
//
//   out[r] = irfft(rfft(a[r], n) * rfft(h[r], n), n)
//
// for a Bartlett-windowed audio frame a[r] (frame samples) and its impulse
// response h[r] (ir samples), n >= frame + ir - 1 a power of two, so the
// result is their linear convolution (n samples, the tail zero).
//
// Bound on the H100: bytes. Per row it reads frame + ir floats and writes n
// (~14 KB at frame 1024, ir 1022, n 2048) for three n-point complex FFTs
// (~15 n log2 n flops, ~2 flops per byte), below the fp32 ridge of ~20.
//
// Design: the TPU kernel ran the three transforms as DFT matmuls against
// shared cos/sin blocks on its matrix unit, summing the inverse over bin
// blocks in its sequential grid. Here a block owns a whole row, so nothing
// is summed across blocks: a and h are zero-padded to n and each goes
// through its own complex radix-2 FFT in shared memory (fft_radix2.cuh). They
// are not packed into one complex FFT: h's scale is far from the audio's,
// and a shared transform rounds the smaller at the larger's scale (packing
// the combsub adjoint's two outputs so cost 8x its tolerance on the smaller
// one; combsub_spectral.cu). The product of the half spectra
// is extended to a Hermitian spectrum with the imaginary parts of the DC
// and Nyquist bins dropped (irfft semantics) and inverted by a third FFT.
// Shared memory: 2.5 n complex values, 40 KB at n = 2048.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_radix2.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ltv_fir_convolve_kernel(const float* __restrict__ a, const float* __restrict__ h,
                        float* __restrict__ out, int frame, int ir, int n, int log2n) {
  extern __shared__ float2 sm2[];
  float2* sa = sm2;        // n: a, transformed; then the inverse transform
  float2* sh = sa + n;     // n: h, transformed; then the product, bins 0..n/2
  float2* tw = sh + n;     // n/2 twiddles
  const size_t row = blockIdx.x;
  const float* ar = a + row * frame;
  const float* hr = h + row * ir;
  const int shift = 32 - log2n;

  fill_twiddles(tw, n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = __brev(i) >> shift;
    sa[j] = make_float2(i < frame ? ar[i] : 0.f, 0.f);
    sh[j] = make_float2(i < ir ? hr[i] : 0.f, 0.f);
  }
  __syncthreads();
  fft_inplace(sa, tw, n, false);
  fft_inplace(sh, tw, n, false);

  for (int k = threadIdx.x; k <= n / 2; k += kThreads) {
    sh[k] = cmul(sa[k], sh[k]);
  }
  __syncthreads();
  for (int m = threadIdx.x; m < n; m += kThreads) {
    float2 x;
    if (m == 0 || m == n / 2) {
      x = make_float2(sh[m].x, 0.f);
    } else if (m < n / 2) {
      x = sh[m];
    } else {
      x = make_float2(sh[n - m].x, -sh[n - m].y);
    }
    sa[__brev(m) >> shift] = x;
  }
  __syncthreads();
  fft_inplace(sa, tw, n, true);

  const float inv_n = 1.0f / (float)n;
  float* o = out + row * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    o[i] = sa[i].x * inv_n;
  }
}

}  // namespace

// a: (rows, frame) fp32; h: (rows, ir); out: (rows, n).
extern "C" int ltv_fir_convolve_launch(const float* a, const float* h, float* out,
                                       int rows, int frame, int ir, int n,
                                       void* stream) {
  if (rows == 0) return 0;
  const int log2n = log2_of(n);
  const size_t smem = (size_t)(2 * n + n / 2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      ltv_fir_convolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ltv_fir_convolve_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      a, h, out, frame, ir, n, log2n);
  return (int)cudaGetLastError();
}
