// The CombSubFast STFT-domain filter chain, forward, as half-length real FFTs
// on the power-of-two FFT core (fft_pow2.cuh).
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::combsub_spectral_pallas,
// forward (body _combsub_spectral_kernel).
//
//   out[r] = irfft(rfft(tooth[r]) * exp(hm[r] + j*pi*hp[r])
//                  + rfft(noise[r]) * exp(nm[r]) / 128, n) * window
//
// Bound on the H100: bytes. Per row the kernel reads 2n + 3(n/2+1) floats
// and writes n, ~7n floats, for three real n-point FFTs (~7.5 n log2 n
// flops): ~3 flops per byte at n = 1024, below the fp32 ridge of ~20.
//
// Design: the TPU kernel computed the transforms as DFT matmuls for its
// matrix unit; here each real transform of length n runs as an L = n/2-point
// complex FFT of the row's even and odd samples, z[i] = x[2i] + j x[2i+1],
// as ltv_fir_convolve.cu does. The row's threads split in two groups of
// L/16: one transforms tooth, the other noise, at once (radix 16, each
// reading its row straight from device memory in the first pass). tooth and
// noise stay in separate transforms: noise's filtered share is ~exp(nm)/128
// of tooth's, and a shared transform rounds the smaller at the larger's
// scale. Then each thread takes bin pairs (k, L-k): the real split of both
// spectra, the filter of each bin built in registers from the raw controls,
// S = A e^{hm + j pi hp} + N e^{nm}/128 (the imaginary parts of the DC and
// Nyquist bins dropped, irfft semantics), and the inverse's packing Z'[k] =
// Se[k] + j So[k] (the spectra of the even and odd output samples) in place
// of tooth's spectrum. All the row's threads run the inverse L-point FFT
// (radix 8) and its last pass writes out[2i], out[2i+1] = z'[i] / L times
// the window straight to device memory. Shared memory: two padded L-point
// spectra, 8.5 KB per row at n = 1024, four rows per 256-thread block. n is a
// power of two, 64..4096.
//
// The bf16-operand form (combsub_spectral_pallas(mxu_bf16=True), the
// CombSubFast of model.bf16): JAX rounds the windowed tooth and noise
// frames (:595-596), its DFT matrices (:653-658) and the filtered spectrum
// before its inverse (:616-617) to bf16 for its matrix unit. An FFT has no
// DFT matrices, so this form rounds the kernel's inputs that JAX rounds:
// each frame value to bf16 (to nearest even) as the first pass reads it.
// The transforms, the filter and every spectrum stay fp32 (rounding the
// spectrum too brings the result no nearer to JAX's, whose rounded DFT
// matrices dominate the difference).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fft_pow2.cuh"

namespace {

constexpr int kThreads = 256;

// A e^{hm + j pi hp} + N e^{nm} / 128 at one bin
__device__ __forceinline__ float2 filtered(float2 a, float2 nz, float hm, float hp,
                                           float nm) {
  const float mag = expf(hm);
  float si, co;
  sincosf(3.14159265358979f * hp, &si, &co);
  const float2 h = cmul(a, make_float2(mag * co, mag * si));
  const float q = expf(nm) / 128.0f;
  return make_float2(h.x + nz.x * q, h.y + nz.y * q);
}

// Both values of v rounded to bf16 (to nearest even) and back.
__device__ __forceinline__ float2 round_bf16(float2 v) {
  return make_float2(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)));
}

// L = n / 2 points per transform; L / 8 threads per row; kMxu: the frames
// rounded to bf16 on their load
template <int L, bool kMxu>
__global__ void __launch_bounds__(L / 8 > kThreads ? L / 8 : kThreads)
combsub_spectral_kernel(const float* __restrict__ tooth, const float* __restrict__ noise,
                        const float* __restrict__ hm, const float* __restrict__ hp,
                        const float* __restrict__ nm, const float* __restrict__ window,
                        float* __restrict__ out, int rows) {
  extern __shared__ float2 smem[];
  constexpr int n = 2 * L, bins = L + 1, tpr = L / 8;  // two groups of L / 16
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  const bool live = row < rows;  // a spare slot still takes part in the syncs
  const size_t r = live ? row : 0;
  float2* sa = smem + 2 * slot * padded(L);
  float2* sn = sa + padded(L);

  // forward: group 0 transforms tooth, group 1 noise
  const int group = t / (L / 16);
  const float2* src = reinterpret_cast<const float2*>((group ? noise : tooth) + r * n);
  float2* s = group ? sn : sa;
  fft_pow2<L, false>(
      s, t - group * (L / 16), [=](int i) { return kMxu ? round_bf16(src[i]) : src[i]; },
      [s](int i, float2 v) { s[pad(i)] = v; });
  __syncthreads();

  // the filtered spectrum, packed for the inverse, bin pairs (k, L - k)
  const float* hmr = hm + r * bins;
  const float* hpr = hp + r * bins;
  const float* nmr = nm + r * bins;
  for (int k = t; k <= L / 2; k += tpr) {
    const int j = k == 0 ? 0 : L - k;
    const int bj = k == 0 ? L : j;  // the bin of the pair's second value
    float sn_k, cs_k;
    sincospif(2.0f * (float)k / (float)n, &sn_k, &cs_k);
    const float2 w = make_float2(cs_k, -sn_k);  // exp(-2 pi i k / n)
    float2 ak, aj, nk, nj;
    real_split(sa[pad(k)], sa[pad(j)], w, ak, aj);
    real_split(sn[pad(k)], sn[pad(j)], w, nk, nj);
    float2 pk = filtered(ak, nk, hmr[k], hpr[k], nmr[k]);   // S[k]
    float2 pj = filtered(aj, nj, hmr[bj], hpr[bj], nmr[bj]);  // S[L - k]
    if (k == 0) {  // DC and Nyquist: irfft reads their real parts only
      pk.y = 0.f;
      pj.y = 0.f;
    }
    float2 zk, zj;
    real_pack(pk, pj, w, zk, zj);
    sa[pad(k)] = zk;
    if (k != 0) sa[pad(j)] = zj;
  }
  __syncthreads();

  // the inverse on all the row's threads: L / 8 of them, radix 8; 1/L (a
  // power of two, exact) and the window on the way out
  float2* o = reinterpret_cast<float2*>(out + r * n);
  const float2* win = reinterpret_cast<const float2*>(window);
  fft_pow2<L, true, 8>(sa, t, [sa](int i) { return sa[pad(i)]; },
                       [=](int i, float2 v) {
                         if (live) {
                           const float2 wi = win[i];
                           o[i] = make_float2(v.x * (1.0f / L) * wi.x,
                                              v.y * (1.0f / L) * wi.y);
                         }
                       });
}

template <int L, bool kMxu>
int launch(const float* tooth, const float* noise, const float* hm, const float* hp,
           const float* nm, const float* window, float* out, int rows,
           cudaStream_t stream) {
  constexpr int tpr = L / 8;
  constexpr int per_block = tpr >= kThreads ? 1 : kThreads / tpr;
  // at most 34,816 bytes (L = 512..2048): under the default 48 KB
  constexpr size_t smem = (size_t)per_block * 2 * padded(L) * sizeof(float2);
  const int blocks = (rows + per_block - 1) / per_block;
  combsub_spectral_kernel<L, kMxu><<<blocks, per_block * tpr, smem, stream>>>(
      tooth, noise, hm, hp, nm, window, out, rows);
  return (int)cudaGetLastError();
}

template <int L, bool kMxu>
int launch_l(int l, const float* tooth, const float* noise, const float* hm,
             const float* hp, const float* nm, const float* window, float* out,
             int rows, cudaStream_t stream) {
  if (l == L) return launch<L, kMxu>(tooth, noise, hm, hp, nm, window, out, rows, stream);
  if constexpr (L < 2048) {
    return launch_l<2 * L, kMxu>(l, tooth, noise, hm, hp, nm, window, out, rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// tooth, noise, out: (rows, n) fp32; hm, hp, nm: (rows, n/2+1); window: (n,);
// n a power of two in [64, 4096].
extern "C" int combsub_spectral_launch(const float* tooth, const float* noise,
                                       const float* hm, const float* hp,
                                       const float* nm, const float* window,
                                       float* out, int rows, int n, void* stream) {
  if (rows == 0) return 0;
  return launch_l<32, false>(n / 2, tooth, noise, hm, hp, nm, window, out, rows,
                             (cudaStream_t)stream);
}

// The bf16-operand form: the frames rounded to bf16 on their load; the
// arguments as combsub_spectral_launch.
extern "C" int combsub_spectral_mxu_bf16_launch(const float* tooth, const float* noise,
                                                const float* hm, const float* hp,
                                                const float* nm, const float* window,
                                                float* out, int rows, int n, void* stream) {
  if (rows == 0) return 0;
  return launch_l<32, true>(n / 2, tooth, noise, hm, hp, nm, window, out, rows,
                            (cudaStream_t)stream);
}
