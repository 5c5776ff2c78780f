// The adjoint of the CombSubFast STFT-domain filter chain
// (combsub_spectral.cu), one frame row per block, on the radix-2 FFT core.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::_combsub_spectral_bwd_impl
// (body _combsub_spectral_bwd_kernel). With A = rfft(tooth), N = rfft(noise),
// H = exp(hm + j*pi*hp), Q = exp(nm)/128 and w_k = (1 at DC and Nyquist,
// else 2)/n:
//   dS  = w * rfft(g * window)
//   dhm = Re(dS conj(A) conj(H)),  dhp = pi * Im(dS conj(A) conj(H)),
//   dnm = Re(dS conj(N)) * Q
//   dtooth[t] = Re sum_k dS conj(H)[k] e^{+2 pi j k t / n},
//   dnoise[t] = Re sum_k dS Q[k]       e^{+2 pi j k t / n}   (k = 0 .. n/2).
//
// Bound on the H100: bytes, as the forward (per row 3n + 3(n/2+1) floats in,
// 2n + 3(n/2+1) out, for four n-point complex FFTs).
//
// Design: the TPU kernel ran this as DFT matmuls over bin blocks and summed
// dtooth/dnoise across them through its sequential grid. Here a block owns a
// whole row, so nothing is summed across blocks: one complex FFT of
// tooth + j*noise gives A and N, a second gives
// rfft(g * window), the five gradients are formed per bin, and each real
// output comes from an inverse FFT of the Hermitian extension of its half
// spectrum (interior bins halved, the DC and Nyquist imaginary parts dropped,
// as their e^{jx} is real). The two outputs are not packed into one inverse
// FFT: dnoise is ~exp(nm)/128 (~1e-3) of dtooth's scale, and the shared
// transform's rounding at dtooth's scale would swamp it. The TPU fed its
// matrix unit bf16 under model.bf16; this kernel stays fp32.

#include <cuda_runtime.h>
#include <math.h>

#include "fft_radix2.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
combsub_spectral_bwd_kernel(const float* __restrict__ g, const float* __restrict__ tooth,
                            const float* __restrict__ noise, const float* __restrict__ hm,
                            const float* __restrict__ hp, const float* __restrict__ nm,
                            const float* __restrict__ window, float* __restrict__ d_tooth,
                            float* __restrict__ d_noise, float* __restrict__ d_hm,
                            float* __restrict__ d_hp, float* __restrict__ d_nm, int n,
                            int log2n) {
  extern __shared__ float2 sm2[];
  float2* s = sm2;               // n: tooth + j*noise, transformed
  float2* gs = s + n;            // n: g * window, transformed
  float2* p = gs + n;            // n: Hermitian dA, bit-reversed, inverted
  float2* pn = p + n;            // n: Hermitian dN, bit-reversed, inverted
  float2* tw = pn + n;           // n/2 twiddles
  const int bins = n / 2 + 1;
  const size_t row = blockIdx.x;
  const float* gr = g + row * n;
  const float* a = tooth + row * n;
  const float* z = noise + row * n;
  const int shift = 32 - log2n;

  fill_twiddles(tw, n);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int j = __brev(i) >> shift;
    s[j] = make_float2(a[i], z[i]);
    gs[j] = make_float2(gr[i] * window[i], 0.f);
  }
  __syncthreads();
  fft_inplace(s, tw, n, false);
  fft_inplace(gs, tw, n, false);

  const size_t cb = row * bins;
  const float pi = 3.14159265358979f;
  for (int k = threadIdx.x; k < bins; k += kThreads) {
    const float2 zk = s[k];
    const float2 zc = s[(n - k) & (n - 1)];
    const float2 sa = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));
    const float2 sn = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float wk = ((k == 0 || k == n / 2) ? 1.0f : 2.0f) / (float)n;
    const float2 ds = make_float2(wk * gs[k].x, wk * gs[k].y);
    const float mag = expf(hm[cb + k]);
    float si, co;
    sincosf(pi * hp[cb + k], &si, &co);
    const float hr = mag * co, hi = mag * si;
    const float q = expf(nm[cb + k]) / 128.0f;
    // dH = dS conj(A); d(hm) = Re(dH conj(H)), d(hp) = pi Im(dH conj(H))
    const float dhr = ds.x * sa.x + ds.y * sa.y;
    const float dhi = -ds.x * sa.y + ds.y * sa.x;
    d_hm[cb + k] = dhr * hr + dhi * hi;
    d_hp[cb + k] = pi * (-dhr * hi + dhi * hr);
    d_nm[cb + k] = (ds.x * sn.x + ds.y * sn.y) * q;
    // dA = dS conj(H) and dN = dS Q, each extended Hermitian
    const float2 da = make_float2(ds.x * hr + ds.y * hi, -ds.x * hi + ds.y * hr);
    const float2 dn = make_float2(ds.x * q, ds.y * q);
    const int jk = __brev(k) >> shift;
    if (k == 0 || k == n / 2) {
      p[jk] = make_float2(da.x, 0.f);
      pn[jk] = make_float2(dn.x, 0.f);
    } else {
      const int jm = __brev(n - k) >> shift;
      p[jk] = make_float2(0.5f * da.x, 0.5f * da.y);
      p[jm] = make_float2(0.5f * da.x, -0.5f * da.y);
      pn[jk] = make_float2(0.5f * dn.x, 0.5f * dn.y);
      pn[jm] = make_float2(0.5f * dn.x, -0.5f * dn.y);
    }
  }
  __syncthreads();
  fft_inplace(p, tw, n, true);
  fft_inplace(pn, tw, n, true);

  float* ot = d_tooth + row * n;
  float* on = d_noise + row * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    ot[i] = p[i].x;
    on[i] = pn[i].x;
  }
}

}  // namespace

// g, tooth, noise, d_tooth, d_noise: (rows, n) fp32; hm, hp, nm, d_hm, d_hp,
// d_nm: (rows, n/2+1); window: (n,).
extern "C" int combsub_spectral_bwd_launch(const float* g, const float* tooth,
                                           const float* noise, const float* hm,
                                           const float* hp, const float* nm,
                                           const float* window, float* d_tooth,
                                           float* d_noise, float* d_hm, float* d_hp,
                                           float* d_nm, int rows, int n, void* stream) {
  const int log2n = log2_of(n);
  const size_t smem = (size_t)(4 * n + n / 2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      combsub_spectral_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  combsub_spectral_bwd_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      g, tooth, noise, hm, hp, nm, window, d_tooth, d_noise, d_hm, d_hp, d_nm, n, log2n);
  return (int)cudaGetLastError();
}
