// The adjoint of the CombSubFast STFT-domain filter chain
// (combsub_spectral.cu), as half-length real FFTs on the power-of-two FFT
// core (fft_pow2.cuh).
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
// Bound on the H100: bytes. Per row the kernel reads 3n + 3(n/2+1) floats
// and writes 2n + 3(n/2+1), ~8n floats, for five real n-point FFTs (~12.5
// n log2 n flops): ~4 flops per byte at n = 1024, below the fp32 ridge of
// ~20.
//
// Design: the TPU kernel ran this as DFT matmuls over bin blocks and summed
// dtooth/dnoise across them through its sequential grid; here the threads
// of one row own the whole row, so nothing is summed across blocks. Each
// real transform of length n runs as an L = n/2-point complex FFT of the
// row's even and odd samples, z[i] = x[2i] + j x[2i+1], as in
// combsub_spectral.cu. The row's L/8 threads split in two groups of L/16:
// one transforms tooth, the other noise, at once (radix 16), then all of
// them g * window (radix 8, the window multiplied in the first pass's
// load); each first pass reads its row straight from device memory as
// float2. No two signals share a transform: g is ~1e-3 of tooth's scale on
// the path and noise's share of the gradients ~exp(nm)/128 of tooth's, and
// a shared transform rounds the smaller at the larger's scale (a kernel
// that transformed tooth + j noise together put up to 7e-4 of a row's max
// into dhm, dhp and dnm on rows of unequal scale, 36x the tolerance). Then
// each thread takes bin pairs (k, L-k): the real split of the three
// spectra, H and Q built in registers from the raw controls, dhm, dhp and
// dnm written straight to device memory (coalesced along k), and the two
// outputs' half spectra packed for their inverses (real_pack) in place of
// tooth's and noise's spectra. dtooth is the inverse real transform of Y =
// dA/2 inside, Re dA at DC and Nyquist (e^{jx} is real there), dA = dS
// conj(H); as w_k n/2 = 1 inside and w_k n = 1 at the edges, n Y = G
// conj(H) with G = rfft(g * window), so dtooth = irfft(G conj(H)) and
// dnoise = irfft(G Q) (their imaginary parts at DC and Nyquist dropped),
// each one L-point inverse with 1/L (a power of two: exact) on the way
// out, as the forward's. The two groups run the two inverses at once
// (radix 16), each last pass storing straight to its output row. Twiddles:
// the core's per-thread polynomial, the bin's root by sincospif; no table.
// Three groups of L/16 (g, tooth and noise at once, the third group
// running an inverse it drops to keep the block's syncs) took 0.080 ms at
// 4152 x 1024 on the H100 against this layout's 0.069, and 256-thread
// blocks 0.074 (tools/ab_torch_combsub_bwd.py measures the block sizes).
// Shared memory: three padded L-point spectra a row, the inverses reusing
// two: 13,056 bytes at n = 1024, two rows a 128-thread block; 52,224 at n
// = 4096, over the default 48 KB, set once. n is a power of two,
// 64..4096.
//
// The bf16-operand form (_combsub_spectral_bwd_impl(mxu_bf16=True), model.bf16
// training): JAX rounds g * window and the two frames to bf16 (:730, :745-
// 746) besides its DFT matrices and the excitation-gradient spectra; as in
// the forward's form, this one rounds the kernel's inputs that JAX rounds,
// g * window and the frames, on their load, and keeps the transforms and
// every spectrum fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "fft_pow2.cuh"

namespace {

constexpr int kThreads = 128;  // a block's threads, at most, where a row takes fewer

// The gradients at bin b from G = rfft(g * window)[b], A = rfft(tooth)[b]
// and N = rfft(noise)[b] (n = 2 L): dhm, dhp and dnm at b, and the bin of
// n Y for the inverses, G conj(H) (dtooth's) and G Q (dnoise's)
template <int L>
__device__ __forceinline__ void bin_grads(float2 g, float2 a, float2 nz, int b,
                                          const float* hm, const float* hp,
                                          const float* nm, float& dhm, float& dhp,
                                          float& dnm, float2& ya, float2& yn) {
  const float pi = 3.14159265358979f;
  const float mag = expf(hm[b]);
  float si, co;
  sincosf(pi * hp[b], &si, &co);
  const float2 h = make_float2(mag * co, mag * si);
  const float q = expf(nm[b]) / 128.0f;
  const float2 ds = cscale(g, ((b == 0 || b == L) ? 1.0f : 2.0f) / (2 * L));
  const float2 e = cmul(cmul(ds, conjf2(a)), conjf2(h));  // dS conj(A) conj(H)
  dhm = e.x;
  dhp = pi * e.y;
  dnm = (ds.x * nz.x + ds.y * nz.y) * q;
  ya = cmul(g, conjf2(h));
  yn = cscale(g, q);
}

// Both values of v rounded to bf16 (to nearest even) and back.
__device__ __forceinline__ float2 round_bf16(float2 v) {
  return make_float2(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)));
}

// L = n / 2 points per transform; L / 8 threads per row; kMxu: g * window
// and the frames rounded to bf16 on their load
template <int L, bool kMxu = false>
__global__ void __launch_bounds__(L / 8 > kThreads ? L / 8 : kThreads)
combsub_spectral_bwd_kernel(const float* __restrict__ g, const float* __restrict__ tooth,
                            const float* __restrict__ noise, const float* __restrict__ hm,
                            const float* __restrict__ hp, const float* __restrict__ nm,
                            const float* __restrict__ window, float* __restrict__ d_tooth,
                            float* __restrict__ d_noise, float* __restrict__ d_hm,
                            float* __restrict__ d_hp, float* __restrict__ d_nm, int rows) {
  extern __shared__ float2 smem[];
  constexpr int n = 2 * L, bins = L + 1, tpr = L / 8;  // two groups of L / 16
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  const bool live = row < rows;  // a spare slot still takes part in the syncs
  const size_t r = live ? row : 0;
  float2* sa = smem + 3 * slot * padded(L);  // tooth's spectrum, then dtooth's
  float2* sn = sa + padded(L);               // noise's, then dnoise's
  float2* sg = sn + padded(L);               // g * window's
  const int group = t / (L / 16), tl = t - group * (L / 16);
  const float2* win = reinterpret_cast<const float2*>(window);
  auto forward = [=](int which, int u, auto radix) {
    const float2* src = reinterpret_cast<const float2*>(
        (which == 0 ? tooth : which == 1 ? noise : g) + r * n);
    float2* s = sa + which * padded(L);
    fft_pow2<L, false, decltype(radix)::value>(
        s, u,
        [=](int i) {
          float2 v = src[i];
          if (which == 2) {
            const float2 wi = win[i];
            v = make_float2(v.x * wi.x, v.y * wi.y);
          }
          return kMxu ? round_bf16(v) : v;
        },
        [s](int i, float2 v) { s[pad(i)] = v; });
  };

  // forward: group 0 transforms tooth, 1 noise, then all the row's threads
  // g * window
  forward(group, tl, std::integral_constant<int, 16>{});
  forward(2, t, std::integral_constant<int, 8>{});
  __syncthreads();

  // the gradients of the controls, and the outputs' spectra packed for the
  // inverses, bin pairs (k, L - k)
  const size_t cb = r * bins;
  for (int k = t; k <= L / 2; k += tpr) {
    const int j = k == 0 ? 0 : L - k;
    const int bj = k == 0 ? L : j;  // the bin of the pair's second value
    float sn_k, cs_k;
    sincospif(2.0f * (float)k / (float)n, &sn_k, &cs_k);
    const float2 w = make_float2(cs_k, -sn_k);  // exp(-2 pi i k / n)
    float2 gk, gj, ak, aj, nk, nj;
    real_split(sg[pad(k)], sg[pad(j)], w, gk, gj);
    real_split(sa[pad(k)], sa[pad(j)], w, ak, aj);
    real_split(sn[pad(k)], sn[pad(j)], w, nk, nj);
    float dhm_k, dhp_k, dnm_k, dhm_j, dhp_j, dnm_j;
    float2 yak, ynk, yaj, ynj;
    bin_grads<L>(gk, ak, nk, k, hm + cb, hp + cb, nm + cb, dhm_k, dhp_k, dnm_k, yak, ynk);
    bin_grads<L>(gj, aj, nj, bj, hm + cb, hp + cb, nm + cb, dhm_j, dhp_j, dnm_j, yaj, ynj);
    if (live) {
      d_hm[cb + k] = dhm_k;
      d_hp[cb + k] = dhp_k;
      d_nm[cb + k] = dnm_k;
      if (k != L / 2) {
        d_hm[cb + bj] = dhm_j;
        d_hp[cb + bj] = dhp_j;
        d_nm[cb + bj] = dnm_j;
      }
    }
    if (k == 0) {  // DC and Nyquist: their e^{jx} is real
      yak.y = yaj.y = ynk.y = ynj.y = 0.f;
    }
    float2 zk, zj;
    real_pack(yak, yaj, w, zk, zj);
    sa[pad(k)] = zk;
    if (k != 0) sa[pad(j)] = zj;
    real_pack(ynk, ynj, w, zk, zj);
    sn[pad(k)] = zk;
    if (k != 0) sn[pad(j)] = zj;
  }
  __syncthreads();

  // the inverses: group 0 dtooth's, 1 dnoise's; 1/L on the way out
  float2* s = sa + group * padded(L);
  float2* o = reinterpret_cast<float2*>((group == 0 ? d_tooth : d_noise) + r * n);
  fft_pow2<L, true>(s, tl, [s](int i) { return s[pad(i)]; },
                    [=](int i, float2 v) {
                      if (live) o[i] = cscale(v, 1.0f / L);
                    });
}

template <int L>
constexpr int kRowsPerBlock = L / 8 >= kThreads ? 1 : kThreads / (L / 8);

template <int L>
constexpr size_t kSmemBytes = (size_t)kRowsPerBlock<L> * 3 * padded(L) * sizeof(float2);

template <int L, bool kMxu>
int launch(const float* g, const float* tooth, const float* noise, const float* hm,
           const float* hp, const float* nm, const float* window, float* d_tooth,
           float* d_noise, float* d_hm, float* d_hp, float* d_nm, int rows,
           cudaStream_t stream) {
  constexpr int per_block = kRowsPerBlock<L>;
  constexpr size_t smem = kSmemBytes<L>;
  if constexpr (smem > 48 * 1024) {  // n = 4096: over the default, set once
    static const cudaError_t attr = cudaFuncSetAttribute(
        combsub_spectral_bwd_kernel<L, kMxu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const int blocks = (rows + per_block - 1) / per_block;
  combsub_spectral_bwd_kernel<L, kMxu><<<blocks, per_block * L / 8, smem, stream>>>(
      g, tooth, noise, hm, hp, nm, window, d_tooth, d_noise, d_hm, d_hp, d_nm, rows);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, L>) for the L of l in 32..2048
template <int L, class F>
int with_l(int l, F f) {
  if (l == L) return f(std::integral_constant<int, L>{});
  if constexpr (L < 2048) return with_l<2 * L>(l, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// g, tooth, noise, d_tooth, d_noise: (rows, n) fp32; hm, hp, nm, d_hm, d_hp,
// d_nm: (rows, n/2+1); window: (n,); n a power of two in [64, 4096].
extern "C" int combsub_spectral_bwd_launch(const float* g, const float* tooth,
                                           const float* noise, const float* hm,
                                           const float* hp, const float* nm,
                                           const float* window, float* d_tooth,
                                           float* d_noise, float* d_hm, float* d_hp,
                                           float* d_nm, int rows, int n, void* stream) {
  if (rows == 0) return 0;
  return with_l<32>(n / 2, [&](auto l) {
    return launch<decltype(l)::value, false>(g, tooth, noise, hm, hp, nm, window, d_tooth,
                                             d_noise, d_hm, d_hp, d_nm, rows,
                                             (cudaStream_t)stream);
  });
}

// The bf16-operand form: g * window and the frames rounded to bf16 on their
// load; the arguments as combsub_spectral_bwd_launch.
extern "C" int combsub_spectral_bwd_mxu_bf16_launch(
    const float* g, const float* tooth, const float* noise, const float* hm, const float* hp,
    const float* nm, const float* window, float* d_tooth, float* d_noise, float* d_hm,
    float* d_hp, float* d_nm, int rows, int n, void* stream) {
  if (rows == 0) return 0;
  return with_l<32>(n / 2, [&](auto l) {
    return launch<decltype(l)::value, true>(g, tooth, noise, hm, hp, nm, window, d_tooth,
                                            d_noise, d_hm, d_hp, d_nm, rows,
                                            (cudaStream_t)stream);
  });
}

// The compiled kernel at n on the current card: out[0] registers per
// thread, out[1] local-memory (spilled) bytes per thread, out[2] dynamic
// shared bytes per block.
extern "C" int combsub_spectral_bwd_info(int n, int* out) {
  return with_l<32>(n / 2, [&](auto l) {
    constexpr int L = decltype(l)::value;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, combsub_spectral_bwd_kernel<L>);
    if (err != cudaSuccess) return (int)err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = (int)kSmemBytes<L>;
    return 0;
  });
}
