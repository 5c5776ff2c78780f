// The Sins synthesizer's additive oscillator bank.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::oscillator_bank_pallas
// (body _osc_kernel).
//
//   out[r, j] = sum_k (a0[k] + (a1[k] - a0[k]) * j / block)
//                     * sin(wrap((k + 1) * phase[r, j]))
//
// for frame row r = (b, f), sample j < block, a0 = amps[b, f], a1 =
// amps[b, f + 1] (the last frame repeated), and wrap(y) = y - 2 pi rint(y /
// 2 pi) as the TPU kernel wraps it (sin is periodic, so the wrap changes
// nothing but the rounding).
//
// Bound on the H100: operations. Per sample it reads one float and writes
// one, but sums one sine per harmonic (33.5 M terms for a 512-frame segment
// at 128 harmonics, 270 M for a training batch of 24 x 172 frames).
//
// Design: the TPU kernel tiled 8 frames x block samples x 128 harmonics in
// VMEM for its vector unit and took one sine a term. Here a block of 128
// threads covers 512 samples of one frame row, 4 consecutive samples a
// thread (a float4 load of the phase and a float4 store where block % 4 ==
// 0), with the frame's amplitudes a0 and the slope a1 - a0 staged in shared
// memory, zero-padded to a multiple of 4 harmonics: one LDS.128 of each
// serves 4 harmonics x 4 samples. The (B, T, n_h) bank never exists. The
// sines come from the Chebyshev step along the harmonics,
//     s[k+1] = 2 cos(phase) s[k] - s[k-1]      (one FFMA),
// restarted every kReseed harmonics from the SFU's __sincosf of (k+1)
// phase, wrapped to [-pi, pi] exactly (the product's rounding error
// recovered by an FMA, 2 pi split in two), which bounds the error's growth
// near phase 0 and +-pi; sin and cos of the phase itself come from an
// accurate polynomial (sincos_accurate). The lerp is split: sum_k (a0_k +
// f slope_k) s_k = sum a0_k s_k + f sum slope_k s_k, two FFMAs a term and
// one at the end. So three FFMAs a term and two LDS.128 per 4 harmonics x
// 4 samples, and 1/8 of an SFU operation a term, against ~12 issue slots
// and one SFU operation in the earlier form, which took __sinf of every
// term. tools/ab_torch_oscillators.py counts the compiled loop's
// instructions a term in the SASS, and times and holds against float64
// the alternatives (the rotation z[k+1] = z[k] e^{j phase}, 4 slots a
// step; a re-seed every 8 or 32; the lerp unsplit): on an H100 at 700 W
// the rotation ran ~1.6x slower at equal R, and the Chebyshev step at R =
// 32 fails the float64 gate (PERF.md). tests/test_torch_synths.py
// emulates this evaluation order on the CPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSamples = 4;                 // consecutive samples a thread
constexpr int kThreads = 512 / kSamples;    // a block covers 512 samples
constexpr int kMinBlocks = 1024 / kThreads;  // at most 64 registers a thread
static_assert(kSamples % 4 == 0, "samples a thread come in float4s");
constexpr int kReseed = 16;  // harmonics between re-seeds
static_assert(kReseed % 4 == 0, "a re-seed falls between float4s of harmonics");
constexpr float kInvTwoPi = 0.15915494309189533577f;
constexpr float kTwoPiHi = 6.28125f;                   // 8 significant bits
constexpr float kTwoPiLo = 1.9353071795864769253e-3f;  // 2 pi - kTwoPiHi

// sin and cos of x for |x| <= ~pi to ~1 ulp: x = q pi/2 + r with a
// three-part pi/2, then the minimax polynomials of the CUDA math library's
// sinf/cosf on [-pi/4, pi/4]. No large-argument path.
__device__ __forceinline__ void sincos_accurate(float x, float* s, float* c) {
  const float q = rintf(__fmul_rn(x, 0.636619772f));
  float r = fmaf(q, -1.57079601e+00f, x);
  r = fmaf(q, -3.13916473e-07f, r);
  r = fmaf(q, -5.39030253e-15f, r);
  const float r2 = __fmul_rn(r, r);
  float ps = fmaf(-1.95152959e-4f, r2, 8.33216087e-3f);
  ps = fmaf(ps, r2, -1.66666546e-1f);
  const float sr = fmaf(__fmul_rn(ps, r2), r, r);
  float pc = fmaf(2.44331571e-5f, r2, -1.38873163e-3f);
  pc = fmaf(pc, r2, 4.16666457e-2f);
  pc = fmaf(pc, r2, -5.00000000e-1f);
  const float cr = fmaf(pc, r2, 1.f);
  const int i = (int)q;
  const float sv = (i & 1) ? cr : sr, cv = (i & 1) ? sr : cr;
  *s = (i & 2) ? -sv : sv;
  *c = ((i + 1) & 2) ? -cv : cv;
}

// sin and cos of n * ph through the SFU, the argument wrapped to [-pi, pi]
// to within ~2.4e-7: n * ph = y + lo exactly, y - q kTwoPiHi exact.
__device__ __forceinline__ void sincos_multiple(float n, float ph, float* s, float* c) {
  const float y = __fmul_rn(n, ph);
  const float lo = fmaf(n, ph, -y);
  const float q = rintf(__fmul_rn(y, kInvTwoPi));
  float r = fmaf(-q, kTwoPiHi, y);
  r = fmaf(-q, kTwoPiLo, r);
  __sincosf(__fadd_rn(r, lo), s, c);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
oscillator_bank_kernel(const float* __restrict__ phase, const float* __restrict__ amps,
                       float* __restrict__ out, int n_frames, int n_h, int h_pad,
                       int block) {
  extern __shared__ float4 sm4[];
  float4* a0v = sm4;              // h_pad / 4: this frame's amplitudes
  float4* slv = sm4 + h_pad / 4;  // h_pad / 4: next frame's minus this frame's
  float* a0 = reinterpret_cast<float*>(a0v);
  float* sl = reinterpret_cast<float*>(slv);
  const size_t row = blockIdx.x;
  const int f = (int)(row % n_frames);
  const float* ar = amps + row * n_h;
  const float* an = (f + 1 < n_frames) ? ar + n_h : ar;
  for (int k = threadIdx.x; k < h_pad; k += kThreads) {
    const float v = k < n_h ? ar[k] : 0.f;
    a0[k] = v;
    sl[k] = k < n_h ? __fsub_rn(an[k], v) : 0.f;
  }
  __syncthreads();
  const int j0 = (blockIdx.y * kThreads + threadIdx.x) * kSamples;
  if (j0 >= block) return;
  const float* pr = phase + row * block + j0;
  float ph[kSamples];
  if (kVec) {
#pragma unroll
    for (int v = 0; v < kSamples; v += 4) {
      const float4 p = *reinterpret_cast<const float4*>(pr + v);
      ph[v] = p.x; ph[v + 1] = p.y; ph[v + 2] = p.z; ph[v + 3] = p.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kSamples; ++i) ph[i] = j0 + i < block ? pr[i] : 0.f;
  }
  float frac[kSamples], s1[kSamples], c1[kSamples], c2[kSamples], s[kSamples],
      u[kSamples];
  float acc0[kSamples], acc1[kSamples];
#pragma unroll
  for (int i = 0; i < kSamples; ++i) {
    frac[i] = __fdiv_rn((float)(j0 + i), (float)block);
    sincos_accurate(ph[i], &s1[i], &c1[i]);
    c2[i] = __fmul_rn(2.f, c1[i]);
    acc0[i] = acc1[i] = 0.f;
    s[i] = s1[i];  // the step's state at harmonic 1: sin(ph), and sin(0)
    u[i] = 0.f;
  }
  for (int k0 = 0; k0 < h_pad; k0 += kReseed) {
    if (k0 > 0) {
      const float n = (float)(k0 + 1);
#pragma unroll
      for (int i = 0; i < kSamples; ++i) {
        float sn, cn;
        sincos_multiple(n, ph[i], &sn, &cn);
        s[i] = sn;  // sin(n ph), and sin(n ph - ph) from the angle difference
        u[i] = fmaf(sn, c1[i], -__fmul_rn(cn, s1[i]));
      }
    }
#pragma unroll
    for (int m = 0; m < kReseed; m += 4) {
      const int k = k0 + m;
      if (k >= h_pad) break;
      const float4 av = a0v[k >> 2], dv = slv[k >> 2];
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float d[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < kSamples; ++i) {
          acc0[i] = fmaf(a[q], s[i], acc0[i]);
          acc1[i] = fmaf(d[q], s[i], acc1[i]);
          const float next = fmaf(c2[i], s[i], -u[i]);
          u[i] = s[i];
          s[i] = next;
        }
      }
    }
  }
  float y[kSamples];
#pragma unroll
  for (int i = 0; i < kSamples; ++i)
    y[i] = fmaf(frac[i], acc1[i], acc0[i]);
  float* o = out + row * block + j0;
  if (kVec) {
#pragma unroll
    for (int v = 0; v < kSamples; v += 4)
      *reinterpret_cast<float4*>(o + v) = make_float4(y[v], y[v + 1], y[v + 2], y[v + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < kSamples; ++i)
      if (j0 + i < block) o[i] = y[i];
  }
}

// The dynamic shared memory limit of both forms, set once per process to
// the card's opt-in maximum (a frame's 2 x h_pad floats pass 48 KB only
// above 6144 harmonics).
cudaError_t setup() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(oscillator_bank_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(oscillator_bank_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err;
}

int pad4(int n_h) { return (n_h + 3) / 4 * 4; }

}  // namespace

// phase, out: (rows * block,) fp32, rows = B * n_frames; amps: (rows, n_h).
extern "C" int oscillator_bank_launch(const float* phase, const float* amps, float* out,
                                      int rows, int n_frames, int n_h, int block,
                                      void* stream) {
  static const cudaError_t once = setup();
  if (once != cudaSuccess) return (int)once;
  if (rows == 0 || block == 0) return 0;
  const int h_pad = pad4(n_h);
  const dim3 grid(rows, (block + kThreads * kSamples - 1) / (kThreads * kSamples));
  const size_t smem = (size_t)2 * h_pad * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (block % kSamples == 0 && (((size_t)phase | (size_t)out) & 15) == 0)
    oscillator_bank_kernel<true><<<grid, kThreads, smem, s>>>(
        phase, amps, out, n_frames, n_h, h_pad, block);
  else
    oscillator_bank_kernel<false><<<grid, kThreads, smem, s>>>(
        phase, amps, out, n_frames, n_h, h_pad, block);
  return (int)cudaGetLastError();
}

// The kernel on the current card (its float4 form): out[0] registers per
// thread, out[1] local-memory (spilled) bytes per thread, out[2] dynamic
// shared bytes per block at n_h harmonics.
extern "C" int oscillator_bank_info(int n_h, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, oscillator_bank_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)(2 * pad4(n_h) * sizeof(float));
  return 0;
}
