// The NSF-HiFiGAN harmonic source with its Linear(H -> 1) + tanh merge.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::harmonic_source_pallas
// (body _harmonic_source_kernel).
//
//   out[r, s-1] = tanh(sine_amp * sum_k w[k] sin(2 pi wrap(start[r,k] + rad[r,k] s)) + b)
//   for frame row r and sample s = 1..upp, wrap(x) = x - rint(x).
//
// Bound on the H100: bytes (one float written per output sample, 2H floats
// read per row of upp samples); the work is small (9 sines a sample, 2.4 M
// at the path's 512 frames x upp 512), so a call is short and its time is
// mostly the launch and the wrapper's host work.
//
// Design: a block takes 512 samples of one frame row (grid (rows,
// ceil(upp / 512))); each thread makes 4 consecutive samples, with one
// float4 store where upp % 4 == 0, so each read of a row's start, rad and
// merge weight (one address a warp: a broadcast from L1) serves 4 samples
// and any number of harmonics fits. The (B, F, upp, H) sine bank never
// exists anywhere. The phase is computed exactly as the plain PyTorch
// version computes it: the _rn intrinsics keep rad * s and the add apart
// (no FMA), since at upp = 512 the phase reaches ~256 rotations, where a
// contraction alone would move the result by ~2e-5, the tolerance. The
// phase is then wrapped to [-0.5, 0.5] rotations, which the SFU's __sinf
// takes at an absolute error of ~4e-7 (the accurate sinpif, a variant in
// tools/ab_torch_oscillators.py, ran 1.5x slower on an H100 at 700 W and
// no closer to float64: the phase's own rounding leads; PERF.md). The
// merge keeps the accurate tanhf, one a sample.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSamples = 4;  // consecutive samples a thread
constexpr float kTwoPi = 6.28318530717958647692f;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
harmonic_source_kernel(const float* __restrict__ start, const float* __restrict__ rad,
                       const float* __restrict__ w, const float* __restrict__ b,
                       float* __restrict__ out, int n_h, int upp, float sine_amp) {
  const size_t r = blockIdx.x;
  const int s0 = (blockIdx.y * kThreads + threadIdx.x) * kSamples;
  if (s0 >= upp) return;
  const float* st = start + r * n_h;
  const float* rd = rad + r * n_h;
  float acc[kSamples] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n_h; ++k) {
    const float a = __ldg(st + k), rk = __ldg(rd + k), wt = __ldg(w + k);
#pragma unroll
    for (int i = 0; i < kSamples; ++i) {
      float ph = __fadd_rn(a, __fmul_rn(rk, (float)(s0 + i + 1)));
      ph = __fsub_rn(ph, rintf(ph));
      acc[i] = __fadd_rn(acc[i], __fmul_rn(__sinf(__fmul_rn(kTwoPi, ph)), wt));
    }
  }
  const float bias = __ldg(b);
  float y[kSamples];
#pragma unroll
  for (int i = 0; i < kSamples; ++i) y[i] = tanhf(__fadd_rn(__fmul_rn(sine_amp, acc[i]), bias));
  float* o = out + r * upp + s0;
  if (kVec) {
    *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kSamples; ++i)
      if (s0 + i < upp) o[i] = y[i];
  }
}

}  // namespace

// start, rad: (rows, n_h) fp32; w: (n_h,); b: (1,); out: (rows, upp).
extern "C" int harmonic_source_launch(const float* start, const float* rad,
                                      const float* w, const float* b, float* out,
                                      int rows, int n_h, int upp, float sine_amp,
                                      void* stream) {
  if (rows == 0 || upp == 0) return 0;
  constexpr int kPerBlock = kThreads * kSamples;
  const dim3 grid(rows, (upp + kPerBlock - 1) / kPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (upp % kSamples == 0 && ((size_t)out & 15) == 0)
    harmonic_source_kernel<true><<<grid, kThreads, 0, s>>>(start, rad, w, b, out,
                                                            n_h, upp, sine_amp);
  else
    harmonic_source_kernel<false><<<grid, kThreads, 0, s>>>(start, rad, w, b, out,
                                                             n_h, upp, sine_amp);
  return (int)cudaGetLastError();
}

// The kernel on the current card (its float4 form): out[0] registers per
// thread, out[1] local-memory (spilled) bytes per thread, out[2] dynamic
// shared bytes per block (none).
extern "C" int harmonic_source_info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, harmonic_source_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = 0;
  return 0;
}
