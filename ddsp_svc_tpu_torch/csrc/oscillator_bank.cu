// The Sins synthesizer's additive oscillator bank, one thread per sample.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::oscillator_bank_pallas
// (body _osc_kernel).
//
//   out[r, j] = sum_k (a0[k] + (a1[k] - a0[k]) * j / block)
//                     * sin(wrap((k + 1) * phase[r, j]))
//
// for frame row r = (b, f), sample j < block, a0 = amps[b, f], a1 =
// amps[b, f + 1] (the last frame repeated), and wrap(y) = y - 2 pi rint(y /
// 2 pi), which brings the argument to [-pi, pi] as the TPU kernel does.
//
// Bound on the H100: operations. Per sample it reads one float and writes
// one, but evaluates one sine per harmonic: 128 sines and ~9 other fp32
// operations each per 8 bytes moved (33.5 M terms for a 512-frame segment,
// 270 M for a training batch of 24 x 172 frames).
//
// Design: the TPU kernel tiled 8 frames x block samples x 128 harmonics in
// VMEM for its 128-lane vector unit. Here a block of 128 threads covers 128
// samples of one frame row, with the frame's two amplitude rows staged in
// shared memory (as a0 and the slope a1 - a0, 2 x n_h floats), so each
// thread reads every amplitude from shared memory (a broadcast) and loops
// over the harmonics with its phase in a register; the (B, T, n_h) bank
// never exists. The lerp, the argument and the wrap use the _rn intrinsics so
// that nothing contracts into an FMA and each rounds as the plain PyTorch
// version's separate elementwise operations do. The sine is the SFU's
// __sinf (abs error ~4e-7 on [-pi, pi]): against the plain version it
// measured 1.2x the error of the accurate sinf (both are dominated by the
// argument's own rounding) at 2.5x its speed on the H100 (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvTwoPi = 0.15915494309189533577f;

__global__ void __launch_bounds__(kThreads)
oscillator_bank_kernel(const float* __restrict__ phase, const float* __restrict__ amps,
                       float* __restrict__ out, int n_frames, int n_h, int block) {
  extern __shared__ float sm[];
  float* a0 = sm;         // n_h: this frame's amplitudes
  float* slope = sm + n_h;  // n_h: next frame's minus this frame's
  const size_t row = blockIdx.x;
  const int f = (int)(row % n_frames);
  const float* ar = amps + row * n_h;
  const float* an = (f + 1 < n_frames) ? ar + n_h : ar;
  for (int k = threadIdx.x; k < n_h; k += kThreads) {
    const float v = ar[k];
    a0[k] = v;
    slope[k] = __fsub_rn(an[k], v);
  }
  __syncthreads();
  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= block) return;
  const float frac = (float)j / (float)block;
  const float ph = phase[row * block + j];
  float acc = 0.f;
  for (int k = 0; k < n_h; ++k) {
    const float amp = __fadd_rn(a0[k], __fmul_rn(slope[k], frac));
    float y = __fmul_rn(ph, (float)(k + 1));
    y = __fsub_rn(y, __fmul_rn(kTwoPi, rintf(__fmul_rn(y, kInvTwoPi))));
    acc = __fadd_rn(acc, __fmul_rn(amp, __sinf(y)));
  }
  out[row * block + j] = acc;
}

}  // namespace

// phase, out: (rows * block,) fp32, rows = B * n_frames; amps: (rows, n_h).
extern "C" int oscillator_bank_launch(const float* phase, const float* amps, float* out,
                                      int rows, int n_frames, int n_h, int block,
                                      void* stream) {
  if (rows == 0) return 0;
  const dim3 grid(rows, (block + kThreads - 1) / kThreads);
  const size_t smem = (size_t)2 * n_h * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      oscillator_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  oscillator_bank_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      phase, amps, out, n_frames, n_h, block);
  return (int)cudaGetLastError();
}
