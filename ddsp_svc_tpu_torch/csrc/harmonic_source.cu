// The NSF-HiFiGAN harmonic source with its Linear(9 -> 1) + tanh merge.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::harmonic_source_pallas
// (body _harmonic_source_kernel).
//
//   out[r, s-1] = tanh(sine_amp * sum_k w[k] sin(2 pi wrap(start[r,k] + rad[r,k] s)) + b)
//   for frame row r and sample s = 1..upp, wrap(x) = x - rint(x).
//
// Bound on the H100: bytes in principle (one float written per output
// sample, 18 floats read per row of upp samples), but the 9 sines per sample
// cost ~20 instructions each, so at upp = 512 it is bound by operations on
// the CUDA cores: ~200 instructions per 4-byte output.
//
// Design: one thread per output sample, one block row per frame row, so the
// (B, F, upp, 9) sine bank never exists anywhere; only the merged audio is
// written, coalesced along the sample axis. The phase is wrapped before the
// sine as the TPU kernel does, keeping sinf off its slow large-argument
// path. The products and sums use the _rn intrinsics so that nothing is
// contracted into an FMA: each rounds as the plain PyTorch version's
// separate elementwise operations do. The TPU kernel's upp % 128 gate was
// its lane tiling and is gone.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr float kTwoPi = 6.28318530717958647692f;

__global__ void __launch_bounds__(kThreads)
harmonic_source_kernel(const float* __restrict__ start, const float* __restrict__ rad,
                       const float* __restrict__ w, const float* __restrict__ b,
                       float* __restrict__ out, int n_h, int upp, float sine_amp) {
  const size_t r = blockIdx.x;
  const int s = blockIdx.y * kThreads + threadIdx.x;
  if (s >= upp) return;
  const float sf = (float)(s + 1);
  const float* st = start + r * n_h;
  const float* rd = rad + r * n_h;
  float acc = 0.f;
  for (int k = 0; k < n_h; ++k) {
    float ph = __fadd_rn(st[k], __fmul_rn(rd[k], sf));
    ph = __fsub_rn(ph, rintf(ph));
    acc = __fadd_rn(acc, __fmul_rn(sinf(__fmul_rn(kTwoPi, ph)), w[k]));
  }
  out[r * upp + s] = tanhf(__fadd_rn(__fmul_rn(sine_amp, acc), b[0]));
}

}  // namespace

// start, rad: (rows, n_h) fp32; w: (n_h,); b: (1,); out: (rows, upp).
extern "C" int harmonic_source_launch(const float* start, const float* rad,
                                      const float* w, const float* b, float* out,
                                      int rows, int n_h, int upp, float sine_amp,
                                      void* stream) {
  const dim3 grid(rows, (upp + kThreads - 1) / kThreads);
  harmonic_source_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      start, rad, w, b, out, n_h, upp, sine_amp);
  return (int)cudaGetLastError();
}
