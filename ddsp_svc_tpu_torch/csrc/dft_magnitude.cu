// Magnitude of the real DFT of each frame row, for any n.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::dft_magnitude_pallas
// (body _dft_mag_kernel, forward _dft_mag_fwd_impl).
//
//   out[r, k] = sqrt(re^2 + im^2 + 1e-12),  re - j*im = sum_t x[r, t] e^{-2 pi j k t / n}
//   for k = 0 .. n/2.
//
// The multi-resolution spectral loss of training draws its FFT sizes from a
// linear set (256, 375, ..., 2047): all but one are not powers of two, so
// the radix-2 FFT of combsub_spectral.cu does not apply. The TPU computed
// the transform as a (rows x n) @ (n x bins) matmul on its matrix unit with
// cos/sin weight blocks streamed through VMEM.
//
// Bound on the H100: operations. This is a direct DFT, 4 n flops per
// (row, bin) against 4 (n + bins) bytes moved per row: ~n/2 flops per byte,
// far above the fp32 ridge (~20). The least work for the same function is an
// FFT of the same size (~5 n log2 n / 2 flops per real row), which is what
// the bound in chip_smoke.py counts; this kernel does ~n / (1.25 log2 n)
// times that (~150x at n = 2047), so it is slow by design: a right first
// version, with cuFFT's time recorded beside it for the redesign.
//
// Design: one block holds a tile of kRows frame rows and one thread per
// output bin of its bin tile. Frame samples stream through shared memory in
// chunks of kChunk samples stored sample-major ([t][row]), so each thread
// reads the kRows samples of one t as broadcast float4 loads and feeds
// 2 * kRows FMAs per twiddle. The twiddles come from a length-n cos/sin table
// in shared memory (built in double precision), indexed by the exact integer
// (k * t) mod n and advanced by k each step, so the angle never drifts. Each
// chunk is summed in fp32 on its own and then added to the row totals, which
// keeps the rounding of the long sums near that of a pairwise sum. The
// magnitude is fused: only (rows, bins) leaves the block. No padding of n or
// of the bins to the TPU's (128, 128) tiles.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;     // frame rows per block
constexpr int kChunk = 128;   // samples per shared-memory chunk
constexpr int kMaxBinThreads = 128;

__global__ void __launch_bounds__(kMaxBinThreads)
dft_magnitude_kernel(const float* __restrict__ frames, float* __restrict__ out,
                     int rows, int n, int bins) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);              // [kChunk][kRows]
  float2* tw = reinterpret_cast<float2*>(xs + kChunk * kRows);  // [n]

  const int r0 = blockIdx.x * kRows;
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = k < bins;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double s, c;
    sincospi(2.0 * (double)i / (double)n, &s, &c);
    tw[i] = make_float2((float)c, (float)s);
  }

  float re[kRows], im[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) { re[r] = 0.f; im[r] = 0.f; }

  for (int t0 = 0; t0 < n; t0 += kChunk) {
    const int len = min(kChunk, n - t0);
    __syncthreads();  // the previous chunk is consumed (and tw is built)
    for (int i = threadIdx.x; i < kChunk * kRows; i += blockDim.x) {
      const int r = i / kChunk;
      const int tt = i - r * kChunk;
      const int row = r0 + r;
      float v = 0.f;
      if (tt < len && row < rows) v = frames[(size_t)row * n + t0 + tt];
      xs[tt * kRows + r] = v;
    }
    __syncthreads();
    if (active) {
      float cre[kRows], cim[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) { cre[r] = 0.f; cim[r] = 0.f; }
      int idx = (int)(((long long)k * t0) % n);
      for (int tt = 0; tt < len; ++tt) {
        const float2 w = tw[idx];
        const float4* x4 = reinterpret_cast<const float4*>(xs + tt * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 x = x4[q];
          cre[4 * q + 0] = fmaf(x.x, w.x, cre[4 * q + 0]);
          cim[4 * q + 0] = fmaf(x.x, w.y, cim[4 * q + 0]);
          cre[4 * q + 1] = fmaf(x.y, w.x, cre[4 * q + 1]);
          cim[4 * q + 1] = fmaf(x.y, w.y, cim[4 * q + 1]);
          cre[4 * q + 2] = fmaf(x.z, w.x, cre[4 * q + 2]);
          cim[4 * q + 2] = fmaf(x.z, w.y, cim[4 * q + 2]);
          cre[4 * q + 3] = fmaf(x.w, w.x, cre[4 * q + 3]);
          cim[4 * q + 3] = fmaf(x.w, w.y, cim[4 * q + 3]);
        }
        idx += k;
        if (idx >= n) idx -= n;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) { re[r] += cre[r]; im[r] += cim[r]; }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = r0 + r;
    if (row < rows) {
      out[(size_t)row * bins + k] = sqrtf(re[r] * re[r] + im[r] * im[r] + 1e-12f);
    }
  }
}

}  // namespace

// frames: (rows, n) fp32; out: (rows, n/2+1) fp32. 2 <= n <= 8192.
extern "C" int dft_magnitude_launch(const float* frames, float* out, int rows,
                                    int n, void* stream) {
  const int bins = n / 2 + 1;
  const int tiles = (bins + kMaxBinThreads - 1) / kMaxBinThreads;
  int threads = (bins + tiles - 1) / tiles;
  threads = (threads + 31) / 32 * 32;
  const size_t smem = (size_t)kChunk * kRows * sizeof(float) + (size_t)n * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      dft_magnitude_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kRows - 1) / kRows, tiles);
  dft_magnitude_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      frames, out, rows, n, bins);
  return (int)cudaGetLastError();
}
