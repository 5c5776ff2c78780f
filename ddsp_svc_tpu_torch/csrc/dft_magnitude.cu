// Magnitude of the real DFT of each frame row, for any n, as an FFT.
//
// Replaces: ddsp_svc_tpu/ops/pallas_kernels.py::dft_magnitude_pallas
// (body _dft_mag_kernel, forward _dft_mag_fwd_impl).
//
//   out[r, k] = sqrt(re^2 + im^2 + 1e-12),  re + j im = sum_t x[r, t] e^{-2 pi j k t / n}
//   for k = 0 .. n/2.
//
// The multi-resolution spectral loss of training draws its FFT sizes from a
// linear set (256, 375, ..., 2047): all but one are not powers of two, and
// most have a large prime factor (853 is prime, 2047 = 23 * 89), so a
// mixed-radix FFT does not cover them. The TPU computed the transform as a
// (rows x n) @ (n x bins) matmul on its matrix unit.
//
// Each row is a complex transform of length l through fft_pow2.cuh:
//   - even n: z[i] = x[2i] + j x[2i+1], l = n/2, and X follows from Z =
//     DFT_l(z) by the real split (X[k] and X[l-k] from Z[k], Z[l-k]);
//   - odd n: z = x, l = n.
// l a power of two (n = 256 on the loss's path): one l-point FFT. Any other
// l: Bluestein's chirp-z transform, with c[t] = exp(-j pi t^2 / l),
//   Z[k] = c[k] sum_t (z[t] c[t]) conj(c[k - t]),
// a cyclic convolution of length m, the least power of two >= 2l - 1: one
// forward m-point FFT of z c (zero past l; the first pass loads no zero),
// the product with FFT_m(conj c) / m, one inverse m-point FFT, and c[k] on
// the way out (the product rides on the forward's last store, c[k] on the
// inverse's). c and FFT_m(conj c) / m are per-n tables that the wrapper
// builds once in float64 (t^2 mod 2l in integers, so no angle comes from a
// large fp32 product) and caches per (n, device) in fp32. For odd n the
// magnitude is written from the inverse's last pass (|c[k]| = 1); for even n
// the split runs on Z c in shared memory and writes the magnitudes of bins
// 0 .. l. m is 1024 to 4096 on the loss's 15 other sizes (614 = 2 * 307
// runs a Bluestein of 307 at m = 1024), 16384 at n = 8191.
//
// Rows are never packed into one complex transform: silent frames sit beside
// loud ones, the loss takes log(|X| + 1e-7), and a shared transform would
// round a quiet row at its loud neighbour's scale.
//
// Bound on the H100: bytes. Per row it reads n floats and writes n/2 + 1;
// an FFT of the same size needs ~2.5 n log2 n flops per row (what
// chip_smoke.py's bound counts), ~4.5 flops per byte at n = 2047 against
// the fp32 ridge of ~20. Bluestein does 4-8x that work (two m-point complex
// FFTs), which brings it to the ridge; what the design does about it: the
// row stays in shared memory from its load to its magnitudes, the filter
// product and the chirps ride on the passes' loads and stores, and rows
// too short to fill 256 threads share a block (256 / (m / 16) rows), so
// that the 1032-8256 rows of a training batch fill the card's 132 SMs.
//
// The bf16-input form (dft_magnitude_pallas(mxu_bf16=True), the staged-bf16
// enhancer's mel): the rows are bf16, read by the first pass's load and
// upcast exactly; the FFT, the tables and the 1e-12 floor stay fp32. JAX
// rounds its DFT matrices to bf16 too, which an FFT has no use for, so the
// two agree to JAX's own bf16-vs-fp32 bound, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fft_pow2.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float magnitude(float2 v) {
  return sqrtf(v.x * v.x + v.y * v.y + 1e-12f);
}

// threads for one row: M / 16 (M / R for M < 16); rows too short to fill
// 256 threads share a block; M > 4096 (n > 4096, or Bluestein above n =
// 2048) takes 512 or 1024 threads for one row
__host__ __device__ constexpr int row_threads(int m) { return m < 16 ? 1 : m / 16; }
__host__ __device__ constexpr int block_threads(int m) {
  return row_threads(m) > kThreads ? row_threads(m) : kThreads;
}

template <int M, typename T>
__global__ void __launch_bounds__(block_threads(M))
dft_magnitude_kernel(const T* __restrict__ frames, float* __restrict__ out,
                     const float2* __restrict__ chirp,
                     const float2* __restrict__ bhat, int rows, int n, int l) {
  extern __shared__ float2 smem[];
  constexpr int tpr = row_threads(M);
  const int slot = threadIdx.x / tpr;
  const int t = threadIdx.x - slot * tpr;
  const int row = blockIdx.x * (blockDim.x / tpr) + slot;
  const bool live = row < rows;  // a spare slot still takes part in the syncs
  const T* x = frames + (size_t)(live ? row : 0) * n;
  const int bins = n / 2 + 1;
  float* o = out + (size_t)row * bins;
  float2* s = smem + slot * padded(M);
  const bool split = 2 * l == n;

  auto sample = [&](int i) {
    return split ? make_float2(to_f32(x[2 * i]), to_f32(x[2 * i + 1]))
                 : make_float2(to_f32(x[i]), 0.f);
  };
  if (M == l) {
    fft_pow2<M, false>(s, t, sample, [s](int i, float2 v) { s[pad(i)] = v; });
  } else {
    auto load = [&](int i) {
      return i < l ? cmul(sample(i), chirp[i]) : make_float2(0.f, 0.f);
    };
    fft_pow2<M, false>(s, t, load, [&](int i, float2 v) { s[pad(i)] = cmul(v, bhat[i]); });
    __syncthreads();
    auto from_smem = [s](int i) { return s[pad(i)]; };
    if (!split) {
      fft_pow2<M, true>(s, t, from_smem, [&](int i, float2 v) {
        if (live && i < bins) o[i] = magnitude(v);
      });
      return;
    }
    fft_pow2<M, true>(s, t, from_smem, [&](int i, float2 v) {
      if (i < l) s[pad(i)] = cmul(v, chirp[i]);
    });
  }
  __syncthreads();
  if (!live) return;
  const float inv_n = 1.0f / (float)n;
  for (int k = t; k <= l / 2; k += tpr) {
    float sn, cs;
    sincospif(2.0f * (float)k * inv_n, &sn, &cs);
    float2 xk, xj;
    real_split(s[pad(k)], s[pad(k == 0 ? 0 : l - k)], make_float2(cs, -sn), xk, xj);
    o[k] = magnitude(xk);
    o[l - k] = magnitude(xj);
  }
}

template <int M, typename T>
int launch(const T* frames, float* out, const float2* chirp,
           const float2* bhat, int rows, int n, int l, cudaStream_t stream) {
  constexpr int per_block = block_threads(M) / row_threads(M);
  constexpr size_t smem = (size_t)per_block * padded(M) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      dft_magnitude_kernel<M, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + per_block - 1) / per_block;
  dft_magnitude_kernel<M, T><<<blocks, block_threads(M), smem, stream>>>(
      frames, out, chirp, bhat, rows, n, l);
  return (int)cudaGetLastError();
}

template <int M, typename T>
int launch_m(int m, const T* frames, float* out, const float2* chirp,
             const float2* bhat, int rows, int n, int l, cudaStream_t stream) {
  if (m == M) return launch<M>(frames, out, chirp, bhat, rows, n, l, stream);
  if constexpr (M < 16384) {
    return launch_m<2 * M>(m, frames, out, chirp, bhat, rows, n, l, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// frames: (rows, n) fp32; out: (rows, n/2+1) fp32; 2 <= n <= 8192. l, m:
// the transform's complex length and FFT length (ops/kernels.py::dft_plan);
// chirp (l) and bhat (m) complex fp32 tables when m != l, else null.
extern "C" int dft_magnitude_launch(const float* frames, float* out,
                                    const void* chirp, const void* bhat,
                                    int rows, int n, int l, int m, void* stream) {
  if (rows == 0) return 0;
  return launch_m<1>(m, frames, out, static_cast<const float2*>(chirp),
                     static_cast<const float2*>(bhat), rows, n, l,
                     (cudaStream_t)stream);
}

// The bf16-input form: frames (rows, n) bf16, the rest as
// dft_magnitude_launch.
extern "C" int dft_magnitude_bf16_launch(const void* frames, float* out,
                                         const void* chirp, const void* bhat,
                                         int rows, int n, int l, int m, void* stream) {
  if (rows == 0) return 0;
  return launch_m<1>(m, static_cast<const __nv_bfloat16*>(frames), out,
                     static_cast<const float2*>(chirp), static_cast<const float2*>(bhat),
                     rows, n, l, (cudaStream_t)stream);
}
