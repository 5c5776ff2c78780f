// Radix-2 complex FFTs of one row in shared memory, for a kernel that owns a
// frame row per block (combsub_spectral_bwd.cu). It cannot share a
// translation unit with fft_pow2.cuh: both define cmul.
//
// The caller loads the row in bit-reversed order (s[__brev(i) >> (32 -
// log2 n)] = x[i]), fills the twiddles, synchronises, and calls
// fft_inplace; every thread of the block takes part, and the block is
// synchronised on return. n is a power of two.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// tw[k] = exp(-2 pi i k / n) for k < n/2.
__device__ __forceinline__ void fill_twiddles(float2* tw, int n) {
  for (int k = threadIdx.x; k < n / 2; k += blockDim.x) {
    float sn, cs;
    sincospif(2.0f * (float)k / (float)n, &sn, &cs);
    tw[k] = make_float2(cs, -sn);
  }
}

// In-place radix-2 decimation-in-time FFT of s[0, n), loaded in bit-reversed
// order; the twiddles are conjugated for the inverse (unscaled).
__device__ void fft_inplace(float2* s, const float2* tw, int n, bool inverse) {
  for (int len = 2; len <= n; len <<= 1) {
    const int half = len >> 1;
    const int step = n / len;
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
      const int pos = i & (half - 1);
      const int a = (i - pos) * 2 + pos;
      const int b = a + half;
      float2 w = tw[pos * step];
      if (inverse) w.y = -w.y;
      const float2 u = s[a];
      const float2 t = cmul(s[b], w);
      s[a] = make_float2(u.x + t.x, u.y + t.y);
      s[b] = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }
}

__host__ __forceinline__ int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace
