// Power-of-two complex FFTs of one row in shared memory, with radix-R
// butterflies in registers (Stockham autosort, natural order in and out).
// Shared by dft_magnitude.cu (the loss's |rfft|, Bluestein for the sizes
// that are not powers of two), ltv_fir_convolve.cu, combsub_spectral.cu and
// combsub_spectral_bwd.cu (the CombSubFast chain and its adjoint).
//
// A transform of M points (a power of two, a template argument, so that
// every stride, pad and pass count is a constant) runs on M / R threads of
// the block, R = min(M, 16) (or a smaller cap). Each pass of radix RR reads
// RR points per group, j + r M/RR for r < RR, multiplies them by the twiddles
// exp(-2 pi i k r / (NS RR)) of their group (k = j mod NS, NS the points
// already combined), runs an RR-point DFT in registers and writes them
// back at (j - k) RR + k + r NS. M = R0 R^(P-1): the first pass has radix
// R0 (each thread then holds R / R0 groups), the others R, so M = 1024 is
// 4 x 16 x 16: three passes with two exchanges through shared memory
// between them.
//
// The first pass reads its points through the caller's `load(i)` and the
// last one writes them through `store(i, v)`, so a caller reads a row
// straight from device memory (and skips its zero padding without a
// load), multiplies a spectrum by a filter on the way out, or writes the
// result straight to device memory; the passes between go through the
// shared buffer `s` (padded(M) values). Every thread of the block calls
// fft_pow2 with the same M (it synchronises the block); a caller that reads
// `s` after the last pass synchronises first.
//
// Twiddles: sine and cosine of an exact fraction (k r < 2^24 over a power
// of two) by a short polynomial at r = 1, 2, 4, 8, products of those for
// the other r, computed per thread; no table is built or read. The shared buffer holds
// one pad value after every 16, which makes the exchanges at R = 16 free of
// bank conflicts (each half-warp touches 16 distinct 8-byte bank pairs in
// every pass).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__host__ __device__ constexpr int padded(int m) { return m + (m >> 4); }
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conjf2(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

// exp(-2 pi i num * inv_den), conjugated for the inverse. f = num *
// inv_den is exact (inv_den a power of two, num < 2^24); folded to the
// nearest quarter turn q / 4, the rest u is in [-1/8, 1/8] (exact too), and
// sin and cos of 2 pi u are their Taylor polynomials to u^9 and u^10
// (truncation < 2e-9) in fp32 FMAs: within 1 ulp of 1 at every fraction of
// 2^14, as accurate as sincospif and nearly as cheap as the fast
// intrinsics, which are ~4e-7 off (tools/ab_torch_fft_kernels.py times all
// three)
template <bool INV>
__device__ __forceinline__ float2 twiddle(int num, float inv_den) {
  float f = (float)num * inv_den;
  f -= rintf(f);
  const float q = rintf(4.0f * f);
  const float u = fmaf(-0.25f, q, f);
  const float u2 = u * u;
  float sn = fmaf(u2, 42.058693f, -76.70586f);
  sn = fmaf(u2, sn, 81.60525f);
  sn = fmaf(u2, sn, -41.3417f);
  sn = fmaf(u2, sn, 6.2831855f) * u;
  float cs = fmaf(u2, -26.426256f, 60.24464f);
  cs = fmaf(u2, cs, -85.45682f);
  cs = fmaf(u2, cs, 64.93939f);
  cs = fmaf(u2, cs, -19.739208f);
  cs = fmaf(u2, cs, 1.0f);
  const int quarter = (int)q & 3;
  const float s_q = (quarter & 1) ? cs : sn, c_q = (quarter & 1) ? sn : cs;
  const float sin_f = (quarter & 2) ? -s_q : s_q;
  const float cos_f = ((quarter + 1) & 2) ? -c_q : c_q;
  return make_float2(cos_f, INV ? sin_f : -sin_f);
}

// d * exp(-2 pi i e / 16) (conjugated root for the inverse), e < 8 a
// compile-time constant after unrolling
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 d, int e) {
  constexpr float c1 = 0.92387953251128674f, c2 = 0.70710678118654752f,
                  c3 = 0.38268343236508977f;
  float c = 1.f, s = 0.f;
  switch (e) {
    case 0: return d;
    case 4: return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
    case 1: c = c1; s = c3; break;
    case 2: c = c2; s = c2; break;
    case 3: c = c3; s = c1; break;
    case 5: c = -c3; s = c1; break;
    case 6: c = -c2; s = c2; break;
    case 7: c = -c1; s = c3; break;
  }
  return cmul(d, make_float2(c, INV ? s : -s));
}

// i < 2^bits (bits <= 4) with its bits reversed: one expression, so that it
// folds to a constant in unrolled loops and the permutation stays in
// registers
__host__ __device__ constexpr int bit_reverse(int i, int bits) {
  return (((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3)) >>
         (4 - bits);
}

__host__ __device__ constexpr int log2c(int n) { return n <= 1 ? 0 : 1 + log2c(n / 2); }

// v[r] *= exp(-2 pi i k r * inv_span) for r < RR (conjugated for the
// inverse): sincospif at r = 1, 2, 4, 8 and, for every other r, the product
// of the root at its highest bit and the one at the rest (at most three
// roundings deep, at r = 15)
template <int RR, bool INV>
__device__ __forceinline__ void apply_twiddles(float2 (&v)[RR], int k, float inv_span) {
  float2 w[RR];
#pragma unroll
  for (int r = 1; r < RR; ++r) {
    const int hi = 1 << log2c(r);
    w[r] = hi == r ? twiddle<INV>(k * r, inv_span) : cmul(w[hi], w[r - hi]);
    v[r] = cmul(v[r], w[r]);
  }
}

// An RR-point DFT (RR <= 16) of v in registers, natural order in and out:
// radix-2 decimation in frequency, then the bit-reversal as renaming.
template <int RR, bool INV>
__device__ __forceinline__ void dft_reg(float2 (&v)[RR]) {
#pragma unroll
  for (int half = RR / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int i = 0; i < RR; ++i) {
      if (i & half) continue;
      const float2 a = v[i], b = v[i + half];
      v[i] = cadd(a, b);
      v[i + half] = rot16<INV>(csub(a, b), (i & (half - 1)) * (8 / half));
    }
  }
  float2 t[RR];
#pragma unroll
  for (int k = 0; k < RR; ++k) t[k] = v[bit_reverse(k, log2c(RR))];
#pragma unroll
  for (int k = 0; k < RR; ++k) v[k] = t[k];
}

// One Stockham pass of radix RR over M points, NS of them combined so far.
// All points are read before the block synchronises and any is written, so
// `load` and `store` may address the same buffer.
template <int M, int R, int RR, int NS, bool INV, class Load, class Store>
__device__ __forceinline__ void fft_pass(int t, Load& load, Store& store) {
  constexpr int G = R / RR, kThreadsPerRow = M / R, kStride = M / RR;
  float2 v[G][RR];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int r = 0; r < RR; ++r) v[g][r] = load(t + g * kThreadsPerRow + r * kStride);
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = t + g * kThreadsPerRow;
    const int k = j & (NS - 1);
    if constexpr (NS > 1) apply_twiddles<RR, INV>(v[g], k, 1.0f / (NS * RR));
    dft_reg<RR, INV>(v[g]);
    const int base = (j - k) * RR + k;
#pragma unroll
    for (int r = 0; r < RR; ++r) store(base + r * NS, v[g][r]);
  }
}

// The passes of radix R from NS points combined on, through shared memory,
// the last one into store
template <int M, int R, int NS, bool INV, class Store>
__device__ __forceinline__ void fft_passes(float2* s, int t, Store& store) {
  auto from_smem = [s](int i) { return s[pad(i)]; };
  auto to_smem = [s](int i, float2 v) { s[pad(i)] = v; };
  __syncthreads();
  if constexpr (NS * R == M) {
    fft_pass<M, R, R, NS, INV>(t, from_smem, store);
  } else {
    fft_pass<M, R, R, NS, INV>(t, from_smem, to_smem);
    fft_passes<M, R, NS * R, INV>(s, t, store);
  }
}

// The M-point DFT (unscaled; exp(+2 pi i ...) for INV) of load(0..M) into
// store(0..M), on threads t < M / R of the block, R = min(M, RMAX) (RMAX
// a power of two <= 16). M = R0 R^(P-1) runs a first pass of radix R0 and
// P - 1 of radix R. s: this transform's shared buffer of padded(M) values.
template <int M, bool INV, int RMAX = 16, class Load, class Store>
__device__ __forceinline__ void fft_pow2(float2* s, int t, Load load, Store store) {
  if constexpr (M == 1) {
    store(0, load(0));
  } else {
    constexpr int R = M < RMAX ? M : RMAX;
    constexpr int P = (log2c(M) + log2c(R) - 1) / log2c(R);
    constexpr int R0 = M >> ((P - 1) * log2c(R));
    if constexpr (P == 1) {
      fft_pass<M, R, R0, 1, INV>(t, load, store);
    } else {
      auto to_smem = [s](int i, float2 v) { s[pad(i)] = v; };
      fft_pass<M, R, R0, 1, INV>(t, load, to_smem);
      fft_passes<M, R, R0, INV>(s, t, store);
    }
  }
}

// X[k] and X[l - k] of the real 2l-point signal x from Z = DFT_l(z), z[i] =
// x[2i] + i x[2i+1]: zk = Z[k], zj = Z[(l - k) mod l], w = exp(-2 pi i k /
// 2l). At k = 0 it gives X[0] and X[l] with exactly zero imaginary parts.
__device__ __forceinline__ void real_split(float2 zk, float2 zj, float2 w,
                                           float2& xk, float2& xj) {
  const float2 e = make_float2(0.5f * (zk.x + zj.x), 0.5f * (zk.y - zj.y));
  const float2 o = make_float2(0.5f * (zk.y + zj.y), -0.5f * (zk.x - zj.x));
  const float2 wo = cmul(w, o);
  xk = cadd(e, wo);
  xj = conjf2(csub(e, wo));
}

// The inverse of real_split: Z'[k] and Z'[l - k] of the l-point spectrum
// whose unscaled inverse DFT is z'[i] = l (x[2i] + i x[2i+1]), x = irfft
// of the Hermitian spectrum X of 2l points, from xk = X[k], xj = X[l - k]
// (at k = 0 X[0] and X[l], whose imaginary parts the caller has zeroed),
// w = exp(-2 pi i k / 2l): Z' = Xe + i Xo, Xe and Xo the spectra of the
// even and odd samples. At k = 0 only zk is Z'[0]; zj is not a bin.
__device__ __forceinline__ void real_pack(float2 xk, float2 xj, float2 w,
                                          float2& zk, float2& zj) {
  // Xe = (X[k] + conj X[l-k]) / 2, Xo = (X[k] - conj X[l-k]) conj(w) / 2
  const float2 e = cscale(cadd(xk, conjf2(xj)), 0.5f);
  const float2 o = cscale(cmul(csub(xk, conjf2(xj)), conjf2(w)), 0.5f);
  zk = make_float2(e.x - o.y, e.y + o.x);  // Xe + i Xo
  zj = make_float2(e.x + o.y, o.x - e.y);  // conj Xe + i conj Xo
}

}  // namespace
