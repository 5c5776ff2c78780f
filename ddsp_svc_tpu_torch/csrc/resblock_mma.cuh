// The ResBlock1 convolution chain on a time tile held in shared memory, on
// the tensor cores: each conv is one implicit GEMM, M = C_out, K = k C_in,
// N = the tile's W columns, in mma.sync.m16n8k8 tf32 products with fp32
// accuracy (3xTF32, the sum re-accumulated in fp32). Used by the trio
// (resblocks.cu), one chain (resblock_chain.cu) and the whole stage
// (fused_stage.cu, whose transposed-conv fill runs on mma_k_step too).
//
// A block owns one (time tile, batch row) and holds two (C, S) fp32
// activation buffers in shared memory, the chain state h and the temporary
// t, for W = TILE + 2 * 64 columns (the 64-column halo covers the widest
// chain's receptive margin, 60) and 28 zero columns on each side, which
// every tap offset (5 d <= 28) stays within. Every conv output is zero
// past the sequence's (or the row's valid) length, so h stays zero there
// and no conv input needs a mask. Halo columns are recomputed by
// neighbouring tiles.
//
// The product. Each warp owns every output channel (C / 16 m16 tiles; C = 8
// pads M to 16 with zero weight rows) over a run of n8 tiles (5 at C = 64).
// A k-step is one tap and 8 input channels: its B fragment (b0: row
// lane % 4, column lane / 4; b1: row + 4) reads act[c_in, col + (tap -
// (k-1)/2) d] straight from the activation buffer, with no per-tap copy
// (wgmma would need one: its B operand starts on 8-row core matrices, and a
// tap shift of one column does not). The row stride S = W + 56 is 24
// (mod 32), so a B fragment's 32 reads hit 32 banks. Each operand x splits
// as hi = x rounded to tf32, lo = x - hi (exact in fp32; the tensor cores
// read its top 10 mantissa bits), and a k-step is three MMAs, a_lo b_hi +
// a_hi b_lo + a_hi b_hi, small terms first. A chunk of 4 k-steps (32
// products at C >= 32) accumulates in a fragment that starts at zero (its
// first MMA takes a zero C operand), which is then added to the running
// fp32 sum with plain FADDs: the tensor cores' own accumulation truncates.
// Against float64 at C = 64 (tools/ab_torch_trio.py), chunks of 4 read
// 6e-7 x max|ref|, as the fp32 cuDNN chain does; chunks of 1 read 3e-7 at
// ~7 % more time; no re-accumulation reads 9e-6 (2.6e-5 on inputs of
// 1e-3..1e3) at ~2 % less.
//
// The weights. The wrapper splits them into hi and lo and lays each conv
// out in fragment order (tap, C_in / 8, C_out / 16, hi | lo, lane, 4):
// a lane's A fragment is one 16-byte load. They stream through shared
// memory in 16 KB stages, double-buffered with cp.async under one barrier a
// stage, so that the next stage's L2 latency hides under this one's MMAs,
// and a k-step spends no instruction on splitting its weights.
//
// The budget at C = 64: 234 registers, no spills (running sum 80, chunk 80,
// A fragments 32); 225,280 bytes of shared memory. The trio mean is summed
// in the output itself (three read-modify-writes of the interior per
// tile): in registers it took 80 more and forced one-k-step chunks at 255
// registers with spills, which measured slower.
//
// The bf16-operand form (JAX's mxu_bf16=True: bf16 weights and conv inputs,
// fp32 accumulation, fp32 h and t). A k-step is one tap and 16 input
// channels in one mma.sync.m16n8k16 with bf16 operands and an fp32
// accumulator, which sums the exact products of bf16 operands; the chunks
// are re-accumulated in fp32 as above. The K order inside a k-step is
// permuted so that the B loads keep the tf32 form's bank pattern: MMA rows
// 2q, 2q + 1, 2q + 8, 2q + 9 (q = lane % 4) are input channels q, q + 4,
// q + 8, q + 12, and the wrapper lays the A fragments out in the same
// order (ops/kernels.py::mma_fragments_bf16: per k-step and m16 tile one
// 16-byte load a lane, the weights rounded once, a quarter of the tf32
// form's bytes). The B fragment packs two input channels with
// cvt.rn.bf16x2.f32 as it loads (round to nearest even, as astype). At C =
// 8 the k-step's upper 8 channels are zero weights and a zero B register.
//
// The epilogues (leaky and mask into t, the residual add into h, the trio
// mean) work on the fragment map: a thread holds channels 16 mt + lane / 4
// (+ 8) at columns 8 nt + 2 (lane % 4) (+ 1) of its warp's run. The
// residual epilogue writes exactly the h entries the thread reads into the
// mean, so that read needs no barrier.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rbmma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 64;
constexpr int kPad = 28;            // zero columns on each side of a buffer row
constexpr int kStageFloats = 4096;  // one weight stage, 16 KB
constexpr int kChunk = 4;           // k-steps re-accumulated at once

template <int C>
struct Geometry {
  static constexpr int kM = C < 16 ? 16 : C;      // output rows, padded to m16
  static constexpr int kMTiles = kM / 16;
  static constexpr int kGroups = C / 8;           // k8 groups of input channels
  // conv outputs each thread accumulates: 80, or 64 where a warp's run of
  // n8 tiles would otherwise need spills (C <= 16)
  static constexpr int kOuts = C >= 32 ? 80 : 64;
  static constexpr int W = kOuts * kThreads / kM;  // 320, 640, 1024, 1024
  static constexpr int kNTiles = W / 8 / kWarps;  // n8 tiles per warp
  static constexpr int kTile = W - 2 * kHalo;
  static constexpr int S = W + 2 * kPad;          // row stride, 24 (mod 32)
  static constexpr int kStepFloats = kMTiles * 256;  // A fragments of a k-step, hi and lo
  static constexpr int kStepsPerStage = kStageFloats / kStepFloats;
  static constexpr size_t kSmem = (2ull * C * S + 2ull * kStageFloats) * sizeof(float);
  static_assert(kNTiles * 8 * kWarps == W && S % 32 == 24, "tile geometry");
};

// The k-steps of one form: kMxu false the 3xTF32 form (8 input channels a
// k-step, hi and lo fragments), true the bf16-operand form (16 input
// channels a k-step, one packed bf16 fragment).
template <int C, bool kMxu>
struct Steps {
  static constexpr int kCh = kMxu ? 16 : 8;                     // input channels a k-step
  static constexpr int kGroups = kMxu ? (C < 16 ? 1 : C / 16) : C / 8;
  // 32-bit words of a k-step's A fragments, all m16 tiles
  static constexpr int kWords = Geometry<C>::kMTiles * (kMxu ? 128 : 256);
  static constexpr int kPerStage = kStageFloats / kWords;
  static_assert(kPerStage * kWords == kStageFloats, "stage geometry");
};

// 32-bit words of one conv's weights in fragment order: 2 k C M floats (hi
// and lo) for tf32, k max(C, 16) M / 2 for bf16.
template <int C, bool kMxu = false>
__host__ __device__ constexpr int conv_floats(int k) {
  return k * Steps<C, kMxu>::kGroups * Steps<C, kMxu>::kWords;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float leaky(float v) { return fmaxf(v, 0.1f * v); }

// An activation read from device memory, upcast exactly to fp32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x = hi + lo: hi is x rounded to tf32 (to nearest, ties away, as
// cvt.rna.tf32.f32, which sm_90 runs as four instructions), lo the exact
// rest, whose low 13 bits the tensor cores drop.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = a b + c on one m16n8k8 tile.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// A thread's share of a (C, W) conv output in the fragment map.
template <int C>
using Frags = float[Geometry<C>::kMTiles][Geometry<C>::kNTiles][4];

// This thread's first column (fragment element 0 of n tile 0) and first
// output channel (element 0 of m tile 0).
template <int C>
__device__ __forceinline__ int frag_col0() {
  return (threadIdx.x >> 5) * Geometry<C>::kNTiles * 8 + 2 * (threadIdx.x & 3);
}

__device__ __forceinline__ int frag_row0() { return (threadIdx.x & 31) >> 2; }

// One k-step (a tap and 8 input channels) of 3xTF32 products into part,
// which starts at zero if kZero. a: this lane's A fragments of the k-step
// (m tile mt: hi at a + 256 mt, lo at + 128); b: this lane's B values of n
// tile nt at b[8 nt] and b[4 S + 8 nt], leaky'd first if kLeaky.
template <int C, bool kLeaky, bool kZero>
__device__ __forceinline__ void mma_k_step(Frags<C>& part, const float* a, const float* b) {
  using G = Geometry<C>;
  constexpr int kMT = G::kMTiles, kNT = G::kNTiles;
  uint32_t a_hi[kMT][4], a_lo[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const uint4 hi = *reinterpret_cast<const uint4*>(a + mt * 256);
    const uint4 lo = *reinterpret_cast<const uint4*>(a + mt * 256 + 128);
    a_hi[mt][0] = hi.x, a_hi[mt][1] = hi.y, a_hi[mt][2] = hi.z, a_hi[mt][3] = hi.w;
    a_lo[mt][0] = lo.x, a_lo[mt][1] = lo.y, a_lo[mt][2] = lo.z, a_lo[mt][3] = lo.w;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float v0 = b[nt * 8], v1 = b[4 * G::S + nt * 8];
    if (kLeaky) {
      v0 = leaky(v0);
      v1 = leaky(v1);
    }
    uint32_t b_hi[2], b_lo[2];
    split_tf32(v0, b_hi[0], b_lo[0]);
    split_tf32(v1, b_hi[1], b_lo[1]);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (kZero) {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part[mt][nt], a_lo[mt], b_hi, zero);
      } else {
        mma_tf32(part[mt][nt], a_lo[mt], b_hi, part[mt][nt]);
      }
      mma_tf32(part[mt][nt], a_hi[mt], b_lo, part[mt][nt]);
      mma_tf32(part[mt][nt], a_hi[mt], b_hi, part[mt][nt]);
    }
  }
}

// Two fp32 values rounded to bf16 (to nearest even) and packed: lo in the
// low half, hi in the high half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d = a b + c on one m16n8k16 tile, bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// One k-step of the bf16-operand form (a tap and 16 input channels) into
// part, which starts at zero if kZero. a: this lane's packed A fragment of
// m tile mt at a + 128 mt; b: this lane's B values of n tile nt at b[8 nt]
// (channel q), b[4 S + 8 nt] (q + 4), b[8 S + 8 nt] (q + 8) and b[12 S +
// 8 nt] (q + 12), leaky'd first if kLeaky, each rounded to bf16.
template <int C, bool kLeaky, bool kZero>
__device__ __forceinline__ void mma_k_step_bf16(Frags<C>& part, const float* a,
                                                const float* b) {
  using G = Geometry<C>;
  constexpr int kMT = G::kMTiles, kNT = G::kNTiles;
  uint32_t af[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + mt * 128);
    af[mt][0] = v.x, af[mt][1] = v.y, af[mt][2] = v.z, af[mt][3] = v.w;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    float v0 = b[nt * 8], v1 = b[4 * G::S + nt * 8];
    float v2 = 0.f, v3 = 0.f;
    if (C >= 16) {
      v2 = b[8 * G::S + nt * 8];
      v3 = b[12 * G::S + nt * 8];
    }
    if (kLeaky) {
      v0 = leaky(v0);
      v1 = leaky(v1);
      v2 = leaky(v2);
      v3 = leaky(v3);
    }
    const uint32_t bf[2] = {pack_bf16x2(v0, v1), C >= 16 ? pack_bf16x2(v2, v3) : 0u};
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (kZero) {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(part[mt][nt], af[mt], bf, zero);
      } else {
        mma_bf16(part[mt][nt], af[mt], bf, part[mt][nt]);
      }
    }
  }
}

// The fp32 re-accumulation of a chunk: acc += part.
template <int C>
__device__ __forceinline__ void add_frags(Frags<C>& acc, const Frags<C>& part) {
#pragma unroll
  for (int mt = 0; mt < Geometry<C>::kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < Geometry<C>::kNTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

// Zero all of t, pads included, and the pads of h: no conv writes a pad
// column.
template <int C>
__device__ void zero_buffers(float* h, float* t) {
  using G = Geometry<C>;
  constexpr int kPads = G::S - G::W;
  for (int i = threadIdx.x; i < C * G::S; i += kThreads) t[i] = 0.f;
  for (int i = threadIdx.x; i < C * kPads; i += kThreads) {
    const int r = i / kPads, c = i % kPads;
    h[r * G::S + (c < kPad ? c : G::W + c)] = 0.f;
  }
}

// One conv over the tile, all W columns. conv1 (kFirst) reads leaky(src)
// and stores leaky(conv) * mask into dst; conv2 reads src as it is and adds
// conv * mask into dst (the residual). w: the conv's weights in fragment
// order (kMxu: the bf16-operand form's); s_w: two weight stages; g0:
// sequence index of column 0; limit: the length.
template <int C, int K, bool kFirst, bool kMxu = false>
__device__ __forceinline__ void conv_pass(const float* src, float* dst,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, float* s_w, int d,
                                          int g0, int limit) {
  using G = Geometry<C>;
  using O = Steps<C, kMxu>;
  constexpr int kMT = G::kMTiles, kNT = G::kNTiles;
  constexpr int kSteps = K * O::kGroups;
  constexpr int kStages = (kSteps + O::kPerStage - 1) / O::kPerStage;
  const int lane = threadIdx.x & 31;
  const int row0 = frag_row0(), col0 = frag_col0<C>();

  auto stage = [&](int s) {
    const int n = min(O::kPerStage, kSteps - s * O::kPerStage) * O::kWords;
    const float* gw = w + (size_t)s * kStageFloats;
    float* sw = s_w + (s & 1) * kStageFloats;
    for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) cp_async16(sw + i, gw + i);
    cp_async_commit();
  };

  Frags<C> acc, part;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int r = mt * 16 + row0;
    const float b0 = bias[r], b1 = (C >= 16) ? bias[r + 8] : 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = b0;
      acc[mt][nt][2] = acc[mt][nt][3] = b1;
    }
  }
  // B fragment rows: input channels lane % 4 and + 4 of a k8 group, column
  // lane / 4 of an n8 tile
  const float* src_lane = src + (lane & 3) * G::S + kPad + (col0 - 2 * (lane & 3)) + row0;

  // k-step `step` (its A fragments at sw_step) into part; the first of a
  // chunk starts part at zero
  auto k_step = [&](int step, const float* sw_step, auto zero_start) {
    const int tap = step / O::kGroups, grp = step % O::kGroups;
    const float* b = src_lane + grp * O::kCh * G::S + (tap - (K - 1) / 2) * d;
    if constexpr (kMxu) {
      mma_k_step_bf16<C, kFirst, decltype(zero_start)::value>(part, sw_step, b);
    } else {
      mma_k_step<C, kFirst, decltype(zero_start)::value>(part, sw_step, b);
    }
  };

  stage(0);
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    cp_async_wait<0>();
    // stage s is in for every thread, and every warp is done with stage s - 1,
    // whose buffer stage s + 1 takes
    __syncthreads();
    if (s + 1 < kStages) stage(s + 1);
    const float* sw = s_w + (s & 1) * kStageFloats + lane * 4;
    const int steps = min(O::kPerStage, kSteps - s * O::kPerStage);
#pragma unroll 1
    for (int j0 = 0; j0 < steps; j0 += kChunk) {
      const int step0 = s * O::kPerStage + j0;
      k_step(step0, sw + j0 * O::kWords, std::true_type{});
#pragma unroll 1
      for (int j = j0 + 1; j < min(j0 + kChunk, steps); ++j)
        k_step(step0 + j - j0, sw + j * O::kWords, std::false_type{});
      add_frags<C>(acc, part);
    }
  }

#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = col0 + nt * 8;
    const int g = g0 + col;
    const bool in0 = g >= 0 && g < limit, in1 = g + 1 >= 0 && g + 1 < limit;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (C < 16 && half == 1) continue;  // padded rows
        float2* p = reinterpret_cast<float2*>(dst + (mt * 16 + row0 + 8 * half) * G::S +
                                              kPad + col);
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (kFirst) {
          *p = make_float2(in0 ? leaky(v0) : 0.f, in1 ? leaky(v1) : 0.f);
        } else {
          float2 o = *p;
          if (in0) o.x += v0;
          if (in1) o.y += v1;
          *p = o;
        }
      }
    }
  }
}

// One ResBlock1 chain on h (t is its temporary): for each of the three
// dilations, h += conv_k(leaky(conv_k,d(leaky(h)))). w: the chain's six
// convs in fragment order (kMxu: the bf16-operand form's); b: (3, 2, C).
template <int C, int K, bool kMxu = false>
__device__ void run_chain(float* h, float* t, float* s_w, const float* w, const float* b,
                          int d0, int d1, int d2, int g0, int limit) {
  constexpr int kConv = conv_floats<C, kMxu>(K);
  for (int i = 0; i < 3; ++i) {
    conv_pass<C, K, true, kMxu>(h, t, w + (size_t)(2 * i) * kConv, b + 2 * i * C, s_w,
                                i == 0 ? d0 : i == 1 ? d1 : d2, g0, limit);
    __syncthreads();
    conv_pass<C, K, false, kMxu>(t, h, w + (size_t)(2 * i + 1) * kConv, b + (2 * i + 1) * C,
                                 s_w, 1, g0, limit);
    __syncthreads();
  }
}

// op(&out[c, g], h[c, col]) at this thread's interior columns (not halo)
// inside [0, T), in the fragment map. Each thread reads the h entries its
// own conv2 epilogue wrote, so no barrier is needed after the chain, and the
// out entries it wrote itself. out: (C, T) of this batch row.
template <int C, typename Op>
__device__ __forceinline__ void for_own_interior(const float* h, float* out, int g0, int T,
                                                 Op op) {
  using G = Geometry<C>;
  const int row0 = frag_row0(), col0 = frag_col0<C>();
#pragma unroll
  for (int nt = 0; nt < G::kNTiles; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + nt * 8 + e;
      const int g = g0 + col;
      if (col < kHalo || col >= kHalo + G::kTile || g >= T) continue;
#pragma unroll
      for (int mt = 0; mt < G::kMTiles; ++mt)
#pragma unroll
        for (int half = 0; half < (C < 16 ? 1 : 2); ++half) {
          const int c = mt * 16 + row0 + 8 * half;
          op(out + (size_t)c * T + g, h[c * G::S + kPad + col]);
        }
    }
}

// The chain's result: out = h on the tile's interior.
template <int C>
__device__ __forceinline__ void store_interior(const float* h, float* out, int g0, int T) {
  for_own_interior<C>(h, out, g0, T, [](float* o, float v) { *o = v; });
}

// The trio mean in the output: out = h after chain 0, += h after chain 1,
// = (out + h) / 3 after chain 2.
template <int C>
__device__ __forceinline__ void accumulate_mean(const float* h, float* out, int chain, int g0,
                                                int T) {
  for_own_interior<C>(h, out, g0, T, [chain](float* o, float v) {
    *o = chain == 0 ? v : chain == 1 ? *o + v : (*o + v) * (1.0f / 3.0f);
  });
}

// h = x0 = x + noise_conv(har) over the tile (har == nullptr: x alone), zero
// outside [0, limit). noise_conv is the Generator's f0-source injection
// conv: kernel ksrc (2 s_src, or 1), stride s_src, padding s_src / 2, over
// har (T_final,), weights wnc (C, ksrc) and bnc (C,). Each thread takes one
// column and a group of channels, so that it reads the column's window of
// har once for the group, 8 taps at a time. x: (C, T) of this batch row. x
// and har are fp32 or bf16 (XT, HT), each upcast exactly on its load: the
// tile and everything after it are fp32.
template <int C, typename XT, typename HT>
__device__ void fill_x0(float* h, const XT* x, const HT* har, const float* wnc,
                        const float* bnc, int T, int t_final, int s_src, int ksrc, int g0,
                        int limit) {
  using G = Geometry<C>;
  constexpr int kParts = G::W % kThreads == 0 ? 1 : G::W % (kThreads / 2) == 0 ? 2 : 4;
  constexpr int kCh = C / kParts, kWin = 8;
  static_assert((G::W * kParts) % kThreads == 0 && C % kParts == 0, "fill split");
  for (int i = threadIdx.x; i < G::W * kParts; i += kThreads) {
    const int col = i % G::W, c0 = (i / G::W) * kCh;
    const int g = g0 + col;
    float* hc = h + c0 * G::S + kPad + col;
    if (g < 0 || g >= limit) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) hc[c * G::S] = 0.f;
      continue;
    }
    float sum[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) sum[c] = 0.f;
    if (har != nullptr) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) sum[c] = bnc[c0 + c];
      const int h0 = g * s_src - s_src / 2;
      for (int t0 = 0; t0 < ksrc; t0 += kWin) {
        float win[kWin];
#pragma unroll
        for (int tau = 0; tau < kWin; ++tau) {
          const int hi = h0 + t0 + tau;
          win[tau] = t0 + tau < ksrc && hi >= 0 && hi < t_final ? to_f32(har[hi]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const float* wc = wnc + (c0 + c) * ksrc + t0;
#pragma unroll
          for (int tau = 0; tau < kWin; ++tau)
            if (t0 + tau < ksrc) sum[c] = fmaf(wc[tau], win[tau], sum[c]);
        }
      }
    }
    const XT* xc = x + (size_t)c0 * T + g;
#pragma unroll
    for (int c = 0; c < kCh; ++c) hc[c * G::S] = har != nullptr ? to_f32(xc[(size_t)c * T]) + sum[c]
                                                                : to_f32(xc[(size_t)c * T]);
  }
}

template <int C, typename Kernel, typename Args>
int launch_tiles(Kernel kernel, const Args& a, int T, int B, cudaStream_t stream) {
  using G = Geometry<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + G::kTile - 1) / G::kTile, B);
  kernel<<<grid, kThreads, G::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The compiled kernel at width C: out[0] registers per thread, out[1]
// local-memory bytes per thread (spills), out[2] dynamic shared memory per
// block.
template <int C, typename Kernel>
int kernel_info(Kernel kernel, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)Geometry<C>::kSmem;
  return (int)err;
}

}  // namespace rbmma
