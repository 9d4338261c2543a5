// Tensor-core pieces of both kernels: a 3x3 convolution over a
// shared-memory region as an implicit GEMM on Hopper's warp-level mma.sync,
// in two forms. On 2-byte operands (this comment): mma.sync.m16n8k16 on f16
// or bf16 activations, with P products per fragment, f32-grade under the f16
// storage tier (fasthi16, P = 2) and exact under the 2-byte tiers (fast16,
// fast, P = 1). Under the f32 and bf16 storage tiers with f32 weights
// (parity, high, mixed, fasthi): mma.sync.m16n8k8 on split TF32 operands
// (the second half of the file, "split TF32"). Then what the kernels use to
// fill that region (Tile, Walk, load_window_2byte, load_window_f32).
//
// P = 2, split f16 (fasthi16). Every activation is an exact f16 value; only
// the weights are f32. The host splits each weight once
// (ops/kernels/conv_chain.py split_f16): with a power-of-two scale S per
// output channel that brings the channel's largest |w| into [2^13, 2^14),
//     w_hi = f16(w*S),   w_lo = f16((w*S - w_hi) * 2^11),
// so w*S = w_hi + w_lo*2^-11 to about 2^-22 relative. The kernel runs two
// MMAs per fragment, x*w_hi and x*w_lo, into two f32 accumulator sets; each
// product of two f16 values is exact in f32, so all rounding is in the f32
// accumulation, as in any f32 convolution. The epilogue forms
//     (acc_hi + acc_lo*2^-11) / S + bias.
// P = 1, one product (fast16: f16, fast: bf16). The weights themselves are
// 2-byte under these tiers: the host packs each one once, rounded to T
// (ops/kernels/conv_chain.py pack_chain_2byte), with S = 1, which the
// epilogue does not read. The product of two values of T is exact in f32,
// so one MMA per fragment into one accumulator set gives the unfused
// graph's f32 sum of the exact products; the epilogue rounds it to T, adds
// the bias (rounded to T on the host) and the store rounds again (R2: two
// roundings, as ops/nn.py conv2d computes a 2-byte contraction's output).
//
// GEMM shape. M = pixels, N = output channels in n-tiles of 8, K = 9 taps x
// input channels in k-chunks of 16 (pad channels are zero in shared memory
// and in the packed weights). The stage is computed over the INPUT's row
// pitch: output index p = r*wi + c for every c < wi, so the input pixel of
// tap (ky, kx) is p + ky*wi + kx, a constant offset, and an m-tile of 16
// consecutive p is 16 fragment rows at a constant stride even across row
// ends. The two columns c >= wi-2 of each row are garbage that the
// epilogue drops. The last m-tile reads up to kOverrun pixels past its
// region; the caller lays its buffers out so that those reads stay inside
// the allocation (they feed only dropped rows).
//
// Shared-memory layouts, both free of bank conflicts.
// Activations: T, channels in order, `sw` 32-bit words per pixel with
// sw = 4 (mod 8), so that the eight 16-byte rows of each 8x8 matrix that
// ldmatrix reads lie in eight different bank groups. One ldmatrix.x4 gives
// a lane the four A registers of an m-tile and a k-chunk (ldmatrix moves
// 16-bit values, whatever their type).
// Weights: in fragment order [ky][kx][k-chunk][n-tile][lane][2P words]:
// lane (g, t) finds {b0, b1} of each term of output channel 8*ntile + g as
// one 64-bit (P = 1) or 128-bit (P = 2: hi b0, hi b1, lo b0, lo b1) load,
// b0 = k 2t..2t+1, b1 = k 2t+8..2t+9.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace esr {

constexpr int kWarps = kThreads / 32;
// m-tiles (16 pixels each) one warp accumulates at once on the m16n8k16
// path: P = 2 holds 2 sets of them, P = 1 one (4 measured no faster than 3
// on the chain, PERF.md)
constexpr int kMT = 3;
constexpr int kMT1 = 3;
constexpr int kNtChunk = 6;  // n-tiles (8 channels each) one warp accumulates at once
constexpr int kOverrun = 15;  // pixels past a region's end that its last m-tile may read

__host__ __device__ constexpr int mtiles(int P) { return P == 2 ? kMT : kMT1; }
__host__ __device__ inline int kchunks(int cin) { return cdiv(cin, 16); }
__host__ __device__ inline int ntiles(int cout) { return cdiv(cout, 8); }
// 16-byte units of one n-tile's B fragments at one k-step: 32 lanes x P terms x 8 bytes
__host__ __device__ constexpr int frag_units(int P) { return 16 * P; }
// The m16n8k16 kernels' products a fragment for the C entry points' dtype
// (1 half, 2 bfloat16) and fast flag: 2 for f16 activations with f32
// weights (fasthi16), 1 for 2-byte weights (fast16, fast); 0: the
// split-TF32 kernels take the call
inline int mma_products(int dtype, int fast) { return fast ? 1 : dtype == 1 ? 2 : 0; }

// 32-bit words per pixel for up to `c` channels: whole k-chunks, and
// 4 (mod 8) for ldmatrix (a multiple of 4 keeps every row 16-byte aligned)
__host__ __device__ inline int pixel_words(int c) { return kchunks(c) * 8 + 4; }

// Saturate at +-65504, f16's largest value, instead of inf on the store;
// NaN stays NaN, as in torch.clamp.
__device__ inline float clamp_f16_range(float v) {
  asm("max.NaN.f32 %0, %0, 0fC77FE000;\n\tmin.NaN.f32 %0, %0, 0f477FE000;\n" : "+f"(v));
  return v;
}

// The 2-byte operand types of the m16n8k16 path: their pairs, roundings,
// the store's saturation (f16 saturates as ops/nn.py store_out does; bf16,
// with f32's range, does not) and the MMA with f32 accumulation.
template <typename T> struct Op2;

template <> struct Op2<__half> {
  using T2 = __half2;
  static __device__ T2 pack(float a, float b) { return __floats2half2_rn(a, b); }
  static __device__ T2 splat(float v) { return __float2half2_rn(v); }
  static __device__ float2 unpack(T2 v) { return __half22float2(v); }
  static __device__ float rn(float v) { return __half2float(__float2half_rn(v)); }
  static __device__ float sat(float v) { return clamp_f16_range(v); }
  static __device__ float from_bits(unsigned short b) { return __half2float(__ushort_as_half(b)); }
  static __device__ unsigned short to_bits(float v) { return __half_as_ushort(__float2half_rn(v)); }
  static __device__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Op2<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ T2 pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
  static __device__ T2 splat(float v) { return __float2bfloat162_rn(v); }
  static __device__ float2 unpack(T2 v) { return __bfloat1622float2(v); }
  static __device__ float rn(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ float sat(float v) { return v; }
  static __device__ float from_bits(unsigned short b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ unsigned short to_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  static __device__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// One lane's B fragments of one n-tile at one k-step: {b0, b1} of each term
template <int P>
using Frag = typename std::conditional<P == 2, uint4, uint2>::type;

// The A fragment of one m-tile and k-chunk: four 8x8 matrices of 16-bit
// values, (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15). Lane l gives the shared-memory address of row l % 8
// of matrix l / 8.
__device__ inline void ldmatrix_x4(uint32_t (&a)[4], const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s)
               : "memory");
}

// The P MMAs of one m-tile and n-tile at one k-step, into acc[0] (and the
// lo terms into acc[1])
template <typename T, int P>
__device__ inline void mma_terms(float (&d0)[4], float (&d1)[4], const uint32_t (&a)[4],
                                 const Frag<P>& b) {
  Op2<T>::mma(d0, a, b.x, b.y);
  if constexpr (P == 2) Op2<T>::mma(d1, a, b.z, b.w);
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The whole block copies n16 16-byte units from device to shared memory
// without waiting; cp_async_wait_all() + __syncthreads() make them visible.
__device__ inline void stage_weights_async(uint4* dst, const uint4* __restrict__ src, int n16) {
  for (int i = threadIdx.x; i < n16; i += blockDim.x) cp_async16(dst + i, src + i);
}

// The m16n8k16 path's epilogue for one value, before the store's rounding
// to T, from the sums of this value's terms (lo unused under P = 1).
// P = 2: (acc_hi + acc_lo * 2^-11) / S + bias, as one f32 conv. P = 1: the
// sum itself (S = 1). R2 (fast16, fast): the sum rounded to T first (inf
// where f16 overflows) and the bias, rounded to T on the host, added after.
// f16 saturates at +-65504 after the add, as ops/nn.py store_out follows
// it; bf16 does not saturate.
template <typename T, int P, bool R2>
__device__ inline float epilogue_value(float hi, float lo, float inv_s, float b) {
  const float sum = P == 2 ? fmaf(lo, 1.f / 2048.f, hi) * inv_s : hi;
  return Op2<T>::sat(R2 ? Op2<T>::rn(sum) + b : sum + b);
}

// One kernel row (three taps) of a 3x3 convolution for `cnt` <= MT m-tiles
// of one warp and `ntl` <= NT n-tiles, accumulated into acc (P sets).
//   a    : this lane's ldmatrix row: the word of shared activations at pixel
//          (first output index of the first m-tile + ky*wi + lane % 16),
//          plus 4 * (lane / 16) words
//   sw   : words per pixel; kc_n: k-chunks of the input
//   wrow : this kernel row's staged weights [kx][kc][ntl][32 lanes], plus lane
// cnt and ntl must be the same for all lanes of the warp.
template <typename T, int P, int MT, int NT>
__device__ inline void mma_conv_row(float (&acc)[P][MT][NT][4], const uint32_t* a, int sw,
                                    int kc_n, int cnt, int ntl, const Frag<P>* wrow) {
  for (int kx = 0; kx < 3; ++kx) {
    for (int kc = 0; kc < kc_n; ++kc) {
      uint32_t fr[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < cnt) ldmatrix_x4(fr[m], a + (m * 16 + kx) * sw + kc * 8);
      const Frag<P>* wp = wrow + (kx * kc_n + kc) * ntl * 32;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n < ntl) {
          const Frag<P> b = wp[n * 32];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            if (m < cnt) mma_terms<T, P>(acc[0][m][n], acc[P - 1][m][n], fr[m], b);
        }
      }
    }
  }
}

// The same for exactly CNT m-tiles and ntl == NT, both known at compile
// time: straight code without predicates (a predicated mma.sync costs a
// warp synchronisation each), with the loads one step ahead of the MMAs:
// the B fragment of the next n-tile is loaded before this n-tile's MMAs,
// and the next k-step's A fragments before the last n-tile's. KC > 0: the
// input has exactly KC k-chunks, and the whole row is unrolled, so that the
// compiler schedules loads across k-steps and folds the addresses; KC = 0:
// any number (kc_n), as a loop. `mid()` is called once, after the first
// k-step: the place for work that should be issued under running MMAs
// (the caller's fetch of the next weights). NTL < NT: a chunk of only NTL
// n-tiles (the last of a channel group in tail.cu), into acc's first NTL.
template <typename T, int P, int CNT, int KC, int MT, int NT, int NTL = NT, typename Mid>
__device__ inline void mma_conv_row_full(float (&acc)[P][MT][NT][4], const uint32_t* a, int sw,
                                         int kc_n, const Frag<P>* wrow, Mid& mid) {
  static_assert(CNT >= 1 && CNT <= MT, "m-tiles of one warp");
  static_assert(NTL >= 1 && NTL <= NT, "n-tiles of the chunk");
  if (KC > 0) kc_n = KC;
  const int steps = 3 * kc_n;  // k-steps in the order of the staged weights: [kx][kc]
  uint32_t fr[CNT][4], fr_next[CNT][4];
#pragma unroll
  for (int m = 0; m < CNT; ++m) ldmatrix_x4(fr[m], a + m * 16 * sw);
  Frag<P> b = wrow[0];
  int kc = 0;
#pragma unroll(KC > 0 ? 3 * KC : 1)
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    // the next k-step's activations: the next k-chunk, or the next tap's first
    if (++kc == kc_n) {
      kc = 0;
      a += sw - (kc_n - 1) * 8;
    } else {
      a += 8;
    }
#pragma unroll
    for (int n = 0; n < NTL; ++n) {
      Frag<P> b_next = b;
      if (n + 1 < NTL || more) b_next = wrow[(s * NTL + n + 1) * 32];
      if (n == NTL - 1 && more) {
#pragma unroll
        for (int m = 0; m < CNT; ++m) ldmatrix_x4(fr_next[m], a + m * 16 * sw);
      }
#pragma unroll
      for (int m = 0; m < CNT; ++m) mma_terms<T, P>(acc[0][m][n], acc[P - 1][m][n], fr[m], b);
      b = b_next;
    }
#pragma unroll
    for (int m = 0; m < CNT; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) fr[m][i] = fr_next[m][i];
    if (s == 0) mid();
  }
}

// One kernel row for cnt <= MT m-tiles of the warp and ntl <= NT n-tiles
// (both the same in all its lanes): straight code for each count where the
// chunk has NT n-tiles, unrolled at 3 k-chunks (RLFN's 46 and 48 channels
// in), a k-chunk loop at other widths; predicated code where the chunk has
// fewer n-tiles. `mid()` runs once in every case (before the predicated
// code's MMAs).
template <typename T, int P, int CNT, int MT, int NT, typename Mid>
__device__ inline void mma_conv_row_any(float (&acc)[P][MT][NT][4], const uint32_t* a, int sw,
                                        int kc_n, int cnt, int ntl, const Frag<P>* wrow,
                                        Mid& mid) {
  if constexpr (CNT == MT) {
    if (ntl != NT || cnt == 0) {
      mid();
      mma_conv_row<T, P>(acc, a, sw, kc_n, cnt, ntl, wrow);
      return;
    }
  }
  if constexpr (CNT > 1) {
    if (cnt < CNT) {
      mma_conv_row_any<T, P, CNT - 1>(acc, a, sw, kc_n, cnt, ntl, wrow, mid);
      return;
    }
  }
  if (kc_n == 3)
    mma_conv_row_full<T, P, CNT, 3>(acc, a, sw, 3, wrow, mid);
  else
    mma_conv_row_full<T, P, CNT, 0>(acc, a, sw, kc_n, wrow, mid);
}

// mma_conv_row_any for the chunks of a channel group (tail.cu's grouped
// plans), whose last chunk may hold fewer than NT n-tiles (a group of 7 or
// 8 leaves 1 or 2, a group of 4 has 4): straight code for those counts too,
// the predicated row only for the others.
template <typename T, int P, int CNT, int MT, int NT, typename Mid>
__device__ inline void mma_conv_row_part(float (&acc)[P][MT][NT][4], const uint32_t* a, int sw,
                                         int kc_n, int cnt, int ntl, const Frag<P>* wrow,
                                         Mid& mid) {
  if constexpr (CNT > 1) {
    if (cnt < CNT) {
      mma_conv_row_part<T, P, CNT - 1>(acc, a, sw, kc_n, cnt, ntl, wrow, mid);
      return;
    }
  }
  if (ntl == 1) {
    mma_conv_row_full<T, P, CNT, 0, MT, NT, 1>(acc, a, sw, kc_n, wrow, mid);
  } else if (ntl == 2) {
    mma_conv_row_full<T, P, CNT, 0, MT, NT, 2>(acc, a, sw, kc_n, wrow, mid);
  } else if (ntl == 4) {
    mma_conv_row_full<T, P, CNT, 0, MT, NT, 4>(acc, a, sw, kc_n, wrow, mid);
  } else {
    mid();
    mma_conv_row<T, P>(acc, a, sw, kc_n, cnt, ntl, wrow);
  }
}

template <typename T, int P, int MT, int NT, typename Mid>
__device__ inline void mma_conv_row_group(float (&acc)[P][MT][NT][4], const uint32_t* a, int sw,
                                          int kc_n, int cnt, int ntl, const Frag<P>* wrow,
                                          Mid& mid) {
  if (ntl == NT || cnt == 0)
    mma_conv_row_any<T, P, MT>(acc, a, sw, kc_n, cnt, ntl, wrow, mid);
  else
    mma_conv_row_part<T, P, MT>(acc, a, sw, kc_n, cnt, ntl, wrow, mid);
}

// ---- split TF32: f32 and bf16 activations ------------------------------
//
// Under parity, high and mixed the activations are f32 and under fasthi
// bf16, while the weights are f32. TF32 keeps f32's exponent range
// and 11 significant bits, and the product of two TF32 values is exact in
// f32. The host splits each weight once (ops/kernels/conv_chain.py
// split_tf32), w_hi = rna_tf32(w), w_lo = rna_tf32(w - w_hi), so that
// w = w_hi + w_lo to about 2^-22 relative; no scale is needed. The kernel
// splits each f32 activation in registers the same way (cvt.rna.tf32.f32:
// the tensor cores ignore the low 13 bits of an operand, so both terms are
// rounded explicitly), and runs P products per weight fragment:
//   P = 3 (f32 activations): a_hi*w_hi, a_hi*w_lo, a_lo*w_hi, which leave
//         out about 2^-22 relative of a*w;
//   P = 2 (bf16 activations): a bf16 value is an exact TF32 value, so
//         a_lo = 0 and a*w_hi, a*w_lo suffice;
//   P = 1: a*w_hi alone, which no tier launches: the control of
//         ntire2022_esr_tpu_torch/tools/chain_check.py --one-product, which
//         fasthi's flip bar must catch.
// Accumulation. The tensor cores add into an f32 accumulator with
// truncation, not rounding to nearest, so a sum taken by the MMAs alone over
// a whole stage (54 k-steps at 48 channels) drifts toward zero: hi and lo
// sets over the whole stage measured 4.0x cuDNN f32's error against an f64
// chain (PERF.md). So each tap's products go into fresh accumulators,
// all P into one set, and each tap's set is added to the running sums with
// f32 adds, rounded to nearest: 6 truncating k-steps a tap at 48 channels
// (a model of truncating accumulation at 432 products,
// tools/accumulation_model.py, puts this at 0.65-0.91x the error of an f32
// FMA chain, hi/lo sets at 1.93-2.02x). The epilogue forms sum + bias.
// The activations are finite under every tier that takes this path: an
// infinite one would give a - a_hi = NaN.
//
// GEMM shape as above, K in k-chunks of 16 channels, each two k-steps of 8.
// A fragment of m16n8k8.tf32: lane (g, t) holds rows g and g+8 at k = t and
// k = t+4. The k order within a k-chunk is permuted (the packed weights
// follow it): k-step s takes k = t from channel 4t+2s and k = t+4 from
// channel 4t+2s+1, so that one 16-byte load per row gives a lane both
// k-steps' values of that row: channels 4t..4t+3.
// Shared-memory layouts, both free of bank conflicts.
// Activations: f32, channels in order, `sw` words per pixel with
// sw = 16 (mod 32): a quarter warp's 16-byte loads (lanes 0-7: rows g and
// g+1, 16 words each) then cover the 32 banks once.
// Weights: in fragment order [tap][k-chunk][n-tile][hi, lo][lane][4 words]:
// lane (g, t) finds w[8*ntile + g][16*kc + 4t + j], j = 0..3, of the hi and
// of the lo terms as two 128-bit loads 512 bytes apart.

constexpr int kMT32 = 2;  // m-tiles one warp accumulates at once on the split-TF32 path

// 32-bit words per pixel of an f32 buffer for up to `c` channels: whole
// k-chunks of 16, and 16 (mod 32)
__host__ __device__ inline int pixel_words_f32(int c) {
  const int w = kchunks(c) * 16;
  return (w & 16) ? w : w + 16;
}

__device__ inline uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ inline void mma_m16n8k8_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One tap of a 3x3 convolution on split TF32 for CNT m-tiles of one warp
// and the n-tiles of one chunk: its products summed by the MMAs from zero,
// then added to `sum` (f32 adds, rounded to nearest).
//   a   : this lane's word of shared activations at pixel (first output
//         index of the first m-tile + the tap's offset + g), channel 4t
//   sw  : words per pixel; kc_n: k-chunks of the input (KC > 0: exactly KC,
//         and the k-chunks are unrolled)
//   wt  : this tap's staged weights [k-chunk][ntl][hi, lo][32 lanes], plus lane
//   FULL: cnt == CNT and ntl == NT, known at compile time (no predicates);
//         otherwise CNT == MT and only m < cnt, n < ntl run.
// cnt and ntl must be the same for all lanes of the warp.
template <int P, int CNT, int KC, bool FULL, int MT, int NT>
__device__ inline void mma_tap_tf32(float (&sum)[MT][NT][4], const float* a, int sw, int kc_n,
                                    int cnt, int ntl, const uint4* wt) {
  static_assert(P >= 1 && P <= 3, "1, 2 or 3 products");
  static_assert(CNT >= 1 && CNT <= MT, "m-tiles of one warp");
  if (KC > 0) kc_n = KC;
  if (FULL) {
    cnt = CNT;
    ntl = NT;
  }
  float acc[CNT][NT][4];
#pragma unroll
  for (int m = 0; m < CNT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  // this lane's activations of rows g and g+8, channels 4t..4t+3 of a
  // k-chunk: loaded one k-chunk ahead of the MMAs that use them
  float4 u[CNT], v[CNT];
#pragma unroll
  for (int m = 0; m < CNT; ++m) {
    if (FULL || m < cnt) {
      u[m] = *reinterpret_cast<const float4*>(a + m * 16 * sw);
      v[m] = *reinterpret_cast<const float4*>(a + (m * 16 + 8) * sw);
    }
  }
#pragma unroll(KC > 0 ? KC : 1)
  for (int kc = 0; kc < kc_n; ++kc) {
    // [m][row g: channels 4t..4t+3, row g+8: the same], split
    uint32_t ah[CNT][8], al[CNT][8];
#pragma unroll
    for (int m = 0; m < CNT; ++m) {
      if (FULL || m < cnt) {
        const float raw[8] = {u[m].x, u[m].y, u[m].z, u[m].w, v[m].x, v[m].y, v[m].z, v[m].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (P <= 2) {
            ah[m][i] = __float_as_uint(raw[i]);  // exact bf16 values: valid TF32
          } else {
            ah[m][i] = tf32_rna(raw[i]);
            al[m][i] = tf32_rna(raw[i] - __uint_as_float(ah[m][i]));
          }
        }
        if (kc + 1 < kc_n) {
          u[m] = *reinterpret_cast<const float4*>(a + m * 16 * sw + (kc + 1) * 16);
          v[m] = *reinterpret_cast<const float4*>(a + (m * 16 + 8) * sw + (kc + 1) * 16);
        }
      }
    }
    const uint4* wk = wt + kc * ntl * 64;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (FULL || n < ntl) {
        const uint4 bh = wk[n * 64], bl = wk[n * 64 + 32];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const uint32_t h0 = s ? bh.z : bh.x, h1 = s ? bh.w : bh.y;
          const uint32_t l0 = s ? bl.z : bl.x, l1 = s ? bl.w : bl.y;
#pragma unroll
          for (int m = 0; m < CNT; ++m) {
            if (FULL || m < cnt) {
              // rows g, g+8 at k = t (channel 4t+2s), then at k = t+4 (4t+2s+1)
              const uint32_t* x = ah[m];
              const uint32_t x0 = x[2 * s], x1 = x[4 + 2 * s], x2 = x[2 * s + 1], x3 = x[5 + 2 * s];
              mma_m16n8k8_tf32(acc[m][n], x0, x1, x2, x3, h0, h1);
              if (P >= 2) mma_m16n8k8_tf32(acc[m][n], x0, x1, x2, x3, l0, l1);
              if (P == 3) {
                const uint32_t* y = al[m];
                const uint32_t y0 = y[2 * s], y1 = y[4 + 2 * s];
                const uint32_t y2 = y[2 * s + 1], y3 = y[5 + 2 * s];
                mma_m16n8k8_tf32(acc[m][n], y0, y1, y2, y3, h0, h1);
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < CNT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((FULL || (m < cnt && n < ntl))) sum[m][n][i] += acc[m][n][i];
}

// One tap for cnt <= MT m-tiles of one warp (the same in all its lanes):
// straight code for each count at 3 and 4 k-chunks (RLFN's 46 and 48
// channels, the zoo's 40 to 64), a k-chunk loop at other widths, and
// predicated code where the chunk has fewer than NT n-tiles.
template <int P, int CNT, int MT, int NT>
__device__ inline void mma_tap_tf32_any(float (&sum)[MT][NT][4], const float* a, int sw, int kc,
                                        int cnt, int ntl, const uint4* wt) {
  if constexpr (CNT == MT) {
    if (cnt == 0) return;
    if (ntl != NT) {
      mma_tap_tf32<P, MT, 0, false>(sum, a, sw, kc, cnt, ntl, wt);
      return;
    }
  }
  if constexpr (CNT > 1) {
    if (cnt < CNT) {
      mma_tap_tf32_any<P, CNT - 1>(sum, a, sw, kc, cnt, ntl, wt);
      return;
    }
  }
  if (kc == 3) {
    mma_tap_tf32<P, CNT, 3, true>(sum, a, sw, 3, CNT, ntl, wt);
  } else if (kc == 4) {
    mma_tap_tf32<P, CNT, 4, true>(sum, a, sw, 4, CNT, ntl, wt);
  } else {
    mma_tap_tf32<P, CNT, 0, true>(sum, a, sw, kc, CNT, ntl, wt);
  }
}

struct Tile {
  int th, tw;  // output tile: rows, columns
};

// (row, column, word) of a flat index over [rows][w pixels][pw words], stepped
// by kThreads without dividing: the copy loops' index arithmetic.
struct Walk {
  int r, c, q, dr, dc, dq, w, pw;
  __device__ Walk(int i, int w_, int pw_) : w(w_), pw(pw_) {
    const int pix = i / pw;
    q = i - pix * pw;
    r = pix / w;
    c = pix - r * w;
    const int dp = kThreads / pw;
    dq = kThreads - dp * pw;
    dr = dp / w;
    dc = dp - dr * w;
  }
  __device__ void step() {
    q += dq;
    const int carry = q >= pw;
    q -= carry ? pw : 0;
    c += dc + carry;
    if (c >= w) {
      c -= w;
      ++r;
    }
    r += dr;
  }
};

// Loads the (hi0 x wi) window whose top-left pixel is (gy0, gx0) of image n
// of x (NHWC, c0 channels of a 2-byte type T) into shared memory at `sw`
// words per pixel, zero outside the image (torch's zero padding) and in the
// pad channels up to kc whole k-chunks. It moves bits: any 2-byte T.
template <typename T>
__device__ inline void load_window_2byte(const T* __restrict__ x, int n, int h, int wd, int c0,
                                         int gy0, int gx0, int hi0, int wi, int sw, int kc,
                                         uint32_t* buf) {
  static_assert(sizeof(T) == 2, "a 2-byte activation type");
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  if (c0 % 2 == 0) {
    // a word (channel pair) per thread, kInBatch loads in flight at a time
    constexpr int kInBatch = 16;
    const int pw = c0 / 2, padw = kc * 8 - pw;
    const unsigned short* xn = xs + static_cast<long long>(n) * h * wd * c0;
    Walk wk(threadIdx.x, wi, pw);
    while (wk.r < hi0) {
      uint32_t v[kInBatch];
      int d[kInBatch];
#pragma unroll
      for (int u = 0; u < kInBatch; ++u) {
        const int gy = gy0 + wk.r, gx = gx0 + wk.c;
        d[u] = wk.r < hi0 ? (wk.r * wi + wk.c) * sw + wk.q : -1;
        v[u] = 0;
        if (wk.r < hi0 && gy >= 0 && gy < h && gx >= 0 && gx < wd)
          v[u] = __ldg(reinterpret_cast<const uint32_t*>(
              xn + (static_cast<long long>(gy) * wd + gx) * c0 + 2 * wk.q));
        wk.step();
      }
#pragma unroll
      for (int u = 0; u < kInBatch; ++u)
        if (d[u] >= 0) buf[d[u]] = v[u];
    }
    for (int i = threadIdx.x; i < hi0 * wi * padw; i += kThreads)
      buf[(i / padw) * sw + pw + i % padw] = 0u;
  } else {
    const int pw = kc * 8;
    for (int i = threadIdx.x; i < hi0 * wi * pw; i += kThreads) {
      const int pix = i / pw, q = i % pw;
      const int gy = gy0 + pix / wi, gx = gx0 + pix % wi;
      uint32_t v = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && 2 * q < c0) {
        const unsigned short* px = xs + ((static_cast<long long>(n) * h + gy) * wd + gx) * c0;
        v = __ldg(px + 2 * q);
        if (2 * q + 1 < c0) v |= static_cast<uint32_t>(__ldg(px + 2 * q + 1)) << 16;
      }
      buf[pix * sw + q] = v;
    }
  }
}

// Two consecutive values of an f32 or bf16 tensor, as floats, and back.
__device__ inline float2 load_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ inline float2 load_pair(const __nv_bfloat16* p) {
  const uint32_t b = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
}
__device__ inline void store_pair(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ inline void store_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// Loads the (hi0 x wi) window whose top-left pixel is (gy0, gx0) of image n
// of x (NHWC, c0 channels of f32 or bf16) into shared memory as f32 at `sw`
// words per pixel, zero outside the image (torch's zero padding) and in the
// pad channels up to kc whole k-chunks of 16.
template <typename T>
__device__ inline void load_window_f32(const T* __restrict__ x, int n, int h, int wd, int c0,
                                       int gy0, int gx0, int hi0, int wi, int sw, int kc,
                                       float* buf) {
  const T* xn = x + static_cast<long long>(n) * h * wd * c0;
  if (c0 % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0) {
    // a channel pair per thread, kInBatch loads in flight at a time
    constexpr int kInBatch = 16;
    const int pw = c0 / 2;
    Walk wk(threadIdx.x, wi, pw);
    while (wk.r < hi0) {
      float2 v[kInBatch];
      int d[kInBatch];
#pragma unroll
      for (int u = 0; u < kInBatch; ++u) {
        const int gy = gy0 + wk.r, gx = gx0 + wk.c;
        d[u] = wk.r < hi0 ? (wk.r * wi + wk.c) * sw + 2 * wk.q : -1;
        v[u] = make_float2(0.f, 0.f);
        if (wk.r < hi0 && gy >= 0 && gy < h && gx >= 0 && gx < wd)
          v[u] = load_pair(xn + (static_cast<long long>(gy) * wd + gx) * c0 + 2 * wk.q);
        wk.step();
      }
#pragma unroll
      for (int u = 0; u < kInBatch; ++u)
        if (d[u] >= 0) *reinterpret_cast<float2*>(buf + d[u]) = v[u];
    }
  } else {
    for (int i = threadIdx.x; i < hi0 * wi * c0; i += kThreads) {
      const int pix = i / c0, ch = i % c0;
      const int gy = gy0 + pix / wi, gx = gx0 + pix % wi;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = Act<T>::load(xn[(static_cast<long long>(gy) * wd + gx) * c0 + ch]);
      buf[pix * sw + ch] = v;
    }
  }
  const int padw = kc * 16 - c0;
  for (int i = threadIdx.x; i < hi0 * wi * padw; i += kThreads)
    buf[(i / padw) * sw + c0 + i % padw] = 0.f;
}

}  // namespace esr
