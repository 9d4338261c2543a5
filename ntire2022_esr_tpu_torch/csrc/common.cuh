// Shared pieces of the hand-written Hopper kernels: activation-type traits,
// the 2-byte tiers' epilogue, the GEMM shape's counts, the f32 window load
// of the split-TF32 kernels, and the C helpers each library exports. Built
// for sm_90a by ops/kernels/build.py (nvcc, plain C interface, loaded with
// ctypes).
//
// P = 2, split f16 (fasthi16). Every activation is an exact f16 value; only
// the weights are f32. The host splits each weight once
// (ops/kernels/conv_chain.py split_f16): with a power-of-two scale S per
// output channel that brings the channel's largest |w| into [2^13, 2^14),
//     w_hi = f16(w*S),   w_lo = f16((w*S - w_hi) * 2^11),
// so w*S = w_hi + w_lo*2^-11 to about 2^-22 relative. The kernels run two
// products a MAC, x*w_hi and x*w_lo, into two f32 sums; each product of two
// f16 values is exact in f32, so all rounding is in the f32 accumulation, as
// in any f32 convolution. The epilogue forms (sum_hi + sum_lo*2^-11) / S +
// bias.
// P = 1, one product (fast16: f16, fast: bf16). The weights themselves are
// 2-byte under these tiers: the host packs each one once, rounded to T
// (ops/kernels/conv_chain.py pack_chain_2byte), with S = 1, which the
// epilogue does not read. The product of two values of T is exact in f32,
// so one product a MAC gives the unfused graph's f32 sum of the exact
// products; the epilogue rounds it to T, adds the bias (rounded to T on the
// host) and the store rounds again (R2: two roundings, as ops/nn.py conv2d
// computes a 2-byte contraction's output).
//
// GEMM shape. M = pixels, N = output channels in n-tiles of 8, K = 9 taps x
// input channels in k-chunks of 16 (pad channels are zero in shared memory
// and in the packed weights). A stage is computed over the INPUT's row
// pitch: output index p = r*wi + c for every c < wi, so the input pixel of
// tap (ky, kx) is p + ky*wi + kx, a constant offset, and a block of
// consecutive p is a block of rows at a constant stride even across row
// ends. The two columns c >= wi-2 of each row are garbage that the
// epilogue drops.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace esr {

constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may opt into on sm_90
// n-tiles (8 channels each) of one chunk of the packed weights (one step of
// the wgmma kernels, wgmma_chain.cuh kStepNt; ops/kernels/conv_chain.py
// _NT_CHUNK)
constexpr int kNtChunk = 6;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int kchunks(int cin) { return cdiv(cin, 16); }
__host__ __device__ inline int ntiles(int cout) { return cdiv(cout, 8); }

// The 2-byte kernels' products a MAC for the C entry points' dtype (1 half,
// 2 bfloat16) and fast flag: 2 for f16 activations with f32 weights
// (fasthi16), 1 for 2-byte weights (fast16, fast); 0: the split-TF32
// kernels take the call
inline int mma_products(int dtype, int fast) { return fast ? 1 : dtype == 1 ? 2 : 0; }

// 32-bit words per pixel of an f32 buffer for up to `c` channels: whole
// k-chunks of 16, and 16 (mod 32), so that a quarter warp's 16-byte loads
// (lanes 0-7: rows g and g+1, 16 words each) cover the 32 banks once
__host__ __device__ inline int pixel_words_f32(int c) {
  const int w = kchunks(c) * 16;
  return (w & 16) ? w : w + 16;
}

struct Tile {
  int th, tw;  // output tile: rows, columns
};

// Saturate at +-65504, f16's largest value, instead of inf on the store;
// NaN stays NaN, as in torch.clamp.
__device__ inline float clamp_f16_range(float v) {
  asm("max.NaN.f32 %0, %0, 0fC77FE000;\n\tmin.NaN.f32 %0, %0, 0f477FE000;\n" : "+f"(v));
  return v;
}

// The 2-byte activation types: their pairs, roundings and the store's
// saturation (f16 saturates as ops/nn.py store_out does; bf16, with f32's
// range, does not).
template <typename T> struct Op2;

template <> struct Op2<__half> {
  using T2 = __half2;
  static __device__ T2 pack(float a, float b) { return __floats2half2_rn(a, b); }
  static __device__ T2 splat(float v) { return __float2half2_rn(v); }
  static __device__ float2 unpack(T2 v) { return __half22float2(v); }
  static __device__ float rn(float v) { return __half2float(__float2half_rn(v)); }
  static __device__ float sat(float v) { return clamp_f16_range(v); }
};

template <> struct Op2<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ T2 pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
  static __device__ T2 splat(float v) { return __float2bfloat162_rn(v); }
  static __device__ float2 unpack(T2 v) { return __bfloat1622float2(v); }
  static __device__ float rn(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ float sat(float v) { return v; }
};

// The 2-byte kernels' epilogue for one value, before the store's rounding
// to T, from the sums of this value's terms (lo unused under P = 1).
// P = 2: (sum_hi + sum_lo * 2^-11) / S + bias, as one f32 conv. P = 1: the
// sum itself (S = 1). R2 (fast16, fast): the sum rounded to T first (inf
// where f16 overflows) and the bias, rounded to T on the host, added after.
// f16 saturates at +-65504 after the add, as ops/nn.py store_out follows
// it; bf16 does not saturate.
template <typename T, int P, bool R2>
__device__ inline float epilogue_value(float hi, float lo, float inv_s, float b) {
  const float sum = P == 2 ? fmaf(lo, 1.f / 2048.f, hi) * inv_s : hi;
  return Op2<T>::sat(R2 ? Op2<T>::rn(sum) + b : sum + b);
}

// The activation types of the split-TF32 kernels. Shared memory holds f32,
// but every value put there has already been rounded to T, so it is exactly
// the T value the unfused graph would have stored.
template <typename T> struct Act;

template <> struct Act<float> {
  static __device__ float load(float v) { return v; }
  static __device__ float store(float v) { return v; }
  static __device__ float rn(float v) { return v; }           // round to T
  static __device__ float store_out(float v) { return v; }    // ops/nn.py store_out
};

template <> struct Act<__nv_bfloat16> {
  static __device__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  static __device__ float rn(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ float store_out(float v) { return rn(v); }
};

// An f32 value rounded to TF32 to the nearest, ties away from zero (its
// low 13 bits zero), as the split-TF32 kernels split their activations.
__device__ inline uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// (row, column, word) of a flat index over [rows][w pixels][pw words], stepped
// by `threads` (a block's) without dividing: the copy loops' index arithmetic.
struct Walk {
  int r, c, q, dr, dc, dq, w, pw;
  __device__ Walk(int i, int w_, int pw_, int threads) : w(w_), pw(pw_) {
    const int pix = i / pw;
    q = i - pix * pw;
    r = pix / w;
    c = pix - r * w;
    const int dp = threads / pw;
    dq = threads - dp * pw;
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
// pad channels up to kc whole k-chunks of 16 (none for kc = 0), with the
// THREADS threads of a block.
template <int THREADS, typename T>
__device__ inline void load_window_f32(const T* __restrict__ x, int n, int h, int wd, int c0,
                                       int gy0, int gx0, int hi0, int wi, int sw, int kc,
                                       float* buf) {
  const T* xn = x + static_cast<long long>(n) * h * wd * c0;
  if (c0 % 2 == 0 && sw % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0) {
    // a channel pair per thread, kInBatch loads in flight at a time
    constexpr int kInBatch = 16;
    const int pw = c0 / 2;
    Walk wk(threadIdx.x, wi, pw, THREADS);
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
    for (int i = threadIdx.x; i < hi0 * wi * c0; i += THREADS) {
      const int pix = i / c0, ch = i % c0;
      const int gy = gy0 + pix / wi, gx = gx0 + pix % wi;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd)
        v = Act<T>::load(xn[(static_cast<long long>(gy) * wd + gx) * c0 + ch]);
      buf[pix * sw + ch] = v;
    }
  }
  const int padw = kc * 16 - c0;
  for (int i = threadIdx.x; i < hi0 * wi * padw; i += THREADS)
    buf[(i / padw) * sw + c0 + i % padw] = 0.f;
}

}  // namespace esr

extern "C" const char* esr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
