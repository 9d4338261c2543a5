// Hopper pieces of the 2-byte kernels on warpgroup MMA, the conv chain's
// (csrc/conv_chain.cu conv3x3_chain_wgmma_kernel) and the tail's
// (csrc/tail.cu conv3x3_pixelshuffle_wgmma_kernel), and of both kernels'
// split-TF32 paths (conv3x3_chain_wgmma_tf32_kernel,
// conv3x3_pixelshuffle_wgmma_tf32_kernel): warpgroup MMA
// (wgmma.mma_async) with both operands read from shared memory through
// matrix descriptors, or A from registers on TF32, its fences and groups;
// mbarriers; bulk asynchronous copies (cp.async.bulk) that report to an
// mbarrier; 4-byte cp.async with zero fill; the window load into planes of
// 8 channels that the 2-byte kernels' A operands are read from; what the
// split-TF32 kernels share: the A fragment's load and split, a unit's MMAs
// issued and waited for in groups; and the ring of weight units through
// which the split-TF32 kernels and the 2-byte tail stream their weights.
//
// wgmma.mma_async.m64nNk16, f32 accumulation. The four warps of a
// warpgroup issue it together; warp w of the group holds rows 16w..16w+15
// of the 64-row product, and lane (g, t) of it, of each group of 8 columns
// j, d[4j] and d[4j+1] (row g, columns 8j+2t and 8j+2t+1) and d[4j+2],
// d[4j+3] (row g+8, the same columns). The instruction runs
// asynchronously: its accumulators are not touched between the issue and
// the wgmma.wait_group that covers it, and a register written by the
// threads is fenced (wgmma.fence) before an MMA accumulates into it.
//
// Operands in shared memory, K-major, without swizzle: a matrix is made of
// core matrices of 8 rows x 16 bytes (8 values of 2 bytes along K), each
// 128 contiguous bytes; a descriptor holds the first one's address, the
// byte offset between the two core matrices along K (LBO, the 16 values of
// one k-step) and between consecutive groups of 8 rows (SBO).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace esr {

constexpr int kTaps = 9;
// n-tiles of 8 output channels that one step of a wgmma kernel takes (the
// N of its MMAs is 8 P times that): a stage's output channels are packed in
// chunks of that many n-tiles, the last one zero-padded
// (ops/kernels/conv_chain.py _NT_CHUNK), so a narrower stage runs MMAs on
// zero weights, and RLFN's 48 channels are one step.
constexpr int kStepNt = 6;

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The matrix descriptor of wgmma for a K-major operand without swizzle at
// shared-memory address `addr` (16-byte aligned); lbo and sbo in bytes.
__device__ inline uint64_t wgmma_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of this warpgroup's committed groups are still running
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an issue or a wait (the MMAs write them behind its back).
template <int ND>
__device__ inline void fence_acc(float (&d)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (ND = N / 2 floats a thread) = A * B (+ D if scale_d), A 64 x 16 and B
// N x 16 in shared memory (descriptors a and b), on 2-byte T: the N that
// the chain takes, f16 at 48 (one product) and 96 (two), bf16 at 48.
template <typename T>
struct Wgmma;

template <> struct Wgmma<__half> {
  static __device__ void ss(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ void ss(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<__nv_bfloat16> {
  static __device__ void ss(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// D (24 floats a thread) = A * B (+ D if scale_d) on TF32 values,
// wgmma.mma_async.m64n48k8 (the tail's split-TF32 path, tail.cu
// conv3x3_pixelshuffle_wgmma_tf32_kernel): A 64 x 8 from registers, B
// 48 x 8 in shared memory (descriptor b). A warp w of the warpgroup gives
// rows 16w..16w+15 of A: a[0] row g, k = t;
// a[1] row g+8, k = t; a[2] row g, k = t+4; a[3] row g+8, k = t+4. TF32
// operands are K-major only: B's core matrices are 8 columns x 4 values
// (16 bytes a column). The A registers are read while the MMA runs: they
// are not written again until the wait that covers it.
__device__ inline void wgmma_tf32_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The lo term's sum under P = 2 (the second half of N's columns)
template <int P, int ND>
__device__ inline float lo_of(const float (&d)[ND], int i) {
  if constexpr (P == 2) return d[4 * kStepNt + i];
  return 0.f;
}

// ---- mbarriers and asynchronous copies ---------------------------------

__device__ inline void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that announces `bytes` of copies still to land
__device__ inline void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of the given parity is complete; the loop is
// inside the asm, so that the compiler sees no divergent path between the
// MMAs
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from device to
// shared memory, reported to `bar` as they land
__device__ inline void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from shared to
// device memory, in this thread's bulk group
__device__ inline void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// until this thread's bulk stores have read their shared memory
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// 4 bytes from device to shared memory without waiting; src_bytes = 0
// writes zeros and reads nothing
__device__ inline void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// orders this thread's shared-memory writes before later reads of the
// async proxy (wgmma's operands, bulk copies)
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Image n's (hi0 x wi0) window at (gy0, gx0) as 2 kc planes of 8 channels,
// `ps` pixels of 16 bytes from one plane to the next (at least hi0 * wi0),
// zero outside the image and in the pad channels. Even c0: asynchronous
// 4-byte copies (cp.async, waited for by the caller), the pad's zeros
// stored; odd c0: loads and stores.
template <int THREADS, typename T>
__device__ inline void load_window_planes(const T* __restrict__ x, int n, int h, int wd, int c0,
                                          int gy0, int gx0, int hi0, int wi0, int ps, int kc,
                                          uint8_t* buf) {
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* xn = xs + static_cast<long long>(n) * h * wd * c0;
  const int npix = hi0 * wi0, words = 8 * kc;  // words (channel pairs) a pixel holds
  auto at = [&](int pix, int q) {
    return reinterpret_cast<uint32_t*>(buf + ((q >> 2) * ps + pix) * 16 + 4 * (q & 3));
  };
  if (c0 % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) {
    // a thread keeps its (column, word) slots of a window row for every
    // row: per word only the row's offsets move
    const int pw = c0 / 2;
    for (int i = threadIdx.x; i < wi0 * pw; i += THREADS) {
      const int c = i / pw, q = i - c * pw, gx = gx0 + c;
      const bool in_x = gx >= 0 && gx < wd;
      uint8_t* dst = buf + ((q >> 2) * ps + c) * 16 + 4 * (q & 3);
      const unsigned short* src = xn + (static_cast<long long>(gy0) * wd + gx) * c0 + 2 * q;
      for (int r = 0; r < hi0; ++r, dst += wi0 * 16, src += static_cast<long long>(wd) * c0) {
        const bool ok = in_x && gy0 + r >= 0 && gy0 + r < h;
        cp_async4(dst, ok ? src : xs, ok ? 4 : 0);
      }
    }
    const int padw = words - pw;
    for (int i = threadIdx.x; i < npix * padw; i += THREADS) *at(i / padw, pw + i % padw) = 0u;
  } else {
    for (int i = threadIdx.x; i < npix * words; i += THREADS) {
      const int pix = i / words, q = i % words;
      const int gy = gy0 + pix / wi0, gx = gx0 + pix % wi0;
      uint32_t v = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && 2 * q < c0) {
        const unsigned short* px = xn + (static_cast<long long>(gy) * wd + gx) * c0;
        v = __ldg(px + 2 * q);
        if (2 * q + 1 < c0) v |= static_cast<uint32_t>(__ldg(px + 2 * q + 1)) << 16;
      }
      *at(pix, q) = v;
    }
  }
}

// ---- split TF32 on warpgroup MMA ---------------------------------------
//
// The split-TF32 kernels (f32 and bf16 activations with f32 weights)
// issue wgmma.m64n48k8 on TF32 terms (wgmma_tf32_rs): the host splits each
// weight into two TF32 terms (ops/kernels/conv_chain.py split_tf32), the
// kernel each activation in registers (cvt.rna; a bf16 value is an exact
// TF32 value, its lo term zero), and P products a k-step go into one
// accumulator set: a_hi w_hi, a_hi w_lo, a_lo w_hi under f32 activations
// (P = 3), the first two under bf16 (P = 2); P = 1 (a_hi w_hi alone) only
// in the control of tools/chain_check.py --one-product. TF32 keeps f32's
// exponent range and 11 significant bits, and the product of two TF32
// values is exact in f32; w_hi + w_lo is w to about 2^-22 relative, and the
// three products leave out about 2^-22 relative of a*w. The tensor cores
// add into an f32 accumulator with truncation, not rounding to nearest,
// so a sum taken by the MMAs alone over a whole conv drifts toward zero
// (hi and lo sets over a whole stage measured 4.0x cuDNN f32's error
// against an f64 chain, PERF.md). So a unit's products (a tap's, or a
// folded k-step's) are summed from zero and the caller adds them to its
// running sums in f32, rounded to nearest: 6 truncating k-steps a tap at
// 48 channels (tools/accumulation_model.py puts this at 0.65-0.91x the
// error of an f32 FMA chain). The activations are finite under every tier
// that takes this path: an infinite one would give a - a_hi = NaN.
//
// A k-chunk's k order is permuted (the packed weights follow it): k-step
// 2c + s of k-chunk c takes k = t from channel 16c + 4t + 2s and k = t+4
// from channel 16c + 4t + 2s + 1, so that one 16-byte load per row gives a
// lane both k-steps' values of that row: channels 4t..4t+3.

constexpr int kRing32 = 4;        // weight buffers of a ring, at most
constexpr int kRing32Head = 128;  // bytes of its mbarriers and counters, before the buffers
// bytes of one k-step's B operand of one term: kStepNt n-tiles x 8 TF32 values
constexpr int kStepB32 = 8 * kStepNt * 8 * 4;

// This lane's activations of KG k-steps of one m-block, as the A
// fragment's f32 values raw[k-step][a0..a3]. `a`: this lane's word of an
// f32 window at `sw` words a pixel, at pixel (the warp's first output
// index + g + the tap's offset), channel 4t (per tap: k-step 2c + s of
// k-chunk c takes channels 4t + 2s and 4t + 2s + 1 at k = t and t + 4);
// or at the warp's first output index + g with `fo` the unit's (tap,
// channel) offsets (folded: k-step s, half e takes K index 8 s + 4 e + t,
// zero past 9 cin).
template <bool FOLD, int KG>
__device__ inline void load_a(float (&raw)[KG][4], const float* a, int sw, int ks0, const int* fo,
                              int t) {
  if constexpr (FOLD) {
#pragma unroll
    for (int s = 0; s < KG; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = fo[8 * (ks0 + s) + 4 * e + t];
        raw[s][2 * e] = o >= 0 ? a[o] : 0.f;
        raw[s][2 * e + 1] = o >= 0 ? a[8 * sw + o] : 0.f;
      }
  } else {
#pragma unroll
    for (int c = 0; c < KG / 2; ++c) {
      const float4 u = *reinterpret_cast<const float4*>(a + 8 * ks0 + 16 * c);
      const float4 v = *reinterpret_cast<const float4*>(a + 8 * sw + 8 * ks0 + 16 * c);
      raw[2 * c][0] = u.x;
      raw[2 * c][1] = v.x;
      raw[2 * c][2] = u.y;
      raw[2 * c][3] = v.y;
      raw[2 * c + 1][0] = u.z;
      raw[2 * c + 1][1] = v.z;
      raw[2 * c + 1][2] = u.w;
      raw[2 * c + 1][3] = v.w;
    }
  }
}

// The A registers of those k-steps split into TF32 terms: ah (and al
// under P = 3) [k-step][a0..a3].
template <int P, int KG>
__device__ inline void split_a(uint32_t (&ah)[KG][4], uint32_t (&al)[KG][4],
                               const float (&raw)[KG][4]) {
#pragma unroll
  for (int s = 0; s < KG; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (P == 3) {
        ah[s][e] = tf32_rna(raw[s][e]);
        al[s][e] = tf32_rna(raw[s][e] - __uint_as_float(ah[s][e]));
      } else {
        ah[s][e] = __float_as_uint(raw[s][e]);  // exact bf16 values: valid TF32
      }
    }
}

// One unit of one m-block: its ks k-steps (KS, or the argument where KS
// is 0) x P products (a_hi w_hi, a_hi w_lo, a_lo w_hi) summed by the MMAs
// from zero into d, issued in groups of KG k-steps, each waited for before
// the next group's A registers are written: no accumulator is read and no
// A register written under a pending MMA, so ptxas serializes no wgmma.
// b: the unit's weights, [k-step][hi, lo] B operands of kStepB32
// bytes (core matrices of 128 bytes: LBO 128, SBO 256).
template <int P, bool FOLD, int KS, int KG>
__device__ inline void unit_mmas(float (&d)[24], const float* a, int sw, const int* fo,
                                 unsigned b, int t, int ks = KS) {
  if (KS > 0) ks = KS;
  float raw[KG][4];
  load_a<FOLD, KG>(raw, a, sw, 0, fo, t);
#pragma unroll(KS > 0 ? KS : 1)
  for (int ks0 = 0; ks0 < ks; ks0 += KG) {
    uint32_t ah[KG][4], al[KG][4];
    split_a<P, KG>(ah, al, raw);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KG; ++s) {
      const unsigned bk = b + static_cast<unsigned>(2 * (ks0 + s)) * kStepB32;
      const uint64_t bh = wgmma_desc(bk, 128, 256), bl = wgmma_desc(bk + kStepB32, 128, 256);
      wgmma_tf32_rs(d, ah[s], bh, ks0 + s != 0);
      if (P >= 2) wgmma_tf32_rs(d, ah[s], bl, 1);
      if (P == 3) wgmma_tf32_rs(d, al[s], bh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    if (ks0 + KG < ks) load_a<FOLD, KG>(raw, a, sw, ks0 + KG, fo, t);
  }
}

// A ring of nbuf shared-memory buffers (2 to kRing32) through which a
// block's units of weights run in order, across stages and tiles (the
// split-TF32 kernels, and the 2-byte tail where a step's weights do not
// stay in shared memory): unit j
// lies in buffer j % nbuf, and its one bulk copy reports to that buffer's
// mbarrier in phase j / nbuf. The last of the warps that read a unit asks
// for the unit nbuf later into its buffer (a counter a buffer), so the
// copies run ahead of the MMAs with no barrier of the block between units.
// At `base`: kRing32 mbarriers and kRing32 counters, then, kRing32Head
// bytes on, the buffers of unit_bytes each. Each thread keeps its own
// cursor (j, slot, parity); a warp that reads no unit of a pass advances
// it all the same.
struct Ring32 {
  uint8_t* base;  // the mbarriers (a buffer's unit has landed), the counters (warps done with it)
  int nbuf, unit_bytes;
  int j = 0, slot = 0;  // units passed so far, and the buffer of unit j
  unsigned parity = 0;  // the phase of unit j in its buffer

  __device__ Ring32(uint8_t* base_, int nbuf_, int unit_bytes_)
      : base(base_), nbuf(nbuf_), unit_bytes(unit_bytes_) {}
  __device__ uint64_t* full() const { return reinterpret_cast<uint64_t*>(base); }
  __device__ int* done() const { return reinterpret_cast<int*>(base + 8 * kRing32); }
  // the barriers and counters, before the block's first barrier
  __device__ void init() const {
    if (threadIdx.x < kRing32) {
      done()[threadIdx.x] = 0;
      mbar_init(full() + threadIdx.x, 1);
    }
  }
  // one thread: unit jj's `bytes` (a multiple of 16) from src into its buffer
  __device__ void load(int jj, const void* src, unsigned bytes) const {
    const int b = jj % nbuf;
    mbar_expect(full() + b, bytes);
    bulk_load(base + kRing32Head + b * unit_bytes, src, bytes, full() + b);
  }
  // waits until unit j has landed; the shared-memory address of its buffer
  __device__ unsigned wait() const {
    mbar_wait(full() + slot, parity);
    return smem_addr(base + kRing32Head) + static_cast<unsigned>(slot * unit_bytes);
  }
  // this warp's MMAs have read unit j: the last of the `active` warps that
  // read it calls next(j + nbuf), which asks for that unit (or not, past
  // the block's last)
  template <typename Next>
  __device__ void release(int active, Next& next) const {
    release_slot(slot, j, active, next);
  }
  // the same for unit j - 1, the one before the cursor (a caller that
  // waits for a unit's MMAs only after it has issued the next unit's)
  template <typename Next>
  __device__ void release_prev(int active, Next& next) const {
    release_slot(slot == 0 ? nbuf - 1 : slot - 1, j - 1, active, next);
  }
  template <typename Next>
  __device__ void release_slot(int s, int jj, int active, Next& next) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) {
      __threadfence_block();
      if (atomicAdd(done() + s, 1) == active - 1) {
        atomicExch(done() + s, 0);
        next(jj + nbuf);
      }
    }
    __syncwarp();
  }
  __device__ void advance() {
    ++j;
    if (++slot == nbuf) {
      slot = 0;
      parity ^= 1;
    }
  }
};

// Launches kernel<<<grid, threads, smem, stream>>> after opting into the
// dynamic shared memory it needs; returns cudaGetLastError().
template <typename Kernel, typename... Args>
int launch_threads(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream,
                   Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace esr
