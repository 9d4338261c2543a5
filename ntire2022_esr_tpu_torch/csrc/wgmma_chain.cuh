// Hopper pieces of the conv chain's 2-byte kernel (csrc/conv_chain.cu
// conv3x3_chain_wgmma_kernel): warpgroup MMA (wgmma.mma_async) with both
// operands read from shared memory through matrix descriptors, its fences
// and groups; mbarriers; bulk asynchronous copies (cp.async.bulk) that
// report to an mbarrier; and 4-byte cp.async with zero fill.
//
// wgmma.mma_async.m64nNk16, f32 accumulation. The four warps of a
// warpgroup issue it together; warp w of the group holds rows 16w..16w+15
// of the 64-row product, and lane (g, t) of it, of each group of 8 columns
// j, d[4j] and d[4j+1] (row g, columns 8j+2t and 8j+2t+1) and d[4j+2],
// d[4j+3] (row g+8, the same columns): mma.sync.m16n8k16's accumulator
// fragment, one per 8 columns. The instruction runs asynchronously: its
// accumulators are not touched between the issue and the wgmma.wait_group
// that covers it, and a register written by the threads is fenced
// (wgmma.fence) before an MMA accumulates into it.
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
