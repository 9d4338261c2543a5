// Shared pieces of the hand-written Hopper kernels: activation-type traits
// and the C helpers each library exports. Built for sm_90a by
// ops/kernels/build.py (nvcc, plain C interface, loaded with ctypes).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace esr {

constexpr int kThreads = 256;  // threads per block
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may opt into on sm_90

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// Launches kernel<<<grid, kThreads, smem, stream>>> after opting into the
// dynamic shared memory it needs (refused above the card's limit); returns
// cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace esr

extern "C" const char* esr_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
