// The rate at which one SM issues mma.sync.m16n8k16 (f16 x f16 -> f32) with
// the operand pattern of the chain kernel: MT m-tiles x NT n-tiles, a hi and
// a lo accumulator each, operands in registers only (no memory traffic), on
// random normal f16 values. It is the ceiling of any mma.sync kernel on the
// card, below the data sheet's wgmma rate.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate \
//        ntire2022_esr_tpu_torch/tools/mma_sync_rate.cu && ./mma_sync_rate
//
// Prints, per shape, the time, the TFLOP/s over all SMs, the SM clock, and
// the clocks per MMA per scheduler (an SM has four, two warps on each here).
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f16 values in about [-4, 4), normal numbers, from a hash of x
__device__ uint32_t random_half2(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  const uint32_t lo = (x & 0x83ffu) | 0x3c00u | ((x >> 10) & 0x0400u);
  const uint32_t hi = ((x >> 16) & 0x83ffu) | 0x3800u | ((x >> 5) & 0x0400u);
  return lo | (hi << 16);
}

template <int MT, int NT>
__global__ void __launch_bounds__(256, 1) mma_rate(float* out, int iters, long long* clk) {
  float acc[MT][NT][2][4];
  uint32_t a[MT][4], b[NT][4];
  for (int m = 0; m < MT; ++m)
    for (int i = 0; i < 4; ++i) a[m][i] = random_half2(threadIdx.x * (m * 4 + i + 1) + 12345u);
  for (int n = 0; n < NT; ++n)
    for (int i = 0; i < 4; ++i) b[n][i] = random_half2(threadIdx.x * (n * 4 + i + 17) + 777u);
  for (int m = 0; m < MT; ++m)
    for (int n = 0; n < NT; ++n)
      for (int h = 0; h < 2; ++h)
        for (int i = 0; i < 4; ++i) acc[m][n][h][i] = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma(acc[m][n][0], a[m], b[n][0], b[n][1]);
        mma(acc[m][n][1], a[m], b[n][2], b[n][3]);
      }
    a[0][0] ^= (it & 1) << 3;  // keeps the compiler from hoisting anything
  }
  const long long t1 = clock64();
  float s = 0;
  for (int m = 0; m < MT; ++m)
    for (int n = 0; n < NT; ++n)
      for (int h = 0; h < 2; ++h)
        for (int i = 0; i < 4; ++i) s += acc[m][n][h][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *clk = t1 - t0;
}

template <int MT, int NT>
void run(int sms) {
  const int warps = 8, iters = 20000, reps = 5;
  float* out;
  long long* clk;
  cudaMalloc(&out, sizeof(float) * sms * warps * 32);
  cudaMalloc(&clk, sizeof(long long));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_rate<MT, NT><<<sms, warps * 32>>>(out, iters, clk);
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  for (int r = 0; r < reps; ++r) mma_rate<MT, NT><<<sms, warps * 32>>>(out, iters, clk);
  cudaEventRecord(e1);
  cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  ms /= reps;
  long long c;
  cudaMemcpy(&c, clk, sizeof(c), cudaMemcpyDeviceToHost);
  const double mmas = double(iters) * MT * NT * 2;  // per warp
  printf("%d m-tiles x %d n-tiles x (hi, lo), 8 warps on each of %d SMs: %.3f ms, %.0f TFLOP/s, "
         "%.2f GHz, %.2f clocks per MMA per scheduler (%s)\n",
         MT, NT, sms, ms, sms * warps * mmas * 4096 / ms / 1e9, c / ms / 1e6,
         double(c) / (mmas * warps / 4.0), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(clk);
}

int main() {
  cudaDeviceProp p;
  cudaGetDeviceProperties(&p, 0);
  printf("%s, %d SMs\n", p.name, p.multiProcessorCount);
  run<3, 6>(p.multiProcessorCount);
  run<2, 6>(p.multiProcessorCount);
  run<1, 6>(p.multiProcessorCount);
  return 0;
}
