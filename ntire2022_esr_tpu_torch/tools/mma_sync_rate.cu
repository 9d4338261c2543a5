// The rate at which one SM issues mma.sync with the operand patterns of the
// kernels: MT m-tiles x NT n-tiles, a hi and a lo accumulator each,
// operands in registers only (no memory traffic), on random normal values.
//  - f16: mma.sync.m16n8k16 (f16 x f16 -> f32), two products per fragment
//    (x*w_hi, x*w_lo), the fasthi16 path;
//  - tf32: mma.sync.m16n8k8 (tf32 x tf32 -> f32), P products per fragment
//    (a_hi*w_hi into hi; a_hi*w_lo, a_lo*w_hi into lo), the parity (P = 3)
//    and fasthi (P = 2) paths.
// It is the ceiling of any mma.sync kernel of that pattern on the card,
// below the data sheet's wgmma rates (989 TFLOP/s f16, 495 TF32).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate \
//        ntire2022_esr_tpu_torch/tools/mma_sync_rate.cu && ./mma_sync_rate
//
// Prints, per shape, the time, the TFLOP/s over all SMs (of the MMAs
// issued, 4096 flops an f16 MMA, 2048 a tf32 one), the SM clock, and the
// clocks per MMA per scheduler (an SM has four, two warps on each here).
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

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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

// the split-TF32 pattern: per m-tile a_hi and a_lo (as TF32 bits: f32 with
// the low 13 bits clear), per n-tile w_hi and w_lo
template <int MT, int NT, int P>
__global__ void __launch_bounds__(256, 1) mma_rate_tf32(float* out, int iters, long long* clk) {
  float acc[MT][NT][2][4];
  uint32_t a[MT][2][4], b[NT][4];
  for (int m = 0; m < MT; ++m)
    for (int i = 0; i < 4; ++i) {
      a[m][0][i] = random_half2(threadIdx.x * (m * 4 + i + 1) + 12345u) & 0xffffe000u;
      a[m][1][i] = (random_half2(threadIdx.x * (m * 4 + i + 5) + 99u) & 0x83ffe000u) | 0x30000000u;
    }
  for (int n = 0; n < NT; ++n)
    for (int i = 0; i < 4; ++i)
      b[n][i] = random_half2(threadIdx.x * (n * 4 + i + 17) + 777u) & 0xffffe000u;
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
        mma_tf32(acc[m][n][0], a[m][0], b[n][0], b[n][1]);
        mma_tf32(acc[m][n][1], a[m][0], b[n][2], b[n][3]);
        if (P >= 3) mma_tf32(acc[m][n][1], a[m][1], b[n][0], b[n][1]);
      }
    a[0][0][0] ^= (it & 1) << 13;
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

// Times kernel<<<sms, 256>>> over reps launches and prints its rate; mmas
// is the number of MMAs one warp issues, flops those of one MMA.
template <typename Kernel>
void time_it(Kernel kernel, int sms, double mmas, double flops, const char* what) {
  const int warps = 8, iters = 20000, reps = 5;
  float* out;
  long long* clk;
  cudaMalloc(&out, sizeof(float) * sms * warps * 32);
  cudaMalloc(&clk, sizeof(long long));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kernel<<<sms, warps * 32>>>(out, iters, clk);
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  for (int r = 0; r < reps; ++r) kernel<<<sms, warps * 32>>>(out, iters, clk);
  cudaEventRecord(e1);
  cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  ms /= reps;
  long long c;
  cudaMemcpy(&c, clk, sizeof(c), cudaMemcpyDeviceToHost);
  mmas *= iters;
  printf("%s, 8 warps on each of %d SMs: %.3f ms, %.0f TFLOP/s, %.2f GHz, %.2f clocks per MMA "
         "per scheduler (%s)\n",
         what, sms, ms, sms * warps * mmas * flops / ms / 1e9, c / ms / 1e6,
         double(c) / (mmas * warps / 4.0), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
  cudaFree(clk);
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
  const int sms = p.multiProcessorCount;
  time_it(mma_rate_tf32<3, 6, 3>, sms, 3 * 6 * 3, 2048,
          "tf32 m16n8k8, 3 m-tiles x 6 n-tiles x 3 products (parity)");
  time_it(mma_rate_tf32<3, 6, 2>, sms, 3 * 6 * 2, 2048,
          "tf32 m16n8k8, 3 m-tiles x 6 n-tiles x 2 products (fasthi)");
  time_it(mma_rate_tf32<2, 6, 3>, sms, 2 * 6 * 3, 2048,
          "tf32 m16n8k8, 2 m-tiles x 6 n-tiles x 3 products");
  return 0;
}
