// Shared pieces of the hand-written Hopper kernels: activation-type traits,
// the shared-memory 3x3 convolution stage, and the C helpers each library
// exports. Built for sm_90a by ops/kernels/build.py (nvcc, plain C
// interface, loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace esr {

constexpr int kThreads = 256;  // threads per block
constexpr int kTile = 16;      // output tile edge, in low-resolution pixels
constexpr int kQ = 12;         // output channels one thread accumulates
constexpr int kPMax = 8;       // pixels one thread accumulates, at most
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may opt into on sm_90

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// output channels padded to a whole number of kQ groups (weights and
// biases are packed with this padding, zeros in the pad)
__host__ __device__ inline int cpad(int c) { return cdiv(c, kQ) * kQ; }
// odd per-pixel stride of the shared-memory activation buffers: threads
// that read neighbouring pixels then hit distinct banks
__host__ __device__ inline int odd_stride(int c) { return c | 1; }

// Activation types. Shared memory always holds f32, but every value put
// there has already been rounded to T, so it is exactly the T value the
// unfused graph would have stored.
template <typename T> struct Act;

template <> struct Act<float> {
  static __device__ float load(float v) { return v; }
  static __device__ float store(float v) { return v; }
  static __device__ float rn(float v) { return v; }           // round to T
  static __device__ float store_out(float v) { return v; }    // ops/nn.py store_out
};

template <> struct Act<__half> {
  static __device__ float load(__half v) { return __half2float(v); }
  static __device__ __half store(float v) { return __float2half_rn(v); }
  static __device__ float rn(float v) { return __half2float(__float2half_rn(v)); }
  // saturating cast: +-65504 instead of inf (NaN stays NaN, as in clamp)
  static __device__ float store_out(float v) {
    v = v > 65504.f ? 65504.f : (v < -65504.f ? -65504.f : v);
    return rn(v);
  }
};

template <> struct Act<__nv_bfloat16> {
  static __device__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  static __device__ float rn(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
  static __device__ float store_out(float v) { return rn(v); }
};

// One valid 3x3 convolution over a shared-memory region, f32 accumulation
// starting from the bias, on CUDA cores.
//   in   : (Hi x Wi) pixels, pixel stride `cs` floats, `cin` channels;
//          the output region is (Wi-2 wide) x `ho` rows, origin at in[1,1]
//   wg   : global weights [ky][kx][cin][cpad(cout)], bg: bias [cpad(cout)]
//   wsm  : shared staging of one kernel row [kx][cin][cpad(cout)]; 16-byte aligned
//   epi(r, c, co, v) receives every output (r < ho, c < wo, co < cout)
// Each thread owns P pixels (strided, so a warp reads neighbouring pixels)
// times kQ channels (a warp reads the same weights: a broadcast).
// Every thread of the block must call it (it synchronises).
template <int P, typename Epi>
__device__ void conv3x3_stage_p(const float* in, int wi, int cs, int cin, int ho, int wo,
                                int cout, const float* __restrict__ wg,
                                const float* __restrict__ bg, float* wsm, Epi& epi) {
  const int cp = cpad(cout);
  const int ncg = cp / kQ;
  const int npix = ho * wo;
  const int npg = cdiv(npix, P);
  const int nitems = npg * ncg;
  const int wrow = 3 * cin * cp;  // floats per kernel row, a multiple of 4
  for (int base = 0; base < nitems; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool active = item < nitems;
    const int cg = active ? item / npg : 0;
    const int pg = active ? item % npg : 0;
    int off[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = pg + j * npg;
      const bool ok = active && p < npix;
      off[j] = ok ? ((p / wo) * wi + p % wo) * cs : 0;
    }
    float acc[P][kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float bq = bg[cg * kQ + q];
#pragma unroll
      for (int j = 0; j < P; ++j) acc[j][q] = bq;
    }
    for (int ky = 0; ky < 3; ++ky) {
      __syncthreads();
      const float4* src = reinterpret_cast<const float4*>(wg + ky * wrow);
      float4* dst = reinterpret_cast<float4*>(wsm);
      for (int i = threadIdx.x; i < wrow / 4; i += blockDim.x) dst[i] = __ldg(src + i);
      __syncthreads();
      if (!active) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const float* ip = in + (ky * wi + kx) * cs;
        const float* wp = wsm + kx * cin * cp + cg * kQ;
#pragma unroll 2
        for (int ci = 0; ci < cin; ++ci) {
          float a[P];
#pragma unroll
          for (int j = 0; j < P; ++j) a[j] = ip[off[j] + ci];
          float wv[kQ];
          const float4* w4 = reinterpret_cast<const float4*>(wp + ci * cp);
#pragma unroll
          for (int q4 = 0; q4 < kQ / 4; ++q4) {
            const float4 t = w4[q4];
            wv[4 * q4 + 0] = t.x;
            wv[4 * q4 + 1] = t.y;
            wv[4 * q4 + 2] = t.z;
            wv[4 * q4 + 3] = t.w;
          }
#pragma unroll
          for (int j = 0; j < P; ++j)
#pragma unroll
            for (int q = 0; q < kQ; ++q) acc[j][q] = fmaf(a[j], wv[q], acc[j][q]);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = pg + j * npg;
      if (p >= npix) continue;
      const int r = p / wo, c = p % wo;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int co = cg * kQ + q;
        if (co < cout) epi(r, c, co, acc[j][q]);
      }
    }
  }
}

// Picks P so that one pass of the block covers the stage where it can.
template <typename Epi>
__device__ void conv3x3_stage(const float* in, int wi, int cs, int cin, int ho, int wo,
                              int cout, const float* __restrict__ wg,
                              const float* __restrict__ bg, float* wsm, Epi& epi) {
  int p = cdiv(ho * wo * (cpad(cout) / kQ), blockDim.x);
  p = p < 1 ? 1 : (p > kPMax ? kPMax : p);
  switch (p) {
    case 1: conv3x3_stage_p<1>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    case 2: conv3x3_stage_p<2>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    case 3: conv3x3_stage_p<3>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    case 4: conv3x3_stage_p<4>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    case 5: conv3x3_stage_p<5>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    case 6: conv3x3_stage_p<6>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    case 7: conv3x3_stage_p<7>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
    default: conv3x3_stage_p<8>(in, wi, cs, cin, ho, wo, cout, wg, bg, wsm, epi); break;
  }
}

// Loads the (hi x wi) window whose top-left pixel is (gy0, gx0) of image n
// into shared memory as f32, zero outside the image (torch zero padding).
template <typename T>
__device__ void load_window(const T* __restrict__ x, int n, int h, int w, int c, int gy0,
                            int gx0, int hi, int wi, int cs, float* buf) {
  const int total = hi * wi * c;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int pix = i / c, ch = i % c;
    const int gy = gy0 + pix / wi, gx = gx0 + pix % wi;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = Act<T>::load(x[((static_cast<long long>(n) * h + gy) * w + gx) * c + ch]);
    buf[pix * cs + ch] = v;
  }
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

extern "C" int esr_channel_group() { return esr::kQ; }
