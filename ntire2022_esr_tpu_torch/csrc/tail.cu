// conv3x3_pixelshuffle: conv2d(x, w, b, padding=1) to r*r*cout channels,
// rounded to the activation type as ops/nn.py store_out does, then
// PixelShuffle(r) in torch's channel-major order:
//   out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j].
// The upsampler of RLFN.
//
// Replaces ntire2022_esr_tpu/ops/pallas/tail.py fused_conv3x3_pixelshuffle.
// One block per (image, 16x16 low-resolution tile): the tile plus a
// one-pixel halo is loaded into shared memory, the conv accumulates in f32
// from the bias, the rounded result is kept in shared memory, and the
// shuffled (16r x 16r x cout) high-resolution tile is written row by row,
// coalesced, so the (h, w, r*r*cout) intermediate never reaches device
// memory.
//
// Bound on an H100 (see PERF.md): at RLFN's widths (46 -> 48, r = 4) it
// does 9*46*48 = 19,872 MACs per low-resolution pixel and moves 92 + 96
// bytes per pixel in f16, so it is bound by operations on f32 CUDA cores.
#include "common.cuh"

namespace esr {

__host__ __device__ inline void tail_layout(int cin, int nch, int* wsz, int* isz, int* osz) {
  *wsz = 3 * cin * cpad(nch);
  *isz = (kTile + 2) * (kTile + 2) * odd_stride(cin);
  *osz = kTile * kTile * odd_stride(nch);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_pixelshuffle_kernel(const T* __restrict__ x, T* __restrict__ out,
                                const float* __restrict__ w, const float* __restrict__ b,
                                int h, int wd, int cin, int cout, int r, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nch = cout * r * r;
  int wsz, isz, osz;
  tail_layout(cin, nch, &wsz, &isz, &osz);
  float* wsm = smem;
  float* ibuf = smem + wsz;
  float* obuf = ibuf + isz;
  const int cso = odd_stride(nch);
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * kTile;
  const int tx0 = (blockIdx.x % tiles_w) * kTile;
  load_window(x, n, h, wd, cin, ty0 - 1, tx0 - 1, kTile + 2, kTile + 2, odd_stride(cin), ibuf);

  auto epi = [&](int rr, int c, int co, float v) {
    obuf[(rr * kTile + c) * cso + co] = Act<T>::store_out(v);
  };
  conv3x3_stage(ibuf, kTile + 2, odd_stride(cin), cin, kTile, kTile, nch, w, b, wsm, epi);
  __syncthreads();

  // high-resolution tile, channel fastest: consecutive threads write
  // consecutive addresses of one output row
  const int hr_w = kTile * r;
  const long long out_w = static_cast<long long>(wd) * r;
  for (int i = threadIdx.x; i < hr_w * hr_w * cout; i += blockDim.x) {
    const int c = i % cout;
    const int t = i / cout;
    const int xx = t % hr_w, yy = t / hr_w;
    const int ly = yy / r, lx = xx / r;  // low-resolution pixel in the tile
    if (ty0 + ly >= h || tx0 + lx >= wd) continue;
    const int k = c * r * r + (yy % r) * r + xx % r;
    const long long g = (static_cast<long long>(n) * h * r + ty0 * r + yy) * out_w + tx0 * r + xx;
    out[g * cout + c] = Act<T>::store(obuf[(ly * kTile + lx) * cso + k]);
  }
}

}  // namespace esr

using namespace esr;

// Dynamic shared memory one block needs, in bytes.
extern "C" long long conv3x3_pixelshuffle_smem_bytes(int cin, int cout, int r) {
  int wsz, isz, osz;
  tail_layout(cin, cout * r * r, &wsz, &isz, &osz);
  return static_cast<long long>(wsz + isz + osz) * sizeof(float);
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, cin) NHWC contiguous;
// out: (n, r*h, r*wd, cout) NHWC contiguous. w: [3][3][cin][cpad(r*r*cout)]
// f32; b: [cpad(r*r*cout)] f32. Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_pixelshuffle(int dtype, const void* x, void* out, const void* w,
                                    const void* b, int n, int h, int wd, int cin, int cout,
                                    int r, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || cin < 1 || cout < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = cdiv(wd, kTile);
  const dim3 grid(cdiv(h, kTile) * tiles_w, n);
  const size_t smem = static_cast<size_t>(conv3x3_pixelshuffle_smem_bytes(cin, cout, r));
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  switch (dtype) {
    case 0:
      return launch(conv3x3_pixelshuffle_kernel<float>, grid, smem, stream,
                    static_cast<const float*>(x), static_cast<float*>(out), wf, bf, h, wd, cin,
                    cout, r, tiles_w);
    case 1:
      return launch(conv3x3_pixelshuffle_kernel<__half>, grid, smem, stream,
                    static_cast<const __half*>(x), static_cast<__half*>(out), wf, bf, h, wd,
                    cin, cout, r, tiles_w);
    case 2:
      return launch(conv3x3_pixelshuffle_kernel<__nv_bfloat16>, grid, smem, stream,
                    static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), wf,
                    bf, h, wd, cin, cout, r, tiles_w);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
