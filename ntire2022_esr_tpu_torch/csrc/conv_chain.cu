// conv3x3_chain: `depth` same-padded 3x3 convolutions, each + bias,
// rounded to the activation type as ops/nn.py store_out does, then
// LeakyReLU(slope); then + x when `residual`. The RLFB body of RLFN.
//
// Replaces ntire2022_esr_tpu/ops/pallas/conv_chain.py fused_conv3x3_chain.
// One block per (image, 16x16 output tile). The tile plus a halo of
// `depth` pixels is loaded once; the stages run in shared memory as
// ping-pong buffers, each stage's region two pixels smaller than the one
// before, and only the last stage's tile goes back to device memory. After
// every stage but the last, positions outside the image are zeroed, so the
// next stage sees torch's zero padding. Unlike the Pallas kernel, each
// stage's output is rounded to the storage type (f16 saturating under
// fasthi16): the unfused graph's per-conv rounding, which the shipped
// tier's accuracy was measured on.
//
// Bound on an H100 (see PERF.md): at RLFN's 46->48->48->46 widths the
// chain does 9*(46*48+48*48+48*46) = 59,616 MACs per pixel and moves
// 184 bytes per pixel in f16, so it is bound by operations. It accumulates
// in f32 on CUDA cores, as the tiers' f32-grade contractions require; the
// halo recomputes about 29% extra MACs at the 16x16 tile.
#include "common.cuh"

namespace esr {

constexpr int kMaxDepth = 4;

struct Widths {
  int c[kMaxDepth + 1];  // c[0] input channels, c[k+1] output channels of stage k
};

__host__ __device__ inline int chain_stride(const Widths& cw, int depth) {
  int cmax = 0;
  for (int k = 0; k < depth; ++k) cmax = cw.c[k] > cmax ? cw.c[k] : cmax;
  cmax = cw.c[depth] > cmax ? cw.c[depth] : cmax;
  return odd_stride(cmax);
}

// floats of the shared-memory layout: [weights of one kernel row][window][stage buffer]
__host__ __device__ inline void chain_layout(const Widths& cw, int depth, int* wsz, int* asz,
                                             int* bsz) {
  int w = 0;
  for (int k = 0; k < depth; ++k) {
    const int r = 3 * cw.c[k] * cpad(cw.c[k + 1]);
    w = r > w ? r : w;
  }
  const int cs = chain_stride(cw, depth);
  const int hi = kTile + 2 * depth;
  const int hb = depth > 1 ? hi - 2 : kTile;
  *wsz = w;
  *asz = hi * hi * cs;
  *bsz = hb * hb * cs;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_chain_kernel(const T* __restrict__ x, T* __restrict__ out,
                         const float* __restrict__ w, const float* __restrict__ b, int h,
                         int wd, int depth, Widths cw, float slope, int residual, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int wsz, asz, bsz;
  chain_layout(cw, depth, &wsz, &asz, &bsz);
  float* wsm = smem;
  float* src = smem + wsz;
  float* dst = src + asz;
  const int cs = chain_stride(cw, depth);
  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * kTile;
  const int tx0 = (blockIdx.x % tiles_w) * kTile;
  // the slope rounded to T, as ops/nn.py leaky_relu (and JAX) round it
  const float s = Act<T>::rn(slope);
  int hi = kTile + 2 * depth;
  load_window(x, n, h, wd, cw.c[0], ty0 - depth, tx0 - depth, hi, hi, cs, src);

  const float* wk = w;
  const float* bk = b;
  for (int k = 0; k < depth; ++k) {
    const int cin = cw.c[k], cout = cw.c[k + 1];
    const int ho = hi - 2;
    const int halo = depth - 1 - k;  // this stage's region starts `halo` pixels before the tile
    float* d = dst;
    const bool mask = k < depth - 1;  // the last stage writes only in-image pixels out
    auto epi = [&](int r, int c, int co, float v) {
      float y = Act<T>::store_out(v);
      if (y < 0.f) y = Act<T>::rn(y * s);
      if (mask) {
        const int gy = ty0 - halo + r, gx = tx0 - halo + c;
        if (gy < 0 || gy >= h || gx < 0 || gx >= wd) y = 0.f;
      }
      d[(r * ho + c) * cs + co] = y;
    };
    conv3x3_stage(src, hi, cs, cin, ho, ho, cout, wk, bk, wsm, epi);
    wk += 9 * cin * cpad(cout);
    bk += cpad(cout);
    float* t = src;
    src = dst;
    dst = t;
    hi = ho;
  }
  __syncthreads();

  // src holds the finished kTile x kTile tile; write it out coalesced,
  // adding the input's centre (re-read from device memory) if residual
  const int cout = cw.c[depth];
  const int c0 = cw.c[0];
  for (int i = threadIdx.x; i < kTile * kTile * cout; i += blockDim.x) {
    const int pix = i / cout, co = i % cout;
    const int gy = ty0 + pix / kTile, gx = tx0 + pix % kTile;
    if (gy >= h || gx >= wd) continue;
    const long long g = (static_cast<long long>(n) * h + gy) * wd + gx;
    float y = src[pix * cs + co];
    if (residual) y = Act<T>::rn(y + Act<T>::load(x[g * c0 + co]));
    out[g * cout + co] = Act<T>::store(y);
  }
}

inline bool valid(int depth, const Widths& cw) {
  if (depth < 1 || depth > kMaxDepth) return false;
  for (int k = 0; k <= depth; ++k)
    if (cw.c[k] < 1) return false;
  return true;
}

}  // namespace esr

using namespace esr;

// Dynamic shared memory one block needs, in bytes (0 for invalid widths).
extern "C" long long conv3x3_chain_smem_bytes(int depth, int c0, int c1, int c2, int c3,
                                              int c4) {
  const Widths cw{{c0, c1, c2, c3, c4}};
  if (!valid(depth, cw)) return 0;
  int wsz, asz, bsz;
  chain_layout(cw, depth, &wsz, &asz, &bsz);
  return static_cast<long long>(wsz + asz + bsz) * sizeof(float);
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, c0) and out:
// (n, h, wd, c_depth), NHWC contiguous. w: per stage [3][3][cin][cpad(cout)]
// f32, concatenated; b: per stage [cpad(cout)] f32, concatenated.
// Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_chain(int dtype, const void* x, void* out, const void* w, const void* b,
                             int n, int h, int wd, int depth, int c0, int c1, int c2, int c3,
                             int c4, float slope, int residual, void* stream) {
  const Widths cw{{c0, c1, c2, c3, c4}};
  if (!valid(depth, cw) || n < 1 || n > 65535 || h < 1 || wd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = cdiv(wd, kTile);
  const dim3 grid(cdiv(h, kTile) * tiles_w, n);
  const size_t smem = static_cast<size_t>(conv3x3_chain_smem_bytes(depth, c0, c1, c2, c3, c4));
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  switch (dtype) {
    case 0:
      return launch(conv3x3_chain_kernel<float>, grid, smem, stream,
                    static_cast<const float*>(x), static_cast<float*>(out), wf, bf, h, wd,
                    depth, cw, slope, residual, tiles_w);
    case 1:
      return launch(conv3x3_chain_kernel<__half>, grid, smem, stream,
                    static_cast<const __half*>(x), static_cast<__half*>(out), wf, bf, h, wd,
                    depth, cw, slope, residual, tiles_w);
    case 2:
      return launch(conv3x3_chain_kernel<__nv_bfloat16>, grid, smem, stream,
                    static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), wf,
                    bf, h, wd, depth, cw, slope, residual, tiles_w);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
