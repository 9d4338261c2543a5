// conv3x3_pixelshuffle: conv2d(x, w, b, padding=1) to r*r*cout channels,
// rounded to the activation type as ops/nn.py store_out does, then
// PixelShuffle(r) in torch's channel-major order:
//   out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j].
// The upsampler of RLFN.
//
// Replaces ntire2022_esr_tpu/ops/pallas/tail.py fused_conv3x3_pixelshuffle.
// A block takes a low-resolution tile plus a one-pixel halo into shared
// memory, the conv result stays in shared memory, and the shuffled
// high-resolution tile is written out in whole rows, so the
// (h, w, r*r*cout) intermediate never reaches device memory.
//
// Bound on an H100 (see PERF.md): at RLFN's widths (46 -> 48, r = 4) the
// function does 9*46*48 = 19,872 MACs per low-resolution pixel and moves
// 92 + 96 bytes per pixel in f16. On the card's best rate for the work
// (f16 tensor cores, 989 TFLOP/s) the operations take 0.34 ms at batch
// 128 x 256^2 and the bytes 0.47 ms at 3.35 TB/s: it is bound by bytes.
//
// Two kernels share that plan.
//
// f16 storage (fasthi16), conv3x3_pixelshuffle_mma_kernel: the tensor
// cores, as one stage of the chain kernel's routine (mma_stage.cuh: f16
// activations, f32 weights split into two f16 terms, mma.sync.m16n8k16 with
// f32 accumulation, f32-grade). What the design does about the card's
// limits:
//  - one persistent block per SM walks over the tiles; the stage's whole
//    packed weights (83 KB at 46 -> 48) are fetched into shared memory once
//    per block with cp.async, so a kernel row's weights are a constant
//    offset and the MMA loop has no barrier;
//  - a 16x22 tile has 24 m-tiles, 3 for each of the 8 warps in one pass,
//    so every scheduler's tensor core has the same work;
//  - the next tile's window arrives under this tile's MMAs: tensor copies
//    (TMA, cp.async.bulk.tensor) bring its rows as three boxes into a raw
//    buffer and report to an mbarrier. A pixel is 92 bytes there, which
//    ldmatrix cannot read (it wants 16-byte aligned rows), so the block
//    re-lays the window to a 112-byte pixel stride in shared memory; what
//    lies outside the image arrives as zeros;
//  - the shuffle costs nothing in the MMAs: the host packs the output
//    channels in the order k' = (i*r + j)*cout + c (ops/kernels/tail.py
//    pack_tail_f16), so the r*cout channels [i*r*cout, (i+1)*r*cout) of a
//    low-resolution pixel (y, x) are the contiguous run of output row
//    r*y + i at column r*x (24 bytes at RLFN's widths);
//  - the epilogue runs on the accumulator registers (unscale, bias, the
//    saturating round to f16) and stores channel pairs straight into the
//    tile's output rows in shared memory (a table says where each channel
//    goes), and one tensor store writes the 64 rows of 528 bytes, clipped
//    at the image's edges, while the block goes on to the next tile;
//  - shapes whose rows are no multiples of 16 bytes take plain copies
//    instead: batched loads for the window, and stores in 8-, 4- or 2-byte
//    units with no division in the loop.
//
// f32 and bf16 storage (parity, fasthi), conv3x3_pixelshuffle_kernel: f32
// in shared memory and f32 FMAs on CUDA cores (67 TFLOP/s peak), one block
// per 16x16 tile.
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <cstring>

#include "mma_stage.cuh"

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

// ---- the f16-storage path on the tensor cores -------------------------

// Hopper's tensor copies (TMA): one instruction moves a box of a tensor
// between device and shared memory without passing through registers. The
// tensor map (made on the host, cuTensorMapEncodeTiled) holds base, extents
// and strides; what lies outside the tensor is read as zeros and not
// written. A load reports to an mbarrier, a store to the issuing thread's
// bulk group.
__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that announces `bytes` of loads still to land
__device__ inline void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of the given parity is complete
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ inline void tensor_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ inline void tensor_store_3d(const CUtensorMap* map, const void* src, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ inline void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// until this thread's bulk stores have read their shared memory
__device__ inline void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before later bulk copies
__device__ inline void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Widths, regions and work split of the one stage, and its shared memory:
// [whole packed weights, wsz 16-byte units][raw window boxes][result]
// [window][scales and biases][channel table][mbarrier], the middle ones in
// 32-bit words; the first three are multiples of 128 bytes, which the
// tensor copies ask of their shared-memory addresses. The stage's last
// m-tile reads up to kOverrun pixels past the window's pixels; the window
// has room for them.
struct TailGeom {
  int kc, nt, nch;     // k-chunks of 16 inputs, n-tiles of 8 outputs, chunks of kNtChunk n-tiles
  int sw;              // words per pixel of the window
  int runh;            // f16 values of one pixel's run in an output row: r * cout
  int hi, wi;          // window rows and pitch
  int tiles, passes;   // m-tiles of 16 output indices; passes of kWarps * kMT m-tiles
  int ppb_log2, nbox;  // a window arrives as nbox boxes of hi rows x 2^ppb_log2 pixels
  int box_w;           // words of a box's row: its pixels and 4 more (see request_window)
  int box_words;       // from one box to the next in the raw buffer
  int wsz, win_words, raw_words, res_words, sbsz, tabsz;
};

__host__ __device__ inline TailGeom tail_geom(int cin, int cout, int r, Tile t) {
  TailGeom g;
  g.kc = kchunks(cin);
  g.nt = ntiles(cout * r * r);
  g.nch = cdiv(g.nt, kNtChunk);
  g.sw = pixel_words(cin);
  g.runh = r * cout;
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  // output indices p = row * wi + c; the last one kept is (th - 1, tw - 1)
  g.tiles = cdiv(t.th * g.wi - 2, 16);
  g.passes = cdiv(g.tiles, kWarps * kMT);
  // a box is at most 256 words wide: 8 pixels of up to 62 channels, else 4
  g.ppb_log2 = cin <= 62 ? 3 : 2;
  g.nbox = cdiv(g.wi, 1 << g.ppb_log2);
  g.box_w = (cin / 2 << g.ppb_log2) + 4;
  g.box_words = cdiv(g.hi * g.box_w * 4, 128) * 32;
  g.wsz = 9 * g.kc * g.nt * 32;
  g.raw_words = g.nbox * g.box_words;
  g.res_words = cdiv(t.th * r * t.tw * g.runh * 2, 128) * 32;
  g.win_words = (g.hi * g.wi + kOverrun) * g.sw;
  g.sbsz = 2 * 8 * g.nt;
  g.tabsz = 8 * g.nt;
  return g;
}

__host__ __device__ inline size_t tail_mma_smem_bytes(int cin, int cout, int r, Tile t) {
  const TailGeom g = tail_geom(cin, cout, r, t);
  return static_cast<size_t>(g.wsz) * 16 +
         static_cast<size_t>(g.win_words + g.raw_words + g.res_words + g.sbsz + g.tabsz) * 4 + 16;
}

// The finished tile to device memory with plain stores, for shapes whose
// output rows the bulk store does not take. The result holds the tile's
// r * th output rows of tw * run bytes each; of each, the first npx * run
// bytes go out, for the first nrow tile rows. For each i the block walks
// over [tile row][pixel][unit of the run], so that consecutive threads
// store consecutive units of one output row, and no loop divides.
template <typename U>
__device__ inline void copy_out_rows(const uint32_t* res, __half* out, long long row0, int wd,
                                     int run, int r, int tw, int npx, int nrow, int tx0) {
  constexpr int kBatch = 6;  // loads from shared memory ahead of their stores
  constexpr int kU = static_cast<int>(sizeof(U));
  const char* src = reinterpret_cast<const char*>(res);
  char* dst = reinterpret_cast<char*>(out);
  const long long row_bytes = static_cast<long long>(wd) * run;  // one output row of the image
  const Walk first(threadIdx.x, npx, run / kU);
  for (int i = 0; i < r; ++i) {
    Walk wk = first;
    while (wk.r < nrow) {
      U v[kBatch];
      long long e[kBatch];  // byte offset in out; -1: past the tile's rows
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        e[u] = -1;
        if (wk.r < nrow) {
          e[u] = ((row0 + wk.r) * r + i) * row_bytes +
                 static_cast<long long>(tx0 + wk.c) * run + wk.q * kU;
          v[u] = *reinterpret_cast<const U*>(src + ((wk.r * r + i) * tw + wk.c) * run + wk.q * kU);
        }
        wk.step();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (e[u] >= 0) *reinterpret_cast<U*>(dst + e[u]) = v[u];
    }
  }
}

// x: f16 NHWC (nimg, h, wd, cin); out: f16 NHWC (nimg, r*h, r*wd, cout).
// wq: the packed weights of ops/kernels/tail.py pack_tail_f16: output
// channels in the order (i, j, c), then [chunk of n-tiles][ky][kx][k-chunk]
// [n-tile][lane][hi b0, hi b1, lo b0, lo b1]. sb: [1/S per channel][bias per
// channel] in that order, padded to whole n-tiles (1 and 0 in the pad).
// One block walks over the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// (tile = image * tiles_h * tiles_w + tile row * tiles_w + tile column).
// tensor_in, tensor_out: the input's / output's rows are such that tensor
// copies can move them (the host function says when): in_map is x as
// 32-bit words (wd * cin / 2, h, nimg) with boxes of (box_w words, hi rows),
// out_map is out as words (wd * r * cout / 2, r * h, nimg) with
// boxes of one tile. Otherwise plain loads and stores do the copies.
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_pixelshuffle_mma_kernel(const __half* __restrict__ x, __half* __restrict__ out,
                                    const uint4* __restrict__ wq, const float* __restrict__ sb,
                                    int nimg, int h, int wd, int cin, int cout, int r, Tile tile,
                                    int tiles_h, int tiles_w, int tensor_in, int tensor_out,
                                    const __grid_constant__ CUtensorMap in_map,
                                    const __grid_constant__ CUtensorMap out_map) {
  extern __shared__ __align__(128) uint4 smem16[];
  const TailGeom gm = tail_geom(cin, cout, r, tile);
  uint4* const wsm = smem16;
  uint32_t* const raw = reinterpret_cast<uint32_t*>(smem16 + gm.wsz);
  uint32_t* const res = raw + gm.raw_words;
  uint32_t* const win = res + gm.res_words;
  float* const ssb = reinterpret_cast<float*>(win + gm.win_words);
  int* const tab = reinterpret_cast<int*>(ssb + gm.sbsz);
  uint64_t* const bar = reinterpret_cast<uint64_t*>(tab + gm.tabsz);
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nchan = cout * r * r;
  const int pw = cin / 2;       // words of an input pixel, where tensor_in
  const int run = 2 * gm.runh;  // bytes of one pixel's run in an output row

  // once per block: the weights (in flight until the first tile's barrier),
  // scales and biases, and where a channel goes in the result: channel
  // k' = (i*r + j)*cout + c of a pixel lies i output rows down, at (j, c) of
  // the pixel's run; in f16 values from the pixel's run in row 0, -1: pad
  stage_weights_async(wsm, wq, gm.wsz);
  for (int i = threadIdx.x; i < gm.sbsz; i += kThreads) ssb[i] = __ldg(sb + i);
  for (int i = threadIdx.x; i < gm.tabsz; i += kThreads)
    tab[i] = i < nchan ? (i / gm.runh) * tile.tw * gm.runh + i % gm.runh : -1;
  if (tensor_in) {
    // the pad channels stay zero: re-laying a window writes the others only
    for (int i = threadIdx.x; i < gm.win_words; i += kThreads) win[i] = 0u;
    if (threadIdx.x == 0) mbar_init(bar, 1);
  }
  __syncthreads();

  const int per_img = tiles_h * tiles_w;
  const int total = nimg * per_img;
  auto origin = [&](int tl, int& n, int& ty0, int& tx0) {
    n = tl / per_img;
    const int rem = tl - n * per_img;
    const int ty = rem / tiles_w;
    ty0 = ty * tile.th;
    tx0 = (rem - ty * tiles_w) * tile.tw;
  };
  // Thread 0 asks for the window of tile tl, box by box; the boxes report to
  // the mbarrier, one phase a tile (whole boxes count, zeros included). A
  // box must start at a multiple of 16 bytes in its row, so it starts up to
  // 3 words before its first pixel and is 4 words wider than its pixels. The
  // maps' addresses are taken here, in the kernel's own scope: they must
  // stay addresses of the kernel's parameters.
  const CUtensorMap* const in_map_at = &in_map;
  const CUtensorMap* const out_map_at = &out_map;
  auto request_window = [&](int tl) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    mbar_expect(bar, static_cast<unsigned>(gm.nbox * gm.hi * gm.box_w * 4));
    for (int b = 0; b < gm.nbox; ++b)
      tensor_load_3d(raw + b * gm.box_words, in_map_at,
                     (((tx0 - 1) * pw) & ~3) + (b << gm.ppb_log2) * pw, ty0 - 1, n, bar);
  };

  int tl = blockIdx.x;
  if (tensor_in && threadIdx.x == 0 && tl < total) request_window(tl);
  unsigned phase = 0;
  bool store_pending = false;  // thread 0's store of the last tile may still read `res`
  // j / pw for j < 256 and pw <= 64 as a product: (j * by_pw) >> 16
  const int by_pw = tensor_in ? (65536 + pw - 1) / pw : 0;
  float hi[kMT][kNtChunk][4], lo[kMT][kNtChunk][4];
  const float* sc = ssb;
  const float* bi = ssb + 8 * gm.nt;
  auto nothing = [] {};

  for (; tl < total; tl += gridDim.x) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    if (tensor_in) {
      // the boxes have landed, zeros where the image ends (torch's zero
      // padding): re-lay them at `sw` words per pixel. A warp takes one
      // row of one box at a time, whose words are contiguous: lane l moves
      // the words l, l + 32, ... to their pixels.
      mbar_wait(bar, phase);
      phase ^= 1;
      constexpr int kWords = 8;  // a box row has at most 256 words
      const int skew = ((tx0 - 1) * pw) & 3;  // words from a box's start to its first pixel
      for (int item = warp; item < gm.hi * gm.nbox; item += kWarps) {
        const int row = item / gm.nbox, box = item - row * gm.nbox;
        const int c0 = box << gm.ppb_log2;  // the box's first window column
        const int here = gm.wi - c0 < (1 << gm.ppb_log2) ? gm.wi - c0 : 1 << gm.ppb_log2;
        const uint32_t* src = raw + box * gm.box_words + row * gm.box_w + skew;
        uint32_t* dst = win + (row * gm.wi + c0) * gm.sw;
        uint32_t v[kWords];
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          if (lane + 32 * k < here * pw) v[k] = src[lane + 32 * k];
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const int j = lane + 32 * k;
          if (j < here * pw) dst[j + (gm.sw - pw) * ((j * by_pw) >> 16)] = v[k];
        }
      }
    } else {
      load_window_f16(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);
    }
    cp_async_wait_all();
    if (store_pending) bulk_wait_read();
    __syncthreads();  // the window is whole (and the weights); raw and result are free again
    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) request_window(tl + gridDim.x);

    for (int pass = 0; pass < gm.passes; ++pass) {
      // kMT m-tiles a warp while that many are left, the rest split evenly
      const int first = pass * kWarps * kMT;
      const int left = gm.tiles - first;
      const int here = left < kWarps * kMT ? left : kWarps * kMT;
      const int mt0 = first + warp * here / kWarps;
      const int cnt = first + (warp + 1) * here / kWarps - mt0;
      if (cnt == 0) continue;  // the same in all lanes of the warp
      // the up to 2 * kMT pixels of this lane (rows g and g+8 of each
      // m-tile): where the pixel's run starts in the result's row 0 of its
      // tile row, in f16 values; -1: dropped (beyond cnt, and the pitch
      // trick's garbage columns and rows)
      int px[kMT][2];
      {
        int rr = (mt0 * 16 + g) / gm.wi, c = mt0 * 16 + g - rr * gm.wi;
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            px[m][hr] =
                (m < cnt && rr < tile.th && c < tile.tw) ? (rr * r * tile.tw + c) * gm.runh : -1;
            c += 8;  // the pitch is at least 10, so this wraps once at most
            if (c >= gm.wi) {
              c -= gm.wi;
              ++rr;
            }
          }
        }
      }
      const uint32_t* a0 = win + (mt0 * 16 + lane % 16) * gm.sw + 4 * (lane / 16);
      for (int nc = 0; nc < gm.nch; ++nc) {
        const int ntl = gm.nt - nc * kNtChunk < kNtChunk ? gm.nt - nc * kNtChunk : kNtChunk;
#pragma unroll
        for (int m = 0; m < kMT; ++m)
#pragma unroll
          for (int nn = 0; nn < kNtChunk; ++nn)
#pragma unroll
            for (int i = 0; i < 4; ++i) hi[m][nn][i] = lo[m][nn][i] = 0.f;
        const uint4* wch = wsm + 9 * gm.kc * kNtChunk * 32 * nc + lane;
        static_assert(kMT == 3, "the chain below names every count of m-tiles");
#pragma unroll 1
        for (int ky = 0; ky < 3; ++ky) {
          const uint32_t* arow = a0 + ky * gm.wi * gm.sw;
          const uint4* wrow = wch + 3 * gm.kc * ntl * 32 * ky;
          if (ntl != kNtChunk) {
            mma_conv_row<kMT, kNtChunk>(hi, lo, arow, gm.sw, gm.kc, cnt, ntl, wrow);
          } else if (gm.kc == 3 && cnt == 3) {  // RLFN's widths: 46 channels in, 48 out
            mma_conv_row_full<3, 3, kMT, kNtChunk>(hi, lo, arow, gm.sw, 3, wrow, nothing);
          } else if (gm.kc == 3 && cnt == 2) {
            mma_conv_row_full<2, 3, kMT, kNtChunk>(hi, lo, arow, gm.sw, 3, wrow, nothing);
          } else if (cnt == 3) {
            mma_conv_row_full<3, 0, kMT, kNtChunk>(hi, lo, arow, gm.sw, gm.kc, wrow, nothing);
          } else if (cnt == 2) {
            mma_conv_row_full<2, 0, kMT, kNtChunk>(hi, lo, arow, gm.sw, gm.kc, wrow, nothing);
          } else {
            mma_conv_row_full<1, 0, kMT, kNtChunk>(hi, lo, arow, gm.sw, gm.kc, wrow, nothing);
          }
        }

        // epilogue on the accumulators: this lane holds, of each m-tile,
        // rows g and g+8 and, of each n-tile, channels 2t and 2t+1, which go
        // into the result where the table says
        unsigned short* resh = reinterpret_cast<unsigned short*>(res);
#pragma unroll
        for (int nn = 0; nn < kNtChunk; ++nn) {
          if (nn >= ntl) continue;
          const int ntg = nc * kNtChunk + nn;
          const float2 s2 = reinterpret_cast<const float2*>(sc + 8 * ntg)[t];
          const float2 b2 = reinterpret_cast<const float2*>(bi + 8 * ntg)[t];
          const int2 at = reinterpret_cast<const int2*>(tab + 8 * ntg)[t];
#pragma unroll
          for (int m = 0; m < kMT; ++m) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              // computed for dropped pixels too (their sums are zeros or
              // garbage): only the store is conditional, so nothing branches
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                v[e] =
                    combine(hi[m][nn][2 * hr + e], lo[m][nn][2 * hr + e]) * (e ? s2.y : s2.x) +
                    (e ? b2.y : b2.x);
                v[e] = clamp_f16_range(v[e]);
              }
              const __half2 y2 = __floats2half2_rn(v[0], v[1]);
              const uint32_t yb = *reinterpret_cast<const uint32_t*>(&y2);
              if (gm.runh % 2 == 0) {
                // an even run: the pair lies in one run at an even place
                if ((px[m][hr] | at.x) >= 0) res[(px[m][hr] + at.x) >> 1] = yb;
              } else {
                if ((px[m][hr] | at.x) >= 0)
                  resh[px[m][hr] + at.x] = static_cast<unsigned short>(yb & 0xffffu);
                if ((px[m][hr] | at.y) >= 0)
                  resh[px[m][hr] + at.y] = static_cast<unsigned short>(yb >> 16);
              }
            }
          }
        }
      }
    }

    // the finished tile to device memory: by one tensor store that drains
    // under the next tile (the image's edges clip it), or with plain stores
    const int npx = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const long long row0 = static_cast<long long>(n) * h + ty0;  // the tile's first image row
    if (tensor_out) fence_async_proxy();
    __syncthreads();  // the result is whole, and the window is free again
    if (tensor_out) {
      if (threadIdx.x == 0) {
        tensor_store_3d(out_map_at, res, tx0 * (run / 4), ty0 * r, n);
        bulk_commit();
        store_pending = true;
      }
    } else if (run % 8 == 0) {
      copy_out_rows<uint2>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else if (run % 4 == 0) {
      copy_out_rows<uint32_t>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else {
      copy_out_rows<unsigned short>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    }
  }
  if (store_pending) bulk_wait_read();  // before the shared memory goes
}

// The largest output tile of the tensor-core kernel whose buffers fit a
// block's shared memory (the smallest one if none does). A tile of th x tw
// has ceil((th * (tw + 2) - 2) / 16) m-tiles: 24, 16 and 8 of them split
// evenly over the 8 warps.
inline Tile pick_tail_tile(int cin, int cout, int r) {
  const Tile cands[] = {{16, 22}, {16, 14}, {8, 14}, {8, 8}};
  for (const Tile& t : cands)
    if (tail_mma_smem_bytes(cin, cout, r, t) <= kMaxSmem) return t;
  return cands[3];
}

}  // namespace esr

using namespace esr;

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (null if
// it has none)
typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<TensorMapEncode>(fn);
  }();
  return encode;
}

// Dynamic shared memory one block needs, in bytes. dtype as in
// conv3x3_pixelshuffle.
extern "C" long long conv3x3_pixelshuffle_smem_bytes(int dtype, int cin, int cout, int r) {
  if (dtype == 1)
    return static_cast<long long>(
        tail_mma_smem_bytes(cin, cout, r, pick_tail_tile(cin, cout, r)));
  int wsz, isz, osz;
  tail_layout(cin, cout * r * r, &wsz, &isz, &osz);
  return static_cast<long long>(wsz + isz + osz) * sizeof(float);
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, cin) NHWC contiguous;
// out: (n, r*h, r*wd, cout) NHWC contiguous.
// dtype 0 and 2: w is [3][3][cin][cpad(r*r*cout)] f32; b: [cpad(r*r*cout)] f32.
// dtype 1: w is the f16 hi/lo split in fragment order with the output
// channels in shuffled order, and b the scales and biases, as
// conv3x3_pixelshuffle_mma_kernel reads them.
// Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_pixelshuffle(int dtype, const void* x, void* out, const void* w,
                                    const void* b, int n, int h, int wd, int cin, int cout,
                                    int r, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || cin < 1 || cout < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(conv3x3_pixelshuffle_smem_bytes(dtype, cin, cout, r));
  const float* bf = static_cast<const float*>(b);
  if (dtype == 1) {
    const Tile t = pick_tail_tile(cin, cout, r);
    const int tiles_h = cdiv(h, t.th), tiles_w = cdiv(wd, t.tw);
    const long long total = static_cast<long long>(n) * tiles_h * tiles_w;
    if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    // one block per SM walks over the tiles
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(static_cast<unsigned>(total < sms ? total : sms));
    // Tensor copies take rows that are multiples of 16 bytes from a 16-byte
    // aligned base, boxes of at most 256 elements a side, and whole 32-bit
    // words: channel pairs of the input, a pixel's run of the output.
    const TailGeom gm = tail_geom(cin, cout, r, t);
    const long long in_row = static_cast<long long>(wd) * cin * 2;
    const long long out_row = static_cast<long long>(wd) * r * cout * 2;
    const int box_w = t.tw * r * cout * 2;  // bytes of one output row of a tile
    int tensor_in = cin % 2 == 0 && cin <= 126 && in_row % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 && gm.hi <= 256;
    int tensor_out = (r * cout) % 2 == 0 && out_row % 16 == 0 && box_w % 16 == 0 &&
                     box_w <= 1024 && t.th * r <= 256 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    CUtensorMap in_map, out_map;
    memset(&in_map, 0, sizeof(in_map));
    memset(&out_map, 0, sizeof(out_map));
    if (tensor_in || tensor_out) {
      const TensorMapEncode encode = tensor_map_encoder();
      if (!encode) return static_cast<int>(cudaErrorNotSupported);
      const cuuint32_t ones[3] = {1, 1, 1};
      if (tensor_in) {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(in_row / 4), static_cast<cuuint64_t>(h),
                                    static_cast<cuuint64_t>(n)};
        const cuuint64_t strides[2] = {static_cast<cuuint64_t>(in_row),
                                       static_cast<cuuint64_t>(in_row) * h};
        const cuuint32_t box[3] = {static_cast<cuuint32_t>(gm.box_w),
                                   static_cast<cuuint32_t>(gm.hi), 1};
        if (encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(x), dims, strides,
                   box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
          return static_cast<int>(cudaErrorInvalidValue);
      }
      if (tensor_out) {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(out_row / 4),
                                    static_cast<cuuint64_t>(h) * r, static_cast<cuuint64_t>(n)};
        const cuuint64_t strides[2] = {static_cast<cuuint64_t>(out_row),
                                       static_cast<cuuint64_t>(out_row) * h * r};
        const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w / 4),
                                   static_cast<cuuint32_t>(t.th * r), 1};
        if (encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, out, dims, strides, box, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
          return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    return launch(conv3x3_pixelshuffle_mma_kernel, grid, smem, stream,
                  static_cast<const __half*>(x), static_cast<__half*>(out),
                  static_cast<const uint4*>(w), bf, n, h, wd, cin, cout, r, t, tiles_h, tiles_w,
                  tensor_in, tensor_out, in_map, out_map);
  }
  const int tiles_w = cdiv(wd, kTile);
  const dim3 grid(cdiv(h, kTile) * tiles_w, n);
  const float* wf = static_cast<const float*>(w);
  switch (dtype) {
    case 0:
      return launch(conv3x3_pixelshuffle_kernel<float>, grid, smem, stream,
                    static_cast<const float*>(x), static_cast<float*>(out), wf, bf, h, wd, cin,
                    cout, r, tiles_w);
    case 2:
      return launch(conv3x3_pixelshuffle_kernel<__nv_bfloat16>, grid, smem, stream,
                    static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), wf,
                    bf, h, wd, cin, cout, r, tiles_w);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
