// conv3x3_pixelshuffle: conv2d(x, w, b, padding=1) to r*r*cout channels,
// rounded to the activation type as ops/nn.py store_out does, then
// PixelShuffle(r) in torch's channel-major order:
//   out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j].
// The upsampler of RLFN (r = 4), and the x2 upsamplers of the HR tails of
// models 27, 28 and 33 (r = 2; ops/fused.py), whose widest convs take
// channel groups (TailGeom).
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
// 2-byte activations (fasthi16, fast16, fast),
// conv3x3_pixelshuffle_mma_kernel<T, P, R2>: the tensor cores, as one stage
// of the chain kernel's routine (mma_stage.cuh: mma.sync.m16n8k16 on
// activations of T with f32 accumulation; under fasthi16 f32 weights split
// into two f16 terms, f32-grade, P = 2; under fast16 and fast the weights
// packed once rounded to T, one exact product, P = 1, and the epilogue's
// two roundings, R2). What the design does about the card's limits:
//  - one persistent block per SM walks over the tiles; the stage's whole
//    packed weights (83 KB at 46 -> 48 under P = 2, 41 KB under P = 1) are
//    fetched into shared memory once per block with cp.async, so a kernel
//    row's weights are a constant offset and the MMA loop has no barrier;
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
//    pack_tail_f16, pack_tail_2byte), so the r*cout channels [i*r*cout,
//    (i+1)*r*cout) of a low-resolution pixel (y, x) are the contiguous run
//    of output row r*y + i at column r*x (24 bytes at RLFN's widths);
//  - the epilogue runs on the accumulator registers (unscale, bias, the
//    round to T, f16 saturating) and stores channel pairs straight into the
//    tile's output rows in shared memory (a table says where each channel
//    goes), and one tensor store writes the 64 rows of 528 bytes, clipped
//    at the image's edges, while the block goes on to the next tile;
//  - shapes whose rows are no multiples of 16 bytes take plain copies
//    instead: batched loads for the window, and stores in 8-, 4- or 2-byte
//    units with no division in the loop.
//
// f32 and bf16 activations with f32 weights (parity, high, mixed, fasthi),
// conv3x3_pixelshuffle_tf32_kernel: the same plan on split TF32
// (mma.sync.m16n8k8, mma_stage.cuh "split TF32": two TF32 terms of each
// weight, the activations split in registers, three products under f32
// activations and two under bf16; each tap summed from zero and added to
// the running sums in f32), with the same persistent blocks, shuffled
// channel order and epilogue. What differs:
//  - the whole packed weights would take 166 KB at 46 -> 48 (TF32 hi and
//    lo), which does not fit beside an f32 window, so one tap at a time is
//    staged with cp.async into a double buffer (18 KB), one barrier per
//    tap; the block's steps run on across tiles, so the next tile's first
//    tap arrives while this tile is written out;
//  - a warp holds 2 m-tiles (as the chain's split-TF32 kernel); a 16x22
//    tile up to 48 input channels (24 m-tiles: a pass of 2 a warp, then one
//    of 1), 16x14 (16 m-tiles, one pass) for the zoo's 50 and 64, where a
//    pixel takes 80 words;
//  - the window comes in by plain batched loads, which do not overlap the
//    MMAs: a second f32 window to land under them does not fit beside the
//    first (80 KB each at 46 channels), and a tensor copy cannot lay a
//    46-channel pixel (184 bytes) at the window's 48-word stride;
//  - the finished tile goes out by one tensor store where the shapes fit
//    (f32 at RLFN's 48-byte run of a pixel, as a rank-4 box; bf16 at an even
//    width, as rows of words), which drains while the next window comes in
//    and the next tile's first 8 taps run; otherwise by stores of the widest
//    unit the run allows.
// Bound: 19,872 MACs a pixel against 376 bytes a pixel at f32: bound by
// operations, 2.0 ms at batch 128 x 256^2 at 3 TF32 products a MAC on the
// card's 495 TFLOP/s; under bf16 activations 1.0 ms at 3 bf16 products (the
// weight split into three bf16 terms) on its 989 TFLOP/s, as in conv_chain.cu.
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <cstring>

#include "mma_stage.cuh"

namespace esr {

// ---- the 2-byte path on the tensor cores ------------------------------

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

__device__ inline void tensor_store_4d(const CUtensorMap* map, const void* src, int c0, int c1,
                                       int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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
// [whole packed weights of the block's channel group, wsz 16-byte units]
// [raw window boxes][result][window][scales and biases][channel table]
// [mbarrier], the middle ones in 32-bit words; the first three are
// multiples of 128 bytes, which the tensor copies ask of their
// shared-memory addresses. The stage's last m-tile reads up to kOverrun
// pixels past the window's pixels; the window has room for them.
//
// Channel groups. The conv's r*r*cout output channels, in the packed order
// k' = (i*r + j)*cout + c, are split into `groups` runs of cg channels: one
// group (the whole conv) where its weights and result fit a block, else one
// group a shuffle position (i, j), or a part of one, cout / cg of them a
// position. A block computes one group for every tile it takes; its result
// holds, for each pixel of the tile, the group's cg values, which belong at
// output row r*y + i, column r*x + j, channels from c0 on.
struct TailGeom {
  int kc, nt, nch;     // k-chunks of 16 inputs, n-tiles of 8 outputs of a group, their chunks
  int sw;              // words per pixel of the window
  int runh;            // f16 values of one pixel's run in an output row: r * cout
  int cg;              // channels of a group: r * r * cout where there is one group
  int rrow, pv;        // the result: pixels from one tile row to the next, values a pixel
  int hi, wi;          // window rows and pitch
  int tiles, passes;   // m-tiles of 16 output indices; passes of kWarps * MT m-tiles
  int ppb_log2, nbox;  // a window arrives as nbox boxes of hi rows x 2^ppb_log2 pixels
  int box_w;           // words of a box's row: its pixels and 4 more (see request_window)
  int box_words;       // from one box to the next in the raw buffer
  int wsz, win_words, raw_words, res_words, sbsz, tabsz;
};

// P: products a fragment (the packed weights' terms); groups: channel groups
__host__ __device__ inline TailGeom tail_geom(int cin, int cout, int r, Tile t, int P,
                                              int groups) {
  TailGeom g;
  g.kc = kchunks(cin);
  g.cg = cout * r * r / groups;
  g.nt = ntiles(g.cg);
  g.nch = cdiv(g.nt, kNtChunk);
  g.sw = pixel_words(cin);
  g.runh = r * cout;
  // one group: the tile's r*th output rows of tw runs of r*cout values;
  // more: the tile's th x tw pixels of cg values
  g.rrow = groups == 1 ? r * t.tw : t.tw;
  g.pv = groups == 1 ? g.runh : g.cg;
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  // output indices p = row * wi + c; the last one kept is (th - 1, tw - 1)
  g.tiles = cdiv(t.th * g.wi - 2, 16);
  g.passes = cdiv(g.tiles, kWarps * mtiles(P));
  // a box is at most 256 words wide: 8 pixels of up to 62 channels, else 4
  g.ppb_log2 = cin <= 62 ? 3 : 2;
  g.nbox = cdiv(g.wi, 1 << g.ppb_log2);
  g.box_w = (cin / 2 << g.ppb_log2) + 4;
  g.box_words = cdiv(g.hi * g.box_w * 4, 128) * 32;
  g.wsz = 9 * g.kc * g.nt * frag_units(P);
  g.raw_words = g.nbox * g.box_words;
  g.res_words = cdiv(t.th * g.rrow * g.pv * 2, 128) * 32;
  g.win_words = (g.hi * g.wi + kOverrun) * g.sw;
  g.sbsz = 2 * 8 * g.nt;
  g.tabsz = 8 * g.nt;
  return g;
}

__host__ __device__ inline size_t tail_mma_smem_bytes(int cin, int cout, int r, Tile t, int P,
                                                      int groups) {
  const TailGeom g = tail_geom(cin, cout, r, t, P, groups);
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
__device__ inline void copy_out_rows(const void* res, void* out, long long row0, int wd,
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

// The finished tile of one channel group to device memory with plain
// stores. The result holds, for each of the tile's th x tw pixels, the
// group's gb bytes; the first npx pixels of the first nrow tile rows go to
// output row r*y + i, column r*x + j, from byte c0b of the pixel's cout
// channels (cb bytes) on. The block walks over [tile row][pixel][unit], so
// that consecutive threads store consecutive units of one pixel's run, and
// no loop divides. U must divide gb (and with it cb and c0b) and out's
// alignment.
template <typename U>
__device__ inline void copy_out_group(const void* res, void* out, long long row0, int wd, int cb,
                                      int r, int i, int j, int c0b, int gb, int tw, int npx,
                                      int nrow, int tx0) {
  constexpr int kBatch = 6;  // loads from shared memory ahead of their stores
  constexpr int kU = static_cast<int>(sizeof(U));
  const char* src = reinterpret_cast<const char*>(res);
  char* dst = reinterpret_cast<char*>(out);
  const long long row_bytes = static_cast<long long>(wd) * r * cb;  // one output row of the image
  Walk wk(threadIdx.x, npx, gb / kU);
  while (wk.r < nrow) {
    U v[kBatch];
    long long e[kBatch];  // byte offset in out; -1: past the tile's rows
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      e[u] = -1;
      if (wk.r < nrow) {
        e[u] = ((row0 + wk.r) * r + i) * row_bytes +
               (static_cast<long long>(tx0 + wk.c) * r + j) * cb + c0b + wk.q * kU;
        v[u] = *reinterpret_cast<const U*>(src + (wk.r * tw + wk.c) * gb + wk.q * kU);
      }
      wk.step();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e[u] >= 0) *reinterpret_cast<U*>(dst + e[u]) = v[u];
  }
}

// copy_out_group in the widest unit that gb and out's alignment allow
__device__ inline void copy_out_group_any(const void* res, void* out, long long row0, int wd,
                                          int cb, int r, int i, int j, int c0b, int gb, int tw,
                                          int npx, int nrow, int tx0) {
  const int a = gb | static_cast<int>(reinterpret_cast<uintptr_t>(out) & 15);
  if (a % 16 == 0)
    copy_out_group<uint4>(res, out, row0, wd, cb, r, i, j, c0b, gb, tw, npx, nrow, tx0);
  else if (a % 8 == 0)
    copy_out_group<uint2>(res, out, row0, wd, cb, r, i, j, c0b, gb, tw, npx, nrow, tx0);
  else if (a % 4 == 0)
    copy_out_group<uint32_t>(res, out, row0, wd, cb, r, i, j, c0b, gb, tw, npx, nrow, tx0);
  else
    copy_out_group<unsigned short>(res, out, row0, wd, cb, r, i, j, c0b, gb, tw, npx, nrow, tx0);
}

// x: NHWC (nimg, h, wd, cin) of T; out: NHWC (nimg, r*h, r*wd, cout) of T
// (__half: fasthi16, P = 2, and fast16, P = 1 with R2; __nv_bfloat16:
// fast, P = 1 with R2). wq: the packed weights of ops/kernels/tail.py
// pack_tail_f16 (P = 2) or pack_tail_2byte (P = 1): output channels in the
// order (i, j, c), then [chunk of n-tiles][ky][kx][k-chunk][n-tile][lane]
// [{b0, b1} of each term]. sb: [1/S per channel][bias per channel] in that
// order, padded to whole n-tiles (1 and 0 in the pad); S = 1 under P = 1.
// With more than one channel group (TailGeom) wq and sb hold the groups one
// after the other, each packed as a stage of its own. One block walks over
// the items blockIdx.x, blockIdx.x + gridDim.x, ... (item = tile * groups +
// group, tile = image * tiles_h * tiles_w + tile row * tiles_w + tile
// column); gridDim.x is a multiple of groups, so a block keeps one group.
// GROUPED: more than one group (ngroups); the one-group instantiation
// compiles the plan without them.
// tensor_in, tensor_out: the input's / output's rows are such that tensor
// copies can move them (the host function says when): in_map is x as
// 32-bit words (wd * cin / 2, h, nimg) with boxes of (box_w words, hi rows),
// out_map is out as words (wd * r * cout / 2, r * h, nimg) with
// boxes of one tile. Otherwise plain loads and stores do the copies.
// R2: the two roundings (epilogue_value).
template <typename T, int P, bool R2, bool GROUPED>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_pixelshuffle_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    const uint4* __restrict__ wq, const float* __restrict__ sb,
                                    int nimg, int h, int wd, int cin, int cout, int r, Tile tile,
                                    int ngroups, int tiles_h, int tiles_w, int tensor_in,
                                    int tensor_out, const __grid_constant__ CUtensorMap in_map,
                                    const __grid_constant__ CUtensorMap out_map) {
  using Op = Op2<T>;
  const int groups = GROUPED ? ngroups : 1;
  constexpr int MT = mtiles(P);
  extern __shared__ __align__(128) uint4 smem16[];
  const TailGeom gm = tail_geom(cin, cout, r, tile, P, groups);
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
  const int grp = blockIdx.x % groups;  // this block's channel group

  // once per block: the group's weights (in flight until the first tile's
  // barrier), scales and biases, and where a channel goes in the result:
  // with one group, channel k' = (i*r + j)*cout + c of a pixel lies i output
  // rows down, at (j, c) of the pixel's run; in f16 values from the pixel's
  // run in row 0; with more, channel k' of the group is value k' of the
  // pixel's cg; -1: pad
  stage_weights_async(wsm, wq + static_cast<size_t>(grp) * gm.wsz, gm.wsz);
  for (int i = threadIdx.x; i < gm.sbsz; i += kThreads) ssb[i] = __ldg(sb + grp * gm.sbsz + i);
  for (int i = threadIdx.x; i < gm.tabsz; i += kThreads)
    tab[i] = GROUPED ? (i < gm.cg ? i : -1)
                     : i < nchan ? (i / gm.runh) * tile.tw * gm.runh + i % gm.runh : -1;
  if (tensor_in) {
    // the pad channels stay zero: re-laying a window writes the others only
    for (int i = threadIdx.x; i < gm.win_words; i += kThreads) win[i] = 0u;
    if (threadIdx.x == 0) mbar_init(bar, 1);
  }
  __syncthreads();

  const int per_img = tiles_h * tiles_w;
  const int total = nimg * per_img * groups;  // items
  auto origin = [&](int tl, int& n, int& ty0, int& tx0) {
    const int tile_i = tl / groups;
    n = tile_i / per_img;
    const int rem = tile_i - n * per_img;
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
  float acc[P][MT][kNtChunk][4];  // this warp's sums, one set a term
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
      load_window_2byte(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);
    }
    cp_async_wait_all();
    if (store_pending) bulk_wait_read();
    __syncthreads();  // the window is whole (and the weights); raw and result are free again
    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) request_window(tl + gridDim.x);

    for (int pass = 0; pass < gm.passes; ++pass) {
      // MT m-tiles a warp while that many are left, the rest split evenly
      const int first = pass * kWarps * MT;
      const int left = gm.tiles - first;
      const int here = left < kWarps * MT ? left : kWarps * MT;
      const int mt0 = first + warp * here / kWarps;
      const int cnt = first + (warp + 1) * here / kWarps - mt0;
      if (cnt == 0) continue;  // the same in all lanes of the warp
      // the up to 2 * MT pixels of this lane (rows g and g+8 of each
      // m-tile): where the pixel's run starts in the result's row 0 of its
      // tile row, in 2-byte values; -1: dropped (beyond cnt, and the pitch
      // trick's garbage columns and rows)
      int px[MT][2];
      {
        int rr = (mt0 * 16 + g) / gm.wi, c = mt0 * 16 + g - rr * gm.wi;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            px[m][hr] = (m < cnt && rr < tile.th && c < tile.tw) ? (rr * gm.rrow + c) * gm.pv : -1;
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
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int nn = 0; nn < kNtChunk; ++nn)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[p][m][nn][i] = 0.f;
        const Frag<P>* wch =
            reinterpret_cast<const Frag<P>*>(wsm) + 9 * gm.kc * kNtChunk * 32 * nc + lane;
#pragma unroll 1
        for (int ky = 0; ky < 3; ++ky) {
          const uint32_t* arow = a0 + ky * gm.wi * gm.sw;
          const Frag<P>* wrow = wch + 3 * gm.kc * ntl * 32 * ky;
          if constexpr (GROUPED)
            mma_conv_row_group<T, P, MT>(acc, arow, gm.sw, gm.kc, cnt, ntl, wrow, nothing);
          else
            mma_conv_row_any<T, P, MT>(acc, arow, gm.sw, gm.kc, cnt, ntl, wrow, nothing);
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
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              // computed for dropped pixels too (their sums are zeros or
              // garbage): only the store is conditional, so nothing branches
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[e] = epilogue_value<T, P, R2>(acc[0][m][nn][2 * hr + e],
                                                acc[P - 1][m][nn][2 * hr + e], e ? s2.y : s2.x,
                                                e ? b2.y : b2.x);
              const typename Op::T2 y2 = Op::pack(v[0], v[1]);
              const uint32_t yb = *reinterpret_cast<const uint32_t*>(&y2);
              if (gm.pv % 2 == 0) {
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
    if (GROUPED) {
      const int per_ij = cout / gm.cg;  // groups of one shuffle position
      const int ij = grp / per_ij, c0 = (grp - ij * per_ij) * gm.cg;
      copy_out_group_any(res, out, row0, wd, 2 * cout, r, ij / r, ij % r, 2 * c0, 2 * gm.cg,
                         tile.tw, npx, nrow, tx0);
    } else if (tensor_out) {
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

// An output tile and the number of channel groups (TailGeom) of a launch.
struct TailPlan {
  Tile tile;
  int groups;
};

// The plan of a kernel that needs bytes(tile, groups) of shared memory a
// block: the whole conv in one group at a 16x22 or a 16x14 tile where it
// fits (every r = 4 tail of the zoo, and RLFN's, takes such a plan), else one
// group a shuffle position (i, j) at those tiles, then 2, 3, ... groups a
// position (each a whole share of cout); then the same order at 8x14 and
// 8x8 tiles. The last plan if none fits (the host function refuses it). A
// tile of th x tw has ceil((th * (tw + 2) - 2) / 16) m-tiles: 24, 16 and 8
// of them split evenly over the 8 warps.
template <typename Bytes>
inline TailPlan pick_plan(int cout, int r, Bytes bytes) {
  const Tile tiles[2][2] = {{{16, 22}, {16, 14}}, {{8, 14}, {8, 8}}};
  for (int size = 0; size < 2; ++size)
    for (int s = 0; s <= cout; ++s) {  // s = 0: one group; else s groups a position
      if (s > 0 && cout % s) continue;
      const int groups = s ? r * r * s : 1;
      for (const Tile& t : tiles[size])
        if (bytes(t, groups) <= kMaxSmem) return {t, groups};
    }
  return {tiles[1][1], 1};
}

// the plan of the m16n8k16 kernel with P products
inline TailPlan pick_tail_plan(int cin, int cout, int r, int P) {
  return pick_plan(cout, r, [&](Tile t, int g) {
    return tail_mma_smem_bytes(cin, cout, r, t, P, g);
  });
}

// ---- the f32 and bf16 paths on split TF32 -----------------------------

// Widths, regions and work split of the split-TF32 tail, and its shared
// memory: [2 weight buffers of wsz 16-byte units][window][result][biases]
// [channel table], the last four in 32-bit words. A weight buffer holds one
// tap of one chunk of n-tiles. The window has room for the kOverrun pixels
// that the stage's last m-tile reads past it, and ends at a multiple of 128
// bytes, where the tensor store wants the result.
struct TailGeom32 {
  int kc, nt, nch;    // k-chunks of 16 inputs, n-tiles of 8 outputs of a group, their chunks
  int sw;             // words per pixel of the window
  int runh;           // values of one pixel's run in an output row: r * cout
  int cg, rrow, pv;   // channel groups as in TailGeom
  int hi, wi;         // window rows and pitch
  int tiles, passes;  // m-tiles of 16 output indices; passes of kWarps * kMT32 m-tiles
  int steps;          // staged taps per tile: passes * nch * 9
  int wsz, win_words, res_words, bsz, tabsz;
};

__host__ __device__ inline TailGeom32 tail_geom32(int cin, int cout, int r, Tile t, int vbytes,
                                                  int groups) {
  TailGeom32 g;
  g.kc = kchunks(cin);
  g.cg = cout * r * r / groups;
  g.nt = ntiles(g.cg);
  g.nch = cdiv(g.nt, kNtChunk);
  g.sw = pixel_words_f32(cin);
  g.runh = r * cout;
  g.rrow = groups == 1 ? r * t.tw : t.tw;
  g.pv = groups == 1 ? g.runh : g.cg;
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  g.tiles = cdiv(t.th * g.wi - 2, 16);
  g.passes = cdiv(g.tiles, kWarps * kMT32);
  g.steps = g.passes * g.nch * 9;
  g.wsz = g.kc * (g.nt < kNtChunk ? g.nt : kNtChunk) * 64;
  g.win_words = cdiv((g.hi * g.wi + kOverrun) * g.sw, 32) * 32;
  g.res_words = cdiv(t.th * g.rrow * g.pv * vbytes, 16) * 4;
  g.bsz = 8 * g.nt;
  g.tabsz = 8 * g.nt;
  return g;
}

__host__ __device__ inline size_t tail_tf32_smem_bytes(int cin, int cout, int r, Tile t,
                                                       int vbytes, int groups) {
  const TailGeom32 g = tail_geom32(cin, cout, r, t, vbytes, groups);
  return static_cast<size_t>(2) * g.wsz * 16 +
         static_cast<size_t>(g.win_words + g.res_words + g.bsz + g.tabsz) * 4;
}

// x: NHWC (nimg, h, wd, cin) of T (float: parity, high and mixed, P = 3;
// bf16: fasthi, P = 2; P = 1 only in the control of tools/chain_check.py);
// out: NHWC (nimg, r*h, r*wd, cout) of T. wq: the packed
// weights of ops/kernels/tail.py pack_tail_tf32: output channels in the
// order (i, j, c), then [chunk of n-tiles][tap][k-chunk][n-tile][hi, lo]
// [lane][4 words]. bias: in that order, padded to whole n-tiles. With more
// than one channel group both hold the groups one after the other, each
// packed as a stage of its own. One block walks over the items blockIdx.x,
// blockIdx.x + gridDim.x, ... (item = tile * groups + group, tile = image *
// tiles_h * tiles_w + tile row * tiles_w + tile column; gridDim.x is a
// multiple of groups, so a block keeps one group; GROUPED as in the
// m16n8k16 kernel); its weight
// steps (a tap of a chunk of a pass) run on across tiles, so the next
// tile's first tap is in flight while the next window comes in.
// out_rank: 0, plain stores; 4, one tensor store a tile through out_map, out
// as (run words, wd, r * h, nimg) with boxes (run words, tw, r * th, 1),
// where a pixel's run is a multiple of 16 bytes; 3, out_map as in the f16
// kernel, rows of words (wd * run / 4, r * h, nimg) with boxes of a tile's
// rows. The store drains while the next window comes in and is waited for
// before the next tile's first epilogue writes the result.
template <typename T, int P, bool GROUPED = false>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_pixelshuffle_tf32_kernel(const T* __restrict__ x, T* __restrict__ out,
                                     const uint4* __restrict__ wq, const float* __restrict__ bias,
                                     int nimg, int h, int wd, int cin, int cout, int r, Tile tile,
                                     int ngroups, int tiles_h, int tiles_w, int out_rank,
                                     const __grid_constant__ CUtensorMap out_map) {
  extern __shared__ __align__(128) uint4 smem16[];
  const int groups = GROUPED ? ngroups : 1;
  const TailGeom32 gm = tail_geom32(cin, cout, r, tile, sizeof(T), groups);
  uint4* const wbuf0 = smem16;
  float* const win = reinterpret_cast<float*>(smem16 + 2 * gm.wsz);
  T* const res = reinterpret_cast<T*>(win + gm.win_words);
  float* const sbias = win + gm.win_words + gm.res_words;
  int* const tab = reinterpret_cast<int*>(sbias + gm.bsz);
  auto wbuf = [&](int b) { return wbuf0 + (b & 1) * gm.wsz; };
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nchan = cout * r * r;
  const int run = gm.runh * static_cast<int>(sizeof(T));  // bytes of a pixel's run in an output row
  const int grp = blockIdx.x % groups;  // this block's channel group
  const uint4* const wg = wq + static_cast<size_t>(grp) * 9 * gm.kc * gm.nt * 64;

  // where a channel goes in the result, as in the m16n8k16 kernel: with one
  // group, channel k' = (i*r + j)*cout + c of a pixel lies i output rows
  // down, at (j, c) of the pixel's run; in values from the pixel's run in
  // row 0; with more, channel k' of the group is value k' of the pixel's
  // cg; -1: pad
  for (int i = threadIdx.x; i < gm.bsz; i += kThreads) sbias[i] = __ldg(bias + grp * gm.bsz + i);
  for (int i = threadIdx.x; i < gm.tabsz; i += kThreads)
    tab[i] = GROUPED ? (i < gm.cg ? i : -1)
                     : i < nchan ? (i / gm.runh) * tile.tw * gm.runh + i % gm.runh : -1;

  const int per_img = tiles_h * tiles_w;
  const int total = nimg * per_img * groups;  // items
  auto origin = [&](int tl, int& n, int& ty0, int& tx0) {
    const int tile_i = tl / groups;
    n = tile_i / per_img;
    const int rem = tile_i - n * per_img;
    const int ty = rem / tiles_w;
    ty0 = ty * tile.th;
    tx0 = (rem - ty * tiles_w) * tile.tw;
  };
  // step s of a tile: tap s % 9 of chunk (s / 9) % nch of pass s / (9 nch)
  auto fetch = [&](int s, uint4* dst) {
    const int nc = (s / 9) % gm.nch;
    const int left = gm.nt - nc * kNtChunk;
    const int n16 = gm.kc * (left < kNtChunk ? left : kNtChunk) * 64;
    stage_weights_async(dst, wg + 9 * gm.kc * kNtChunk * 64 * nc + n16 * (s % 9), n16);
  };

  int tl = blockIdx.x;
  if (tl < total) {
    fetch(0, wbuf(0));
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    load_window_f32(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);
  }
  float sum[kMT32][kNtChunk][4];  // this warp's running sums of the pass
  int j = 0;  // weight steps of this block so far: step j reads wbuf(j)
  // thread 0's tensor store of the last tile may still read the result; the
  // map's address is taken here, in the kernel's own scope
  bool store_pending = false;
  const CUtensorMap* const out_map_at = &out_map;
  while (tl < total) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    const bool more = tl + static_cast<int>(gridDim.x) < total;
    int mt0 = 0, cnt = 0;  // this warp's m-tiles in the current pass
    for (int s = 0; s < gm.steps; ++s, ++j) {
      if (s == 8 && store_pending) {  // the tile's first epilogue comes after this barrier
        bulk_wait_read();
        store_pending = false;
      }
      cp_async_wait_all();
      __syncthreads();  // this tap's weights (and, at s = 0, the window) are in place
      if (s + 1 < gm.steps || more) fetch(s + 1 == gm.steps ? 0 : s + 1, wbuf(j + 1));
      const int tap = s % 9, nc = (s / 9) % gm.nch, pass = s / (9 * gm.nch);
      const int ntl = gm.nt - nc * kNtChunk < kNtChunk ? gm.nt - nc * kNtChunk : kNtChunk;
      if (tap == 0) {
        // kMT32 m-tiles a warp while that many are left, the rest split evenly
        const int first = pass * kWarps * kMT32;
        const int left = gm.tiles - first;
        const int here = left < kWarps * kMT32 ? left : kWarps * kMT32;
        mt0 = first + warp * here / kWarps;
        cnt = first + (warp + 1) * here / kWarps - mt0;
#pragma unroll
        for (int m = 0; m < kMT32; ++m)
#pragma unroll
          for (int nn = 0; nn < kNtChunk; ++nn)
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[m][nn][i] = 0.f;
      }
      const int ky = tap / 3, kx = tap - 3 * ky;
      const float* a = win + (mt0 * 16 + g + ky * gm.wi + kx) * gm.sw + 4 * t;
      const uint4* wt = wbuf(j) + lane;
      mma_tap_tf32_any<P, kMT32>(sum, a, gm.sw, gm.kc, cnt, ntl, wt);
      if (tap != 8 || cnt == 0) continue;

      // the epilogue on the running sums: + bias, rounded to T,
      // into the result where the table says. The up to 2 * kMT32 pixels of
      // this lane (rows g and g+8 of each m-tile): where the pixel's run
      // starts in the result's row 0 of its tile row; -1: dropped
      int px[kMT32][2];
      {
        int rr = (mt0 * 16 + g) / gm.wi, c = mt0 * 16 + g - rr * gm.wi;
#pragma unroll
        for (int m = 0; m < kMT32; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            px[m][hr] = (m < cnt && rr < tile.th && c < tile.tw) ? (rr * gm.rrow + c) * gm.pv : -1;
            c += 8;  // the pitch is at least 10, so this wraps once at most
            if (c >= gm.wi) {
              c -= gm.wi;
              ++rr;
            }
          }
        }
      }
#pragma unroll
      for (int nn = 0; nn < kNtChunk; ++nn) {
        if (nn >= ntl) continue;
        const int ntg = nc * kNtChunk + nn;
        const float2 b2 = reinterpret_cast<const float2*>(sbias + 8 * ntg)[t];
        const int2 to = reinterpret_cast<const int2*>(tab + 8 * ntg)[t];
#pragma unroll
        for (int m = 0; m < kMT32; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float v0 = Act<T>::store_out(sum[m][nn][2 * hr] + b2.x);
            const float v1 = Act<T>::store_out(sum[m][nn][2 * hr + 1] + b2.y);
            if (gm.pv % 2 == 0) {
              // an even run: the pair lies in one run at an even place
              if ((px[m][hr] | to.x) >= 0) store_pair(res + px[m][hr] + to.x, make_float2(v0, v1));
            } else {
              if ((px[m][hr] | to.x) >= 0) res[px[m][hr] + to.x] = Act<T>::store(v0);
              if ((px[m][hr] | to.y) >= 0) res[px[m][hr] + to.y] = Act<T>::store(v1);
            }
          }
        }
      }
    }

    if (out_rank) fence_async_proxy();
    __syncthreads();  // every warp is done with the window, and the result is whole
    // the finished tile out: by one tensor store that drains under the next
    // window's load (the image's edges clip it), or with plain stores in the
    // widest unit that the run and the output's alignment allow; then the
    // next tile's window in
    const int npx = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const long long row0 = static_cast<long long>(n) * h + ty0;  // the tile's first image row
    const uintptr_t base = reinterpret_cast<uintptr_t>(out);
    if (GROUPED) {
      const int vb = static_cast<int>(sizeof(T)), per_ij = cout / gm.cg;
      const int ij = grp / per_ij, c0 = (grp - ij * per_ij) * gm.cg;
      copy_out_group_any(res, out, row0, wd, vb * cout, r, ij / r, ij % r, vb * c0, vb * gm.cg,
                         tile.tw, npx, nrow, tx0);
    } else if (out_rank) {
      if (threadIdx.x == 0) {
        if (out_rank == 4)
          tensor_store_4d(out_map_at, res, 0, tx0, ty0 * r, n);
        else
          tensor_store_3d(out_map_at, res, tx0 * (run / 4), ty0 * r, n);
        bulk_commit();
        store_pending = true;
      }
    } else if (run % 16 == 0 && base % 16 == 0) {
      copy_out_rows<uint4>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else if (run % 8 == 0 && base % 8 == 0) {
      copy_out_rows<uint2>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else if (run % 4 == 0 && base % 4 == 0) {
      copy_out_rows<uint32_t>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else {
      copy_out_rows<unsigned short>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    }
    tl += gridDim.x;
    if (more) {
      origin(tl, n, ty0, tx0);
      load_window_f32(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);
    }
  }
  if (store_pending) bulk_wait_read();  // before the shared memory goes
}

// The plan of the split-TF32 kernel on values of vbytes (pick_plan): at the
// zoo's r = 4 widths 16x22 (24 m-tiles) up to 48 input channels, 16x14 (16
// m-tiles) above, in one group.
inline TailPlan pick_tail_plan32(int cin, int cout, int r, int vbytes) {
  return pick_plan(cout, r, [&](Tile t, int g) {
    return tail_tf32_smem_bytes(cin, cout, r, t, vbytes, g);
  });
}

}  // namespace esr

using namespace esr;

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (null if
// it has none)
typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The launch of one instantiation of the m16n8k16 kernel, GROUPED where the
// plan has more than one channel group.
template <typename T, int P, bool R2>
static int launch_tail_mma(dim3 grid, size_t smem, void* stream, const void* x, void* out,
                           const uint4* wq, const float* sb, int n, int h, int wd, int cin,
                           int cout, int r, Tile t, int groups, int tiles_h, int tiles_w,
                           int tensor_in, int tensor_out, const CUtensorMap& in_map,
                           const CUtensorMap& out_map) {
  auto kernel = groups > 1 ? conv3x3_pixelshuffle_mma_kernel<T, P, R2, true>
                           : conv3x3_pixelshuffle_mma_kernel<T, P, R2, false>;
  return launch(kernel, grid, smem, stream, static_cast<const T*>(x), static_cast<T*>(out), wq,
                sb, n, h, wd, cin, cout, r, t, groups, tiles_h, tiles_w, tensor_in, tensor_out,
                in_map, out_map);
}

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

// The plan of the kernel that takes dtype and fast (as in
// conv3x3_pixelshuffle)
static TailPlan plan_of(int dtype, int fast, int cin, int cout, int r) {
  const int P = mma_products(dtype, fast);
  return P ? pick_tail_plan(cin, cout, r, P) : pick_tail_plan32(cin, cout, r, dtype == 0 ? 4 : 2);
}

// Dynamic shared memory one block needs, in bytes. dtype and fast as in
// conv3x3_pixelshuffle.
extern "C" long long conv3x3_pixelshuffle_smem_bytes(int dtype, int fast, int cin, int cout,
                                                     int r) {
  const TailPlan pl = plan_of(dtype, fast, cin, cout, r);
  const int P = mma_products(dtype, fast);
  if (P) return static_cast<long long>(tail_mma_smem_bytes(cin, cout, r, pl.tile, P, pl.groups));
  return static_cast<long long>(
      tail_tf32_smem_bytes(cin, cout, r, pl.tile, dtype == 0 ? 4 : 2, pl.groups));
}

// The channel groups of the launch (TailGeom), in which the weights are
// packed: 1, or r * r * s with s dividing cout. dtype and fast as in
// conv3x3_pixelshuffle.
extern "C" int conv3x3_pixelshuffle_groups(int dtype, int fast, int cin, int cout, int r) {
  return plan_of(dtype, fast, cin, cout, r).groups;
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, cin) NHWC contiguous;
// out: (n, r*h, r*wd, cout) NHWC contiguous.
// fast = 0, dtype 1 (fasthi16): w is the f16 hi/lo split in fragment order
// with the output channels in shuffled order, and b the scales and biases,
// as conv3x3_pixelshuffle_mma_kernel<__half, 2, false> reads them.
// fast = 1, dtype 1 or 2 (fast16, fast): w is the weights rounded to the
// activation type, one term in fragment order with the output channels in
// shuffled order, and b scales of 1 and the biases rounded to it, as
// conv3x3_pixelshuffle_mma_kernel<T, 1, true> reads them.
// fast = 0, dtype 0 and 2 (parity, high, mixed, fasthi): w is the TF32
// hi/lo split in fragment order with the output channels in shuffled order,
// and b the biases, as conv3x3_pixelshuffle_tf32_kernel reads them.
// In every case w and b hold conv3x3_pixelshuffle_groups() channel groups
// one after the other, each packed as a stage of its own.
// Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_pixelshuffle(int dtype, int fast, const void* x, void* out, const void* w,
                                    const void* b, int n, int h, int wd, int cin, int cout,
                                    int r, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wd < 1 || cin < 1 || cout < 1 || r < 1 || dtype < 0 ||
      dtype > 2 || (fast && dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(conv3x3_pixelshuffle_smem_bytes(dtype, fast, cin, cout, r));
  const float* bf = static_cast<const float*>(b);
  const int P = mma_products(dtype, fast);
  const TailPlan pl = plan_of(dtype, fast, cin, cout, r);
  const Tile t = pl.tile;
  const int groups = pl.groups;
  const int tiles_h = cdiv(h, t.th), tiles_w = cdiv(wd, t.tw);
  const long long total = static_cast<long long>(n) * tiles_h * tiles_w * groups;  // items
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // one block per SM walks over the items, a whole number of blocks a
  // group (total is a multiple of groups)
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = sms >= groups ? sms / groups * groups : groups;
  const dim3 grid(static_cast<unsigned>(total < blocks ? total : blocks));
  const uint4* wq = static_cast<const uint4*>(w);
  if (!P) {
    // The tile's result goes out by one tensor store where the shapes let
    // it: rank 4 where a pixel's run in an output row is a multiple of 16
    // bytes (f32 at RLFN's 12 values), else rank 3 over whole output rows
    // of words where those and a tile's rows are multiples of 16 bytes and
    // a tile's row is at most 256 words (bf16 at an even width).
    const long long vb = dtype == 0 ? 4 : 2;
    const long long run = vb * r * cout, out_row = run * wd, tile_row = run * t.tw;
    const bool out_ok =
        groups == 1 && reinterpret_cast<uintptr_t>(out) % 16 == 0 && t.th * r <= 256;
    int out_rank = 0;
    if (out_ok && run % 16 == 0 && run / 4 <= 256)
      out_rank = 4;
    else if (out_ok && run % 4 == 0 && out_row % 16 == 0 && tile_row % 16 == 0 &&
             tile_row / 4 <= 256)
      out_rank = 3;
    CUtensorMap out_map;
    memset(&out_map, 0, sizeof(out_map));
    if (out_rank) {
      const TensorMapEncode encode = tensor_map_encoder();
      if (!encode) return static_cast<int>(cudaErrorNotSupported);
      const cuuint32_t ones[4] = {1, 1, 1, 1};
      const cuuint64_t rows = static_cast<cuuint64_t>(h) * r;
      CUresult res;
      if (out_rank == 4) {
        const cuuint64_t dims[4] = {static_cast<cuuint64_t>(run / 4),
                                    static_cast<cuuint64_t>(wd), rows,
                                    static_cast<cuuint64_t>(n)};
        const cuuint64_t strides[3] = {static_cast<cuuint64_t>(run),
                                       static_cast<cuuint64_t>(out_row),
                                       static_cast<cuuint64_t>(out_row) * rows};
        const cuuint32_t box[4] = {static_cast<cuuint32_t>(run / 4),
                                   static_cast<cuuint32_t>(t.tw),
                                   static_cast<cuuint32_t>(t.th * r), 1};
        res = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, out, dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      } else {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(out_row / 4), rows,
                                    static_cast<cuuint64_t>(n)};
        const cuuint64_t strides[2] = {static_cast<cuuint64_t>(out_row),
                                       static_cast<cuuint64_t>(out_row) * rows};
        const cuuint32_t box[3] = {static_cast<cuuint32_t>(tile_row / 4),
                                   static_cast<cuuint32_t>(t.th * r), 1};
        res = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, out, dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      }
      if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
    }
    // one line a kernel: tools/chain_check.py --one-product patches the
    // one-group bf16 launch
    const auto go = [&](auto kernel, auto* xt) {
      using T = typename std::remove_const<typename std::remove_pointer<decltype(xt)>::type>::type;
      return launch(kernel, grid, smem, stream, xt, static_cast<T*>(out), wq, bf, n, h, wd, cin,
                    cout, r, t, groups, tiles_h, tiles_w, out_rank, out_map);
    };
    const float* xf = static_cast<const float*>(x);
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    if (dtype == 0)
      return groups > 1 ? go(conv3x3_pixelshuffle_tf32_kernel<float, 3, true>, xf)
                        : go(conv3x3_pixelshuffle_tf32_kernel<float, 3>, xf);
    return groups > 1 ? go(conv3x3_pixelshuffle_tf32_kernel<__nv_bfloat16, 2, true>, xb)
                      : go(conv3x3_pixelshuffle_tf32_kernel<__nv_bfloat16, 2>, xb);
  }
  // Tensor copies take rows that are multiples of 16 bytes from a 16-byte
  // aligned base, boxes of at most 256 elements a side, and whole 32-bit
  // words: channel pairs of the input, a pixel's run of the output. The
  // maps view both tensors as words, whatever the 2-byte type.
  const TailGeom gm = tail_geom(cin, cout, r, t, P, groups);
  const long long in_row = static_cast<long long>(wd) * cin * 2;
  const long long out_row = static_cast<long long>(wd) * r * cout * 2;
  const int box_w = t.tw * r * cout * 2;  // bytes of one output row of a tile
  int tensor_in = cin % 2 == 0 && cin <= 126 && in_row % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 && gm.hi <= 256;
  int tensor_out = groups == 1 && (r * cout) % 2 == 0 && out_row % 16 == 0 && box_w % 16 == 0 &&
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
  if (fast && dtype == 1)
    return launch_tail_mma<__half, 1, true>(grid, smem, stream, x, out, wq, bf, n, h, wd, cin,
                                            cout, r, t, groups, tiles_h, tiles_w, tensor_in,
                                            tensor_out, in_map, out_map);
  if (fast)
    return launch_tail_mma<__nv_bfloat16, 1, true>(grid, smem, stream, x, out, wq, bf, n, h, wd,
                                                   cin, cout, r, t, groups, tiles_h, tiles_w,
                                                   tensor_in, tensor_out, in_map, out_map);
  return launch_tail_mma<__half, 2, false>(grid, smem, stream, x, out, wq, bf, n, h, wd, cin, cout,
                                           r, t, groups, tiles_h, tiles_w, tensor_in, tensor_out,
                                           in_map, out_map);
}
