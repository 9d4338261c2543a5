// conv3x3_pixelshuffle: conv2d(x, w, b, padding=1) to r*r*cout channels,
// rounded to the activation type as ops/nn.py store_out does, then
// PixelShuffle(r) in torch's channel-major order:
//   out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j].
// The x4 upsamplers of RLFN and of 34 other zoo models (r = 4), the
// library's upsamplers, and the x2 upsamplers of the HR tails of models
// 27, 28 and 33 (r = 2; ops/fused.py), whose widest convs take channel
// groups (TailGeom).
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
// 128 x 256^2 and the bytes 0.47 ms at 3.35 TB/s: it is bound by bytes
// under one product; fasthi16's two products take 0.67 ms and bound it.
//
// Four kernels share that plan. The conv's channels are packed in the
// order k' = (i*r + j)*cout + c (ops/kernels/tail.py shuffled_order), so
// the shuffle costs nothing in the MMAs: the r*cout channels
// [i*r*cout, (i+1)*r*cout) of a low-resolution pixel (y, x) are the
// contiguous run of output row r*y + i at column r*x (24 bytes at RLFN's
// widths). Every kernel's epilogue runs on the accumulator registers
// (unscale, bias, the round to the activation type, f16 saturating) and
// stores channel pairs straight into the tile's output rows in shared
// memory, where a table says each channel goes.
//
// 2-byte activations (fasthi16, fast16, fast) in one channel group,
// conv3x3_pixelshuffle_wgmma_kernel<T, P, R2>: the conv as one stage of
// the chain's warpgroup-MMA design (conv_chain.cu, wgmma_chain.cuh),
// wgmma.mma_async.m64nNk16 with f32 accumulation and both operands read
// from shared memory through matrix descriptors. M = output indices in
// m-blocks of 64 (the pitch trick of mma_stage.cuh: index row * wi + c, a
// tap an offset of ky * wi + kx pixels, the two columns past each row
// dropped), K = 9 taps x input channels in k-chunks of 16, N = the 48 conv
// channels of one step (kStepNt n-tiles of 8). Under fasthi16 (P = 2) the
// f32 weights are split into two f16 terms side by side in N (N = 96: hi,
// then lo; f32-grade); under fast16 and fast (P = 1) they are packed once
// rounded to T, one exact product a MAC, and the epilogue rounds each sum
// to T before it adds the bias (R2: two roundings, as ops/nn.py conv2d
// computes a 2-byte contraction's output). The products are summed in f32
// over the whole conv. What the design does about the card's limits:
//  - one persistent block an SM, three warpgroups (384 threads). The
//    conv's packed weights, every step of them (83 KB at 46 -> 48 under
//    P = 2, 41 KB under P = 1), arrive once a block by bulk copies
//    (cp.async.bulk) to one mbarrier, so a tap's B operand is a constant
//    offset and an MMA waits for nothing but its own group;
//  - the window as planes of 8 channels, 16 bytes a pixel a plane: 8
//    consecutive output indices at any tap offset are one 128-byte core
//    matrix, so a descriptor (LBO a plane, SBO 8 pixels) addresses an
//    m-block at any tap; no ldmatrix, so no pad words (96 bytes a pixel at
//    46 channels against the m16n8k16 kernel's 112). The planes lie an odd
//    number of pixels apart, so that one pixel's words fall in different
//    banks;
//  - a 16x22 tile is 6 m-blocks, two for each warpgroup. A warpgroup
//    issues a step's 9 kc MMAs of its m-block as one group and waits for
//    them before its epilogue (an epilogue that reads one accumulator set
//    while another set's MMAs are pending makes ptxas serialize every
//    MMA); all three warpgroups issue at once and share the tensor cores.
//    A conv wider than one step (SCET's 64 channels, the x2 upsamplers' 96
//    and 128) runs its steps one after the other on the same m-block, its
//    last step zero-padded;
//  - the next tile's window arrives under this tile's MMAs: tensor copies
//    (TMA, cp.async.bulk.tensor) bring its rows as boxes into a raw buffer
//    and report to an mbarrier; what lies outside the image arrives as
//    zeros. A pixel is 92 bytes there at RLFN's widths, which no tensor map
//    can lay out as planes (its rows are no multiple of 16 bytes), so all
//    warps re-lay the window into the planes when it has landed, a warp a
//    box row at a time, each lane's plane offsets computed once a block.
//    The planes take the next window only when every MMA of the
//    tile is done: one buffer of planes (a second does not fit beside
//    fasthi16's weights, 4-byte copies of the next window into it under
//    the MMAs, measured under every tier, slowed them, and warpgroups
//    taking turns at the tensor cores were slower: ROADMAP, Decisions on
//    the tail's warpgroup MMA);
//  - one tensor store writes the finished tile's r*th rows of r*tw*cout
//    values (64 rows of 528 bytes at RLFN's widths), clipped at the
//    image's edges, while the block goes on to the next tile;
//  - shapes whose rows are no multiples of 16 bytes take plain copies
//    instead: 4-byte cp.async into the planes for the window, and stores
//    in 8-, 4- or 2-byte units with no division in the loop.
// Shared memory at 46 -> 48, r = 4, P = 2 and the 16x22 tile: the weights
// 82,944 bytes, the raw boxes 40,704, the result 33,792, the planes with
// their reach 41,584; 199,728 of the 232,448 bytes a block may have. What
// keeps it from its bound (the re-lay between the tiles' MMAs, the MMAs'
// operands read from shared memory at N = 48, the epilogues) is in PERF.md
// and tools/chain_clocks.py --kernel tail.
//
// 2-byte activations in more than one channel group (the x2 upsamplers'
// 52 -> 208 and 64 -> 256, whose steps' weights no block holds beside a
// result), conv3x3_pixelshuffle_mma_kernel<T, P, R2>: the same plan on
// mma.sync.m16n8k16 (mma_stage.cuh: P = 2 split f16 weights, two products;
// P = 1 weights rounded to T, one product, R2), the group's whole weights
// in fragment order in shared memory, fetched once per block with cp.async
// (pack_tail_f16, pack_tail_2byte); 8 warps of 3 m-tiles of 16 in one pass
// of a 16x22 tile; the window by tensor copies into the raw buffer,
// re-laid to a 112-byte pixel stride for ldmatrix; each group's run of a
// pixel written out with plain stores.
//
// f32 and bf16 activations with f32 weights (parity, high, mixed, fasthi)
// in one channel group, conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, KC>:
// the same plan on split TF32 and warpgroup MMA,
// wgmma.mma_async.m64n48k8.f32.tf32.tf32 with A from registers and B from
// shared memory (wgmma_chain.cuh wgmma_tf32_rs). The host splits each
// weight into two TF32 terms (ops/kernels/conv_chain.py split_tf32), the
// kernel each activation in registers (cvt.rna; a bf16 value is an exact
// TF32 value, its lo term zero), and P products a k-step go into one
// accumulator set: a_hi w_hi, a_hi w_lo, a_lo w_hi under f32 activations
// (P = 3), the first two under bf16 (P = 2). The tensor cores truncate as
// they accumulate, so each unit's products are summed from zero and added
// to the running sums in f32, rounded to nearest, as mma_stage.cuh's
// "split TF32" does per tap. What the design does about the card's limits:
//  - a unit is one tap (KC = cin's k-chunks of 16, 2 to 4: 2 KC k-steps
//    of 8), or, up to 16 input channels (KC = 0, folded), 4 k-steps of
//    K = 9 cin (tap, channel) pairs: at cin = 3 the whole conv is one unit
//    of 27 -> 32 values, 4 k-steps a step where the per-tap form runs 18 on
//    a K padded to 16 a tap;
//  - M = output indices in m-blocks of 64 (the pitch trick), two for each
//    of three warpgroups at 16x22, one at 8x22 (50 to 64 channels in under
//    f32, whose window takes 80 words a pixel); both m-blocks of a
//    warpgroup read each unit's weights, their running sums live at once
//    (passes of one m-block a warpgroup, each over all the units, would
//    read every unit's weights twice a tile); N = the 48 conv
//    channels of a step (kStepNt n-tiles): a wider conv (SCET's 64, the x2
//    upsamplers' 96 to 256) runs its steps in turn, each a full pass over
//    the units with sums of its own, the last zero-padded;
//  - A from registers: the f32 window at sw = 16 (mod 32) words a pixel, so
//    that a quarter warp's 16-byte loads cover the banks once (folded, an
//    odd stride of cin words and a table of each K index's offset); a warp
//    loads and splits its 16 rows of an m-block as mma.sync.m16n8k8's A
//    fragment, which is a warp's slice of m64nNk8's. A unit's A registers
//    stay live until its wait (written under a pending MMA they would
//    serialize every MMA), so a warpgroup issues an m-block's unit in
//    groups of KG k-steps (as many A registers as fit beside two sets of
//    sums), waits for each before it writes the next group's registers,
//    and adds the unit's sums after the last: it reads no accumulator under
//    a pending MMA; the other warpgroups' MMAs fill its waits;
//  - the weights of a unit (the hi and lo B operands, 48 x 8 TF32 values a
//    k-step each: 18 KB a tap at 46 channels) come through a ring of up to
//    4 buffers by bulk copies (cp.async.bulk) that report to an mbarrier
//    each; the last warp done with a buffer asks for the unit nbuf later
//    into it, so the copies run ahead of the MMAs, across tiles, with no
//    barrier of the block between units;
//  - the window comes in by plain batched loads, which do not overlap the
//    MMAs (a second f32 window does not fit beside the first, the result
//    and the ring); the finished tile goes out by one tensor store where
//    the shapes fit (f32 at RLFN's 48-byte run of a pixel, as a rank-4 box;
//    bf16 at an even width, as rows of words), which drains under the next
//    window's load, otherwise by stores of the widest unit the run allows.
// Shared memory at 46 -> 48, r = 4, f32 and the 16x22 tile: the ring 73,728
// bytes (4 taps), the result 67,584, the window 83,328; 225,152 of the
// 232,448 bytes a block may have.
//
// Inputs over 64 channels, and plans whose result leaves room for fewer
// m-blocks than warpgroups (52 -> 208 and 64 -> 256 at r = 2 under f32),
// take conv3x3_pixelshuffle_tf32_kernel<T, P>: the same arithmetic on
// mma.sync.m16n8k8 (mma_stage.cuh mma_tap_tf32) in channel groups, 8 warps
// of 2 m-tiles, each tap's weights staged by cp.async into a double buffer
// behind a barrier of the block, the window by plain loads, each group's
// run of a pixel out with plain stores.
// Bound: 19,872 MACs a pixel against 376 bytes a pixel at f32: bound by
// operations, 2.0 ms at batch 128 x 256^2 at 3 TF32 products a MAC on the
// card's 495 TFLOP/s; under bf16 activations 1.0 ms at 3 bf16 products (the
// weight split into three bf16 terms) on its 989 TFLOP/s, as in conv_chain.cu.
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <cstring>

#include "mma_stage.cuh"
#include "wgmma_chain.cuh"

namespace esr {

// ---- tensor copies and the copy-out ------------------------------------

// Hopper's tensor copies (TMA): one instruction moves a box of a tensor
// between device and shared memory without passing through registers. The
// tensor map (made on the host, cuTensorMapEncodeTiled) holds base, extents
// and strides; what lies outside the tensor is read as zeros and not
// written. A load reports to an mbarrier, a store to the issuing thread's
// bulk group.
__device__ inline void tensor_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ inline void tensor_store_3d(const CUtensorMap* map, const void* src, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ inline void tensor_store_4d(const CUtensorMap* map, const void* src, int c0, int c1,
                                       int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A window of hi rows of 2-byte pixels of cin channels as tensor copies:
// nbox boxes of hi rows x 2^ppb_log2 pixels each (a box is at most 256
// words wide: 8 pixels of up to 62 channels, else 4), box_w words of a
// box's row (its pixels and 4 more, see request_window), box_words from
// one box to the next in the raw buffer (a multiple of 128 bytes).
struct Boxes {
  int ppb_log2, nbox, box_w, box_words;
};

__host__ __device__ inline Boxes boxes_of(int cin, int hi, int wi) {
  Boxes b;
  b.ppb_log2 = cin <= 62 ? 3 : 2;
  b.nbox = cdiv(wi, 1 << b.ppb_log2);
  b.box_w = (cin / 2 << b.ppb_log2) + 4;
  b.box_words = cdiv(hi * b.box_w * 4, 128) * 32;
  return b;
}

// The finished tile to device memory with plain stores, for shapes whose
// output rows the bulk store does not take. The result holds the tile's
// r * th output rows of tw * run bytes each; of each, the first npx * run
// bytes go out, for the first nrow tile rows. For each i the block's
// THREADS threads walk over [tile row][pixel][unit of the run], so that
// consecutive threads store consecutive units of one output row, and no
// loop divides.
template <typename U, int THREADS = kThreads>
__device__ inline void copy_out_rows(const void* res, void* out, long long row0, int wd,
                                     int run, int r, int tw, int npx, int nrow, int tx0) {
  constexpr int kBatch = 6;  // loads from shared memory ahead of their stores
  constexpr int kU = static_cast<int>(sizeof(U));
  const char* src = reinterpret_cast<const char*>(res);
  char* dst = reinterpret_cast<char*>(out);
  const long long row_bytes = static_cast<long long>(wd) * run;  // one output row of the image
  const Walk first(threadIdx.x, npx, run / kU, THREADS);
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

// ---- the 2-byte path in one channel group, on warpgroup MMA -------------

// Warpgroups of a block of the wgmma tail: each takes every third m-block
// of a tile, as the chain's kernel (conv_chain.cu kChainWarpgroups)
constexpr int kTailWarpgroups = 3;
constexpr int kTailThreads = 128 * kTailWarpgroups;
// m-blocks of a warpgroup in a tile, at most: the plans' tiles have up to 6
constexpr int kTailBlocks = 2;

// The wgmma tail's widths, regions and work, and its shared memory, byte
// offsets: [the window's and the weights' mbarriers][the packed weights of
// every step][raw window boxes][result][window planes][scales and biases]
// [channel table], the first four at multiples of 128 bytes, which the
// tensor copies ask of their shared-memory addresses. The window is 2 kc
// planes of 8 channels, ps pixels of 16 bytes apart; a tile's last m-block
// reads up to 2 wi + 2 pixels past the last plane's window (rows that the
// epilogue drops), and the scales start past that reach.
struct WgTail {
  int kc, nt, steps;  // k-chunks of 16 inputs, n-tiles of 8 conv channels, steps of kStepNt n-tiles
  int runh;           // values of one pixel's run in an output row: r * cout
  int hi, wi, ps;     // window rows, pitch, and pixels from one plane to the next
  int blocks;         // m-blocks of 64 output indices
  Boxes bx;           // the window's tensor copies
  int w, raw, res, win, sb, tab, bytes;
};

__host__ __device__ inline WgTail wg_tail(int cin, int cout, int r, Tile t, int P) {
  WgTail g;
  g.kc = kchunks(cin);
  g.nt = ntiles(cout * r * r);
  g.steps = cdiv(g.nt, kStepNt);
  g.runh = r * cout;
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  // odd: the words of a pixel's planes lie in different banks
  g.ps = (g.hi * g.wi) | 1;
  // output indices p = row * wi + c; the last one kept is (th - 1, tw - 1)
  g.blocks = cdiv(t.th * g.wi - 2, 64);
  g.bx = boxes_of(cin, g.hi, g.wi);
  g.w = 128;
  g.raw = g.w + g.steps * kTaps * g.kc * 8 * kStepNt * P * 32;
  g.res = g.raw + g.bx.nbox * g.bx.box_words * 4;
  g.win = g.res + cdiv(t.th * t.tw * r * g.runh * 2, 128) * 128;
  g.sb = g.win + ((2 * g.kc - 1) * g.ps + 64 * g.blocks + 2 * g.wi + 2) * 16;
  g.tab = g.sb + 2 * 8 * g.nt * 4;
  g.bytes = g.tab + 8 * g.nt * 4;
  return g;
}

// One step's 9 kc MMAs of one m-block into d, as one group, waited for:
// the m-block's A operand at `a` (the window's planes, lbo bytes apart),
// its tap (ky, kx) ky * wi + kx pixels further; the step's B operands from
// `b`, one of N x 16 a tap's k-chunk.
template <typename T, int N, int ND>
__device__ inline void tail_mmas(float (&d)[ND], unsigned a, unsigned lbo, unsigned b, int wi,
                                 int kc) {
  fence_acc(d);
  wgmma_fence();
  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3, kx = tap - 3 * ky;
    const unsigned at = a + static_cast<unsigned>(ky * wi + kx) * 16;
    for (int c = 0; c < kc; ++c) {
      const uint64_t da = wgmma_desc(at + 2 * c * lbo, lbo, 128);
      const uint64_t db = wgmma_desc(b + static_cast<unsigned>(tap * kc + c) * N * 32, 128, 256);
      Wgmma<T>::ss(d, da, db, (tap | c) != 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
}

// x: NHWC (nimg, h, wd, cin) of T (__half: fasthi16, P = 2, and fast16,
// P = 1 with R2; __nv_bfloat16: fast, P = 1 with R2); out: NHWC (nimg,
// r*h, r*wd, cout) of T. wq: the packed weights of ops/kernels/tail.py
// pack_tail_wgmma_f16 (P = 2) or pack_tail_wgmma_2byte (P = 1): the conv's
// channels in the order (i, j, c), packed as one stage of the chain's
// wgmma pack, [step of kStepNt n-tiles][tap][k-chunk] and per k-step an
// N x 16 B operand (N = 8 kStepNt P; under P = 2 the hi terms' columns,
// then the lo terms'; zero past the conv's channels). sb: [1/S per
// channel][bias per channel] in that order, padded to whole n-tiles (1
// and 0 in the pad); S = 1 under P = 1. A persistent grid: block b takes
// the tiles b, b + gridDim.x, ... of the nimg * tiles_h * tiles_w (image,
// tile row, tile column) items. tensor_in, tensor_out: the input's /
// output's rows are such that tensor copies can move them (the host
// function says when): in_map is x as 32-bit words (wd * cin / 2, h, nimg)
// with boxes of (box_w words, hi rows), out_map is out as words
// (wd * r * cout / 2, r * h, nimg) with boxes of one tile. Otherwise plain
// loads and stores do the copies. R2: the two roundings (epilogue_value).
template <typename T, int P, bool R2>
__global__ void __launch_bounds__(kTailThreads, 1)
    conv3x3_pixelshuffle_wgmma_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      const uint4* __restrict__ wq, const float* __restrict__ sb,
                                      int nimg, int h, int wd, int cin, int cout, int r,
                                      Tile tile, int tiles_h, int tiles_w, int tensor_in,
                                      int tensor_out, const __grid_constant__ CUtensorMap in_map,
                                      const __grid_constant__ CUtensorMap out_map) {
  using Op = Op2<T>;
  constexpr int WGS = kTailWarpgroups, N = 8 * kStepNt * P, ND = N / 2;
  constexpr int kWords = 8;  // a box row has at most 256 words: 8 a lane
  extern __shared__ __align__(128) uint8_t smem[];
  const WgTail gm = wg_tail(cin, cout, r, tile, P);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);  // the window's, the weights'
  uint8_t* const wsm = smem + gm.w;
  uint32_t* const raw = reinterpret_cast<uint32_t*>(smem + gm.raw);
  uint8_t* const res = smem + gm.res;
  uint32_t* const win = reinterpret_cast<uint32_t*>(smem + gm.win);
  float* const ssb = reinterpret_cast<float*>(smem + gm.sb);
  int* const tab = reinterpret_cast<int*>(smem + gm.tab);
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int nchan = cout * r * r;
  const int pw = cin / 2;       // words of an input pixel, where tensor_in
  const int run = 2 * gm.runh;  // bytes of one pixel's run in an output row

  // once per block: scales and biases; where a channel goes in the result
  // (channel k' = (i*r + j)*cout + c of a pixel lies i output rows down,
  // at (j, c) of the pixel's run; in 2-byte values from the pixel's run in
  // row 0; -1: pad); and zero planes where tensor copies bring the windows
  // (re-laying one writes no pad channel)
  for (int i = threadIdx.x; i < 16 * gm.nt; i += kTailThreads) ssb[i] = __ldg(sb + i);
  for (int i = threadIdx.x; i < 8 * gm.nt; i += kTailThreads)
    tab[i] = i < nchan ? (i / gm.runh) * tile.tw * gm.runh + i % gm.runh : -1;
  if (tensor_in)
    for (int i = threadIdx.x; i < (gm.sb - gm.win) / 4; i += kTailThreads) win[i] = 0u;
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
  }
  __syncthreads();

  // The re-lay's stores, the same for every box row: word j = lane + 32 k
  // of a row is word q of the box's pixel p, which goes to plane q / 4 at
  // pixel p, word q % 4 (in words from the box's first pixel in plane 0).
  int to[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int j = lane + 32 * k, p = pw ? j / pw : 0, q = j - p * pw;
    to[k] = ((q >> 2) * gm.ps + p) * 4 + (q & 3);
  }
  // where this lane's pixels of each of its m-blocks start in row 0 of their
  // tile row of the result (rows g and g+8 of its warp's 16 output
  // indices); -1: dropped (past the tile, and the pitch trick's columns)
  const int nb = (gm.blocks - wg + WGS - 1) / WGS;  // this warpgroup's m-blocks a tile
  int px[kTailBlocks][2];
#pragma unroll
  for (int i = 0; i < kTailBlocks; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 64 * (wg + WGS * i) + 16 * (warp % 4) + g + 8 * hr;
      const int row = p / gm.wi, c = p - row * gm.wi;
      px[i][hr] = row < tile.th && c < tile.tw ? (row * r * tile.tw + c) * gm.runh : -1;
    }

  const int per_img = tiles_h * tiles_w;
  const int total = nimg * per_img;  // items
  auto origin = [&](int tl, int& n, int& ty0, int& tx0) {
    n = tl / per_img;
    const int rem = tl - n * per_img;
    const int ty = rem / tiles_w;
    ty0 = ty * tile.th;
    tx0 = (rem - ty * tiles_w) * tile.tw;
  };
  // Thread 0 asks for the window of tile tl, box by box; the boxes report to
  // the window's mbarrier, one phase a tile (whole boxes count, zeros
  // included). A box must start at a multiple of 16 bytes in its row, so it
  // starts up to 3 words before its first pixel and is 4 words wider than
  // its pixels. The maps' addresses are taken here, in the kernel's own
  // scope: they must stay addresses of the kernel's parameters.
  const CUtensorMap* const in_map_at = &in_map;
  const CUtensorMap* const out_map_at = &out_map;
  auto request_window = [&](int tl) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    mbar_expect(bars, static_cast<unsigned>(gm.bx.nbox * gm.hi * gm.bx.box_w * 4));
    for (int b = 0; b < gm.bx.nbox; ++b)
      tensor_load_3d(raw + b * gm.bx.box_words, in_map_at,
                     (((tx0 - 1) * pw) & ~3) + (b << gm.bx.ppb_log2) * pw, ty0 - 1, n, bars);
  };

  int tl = blockIdx.x;
  if (threadIdx.x == 0) {
    // the weights, one bulk copy a tap of a step, and the first window
    const unsigned tap_bytes = static_cast<unsigned>(gm.kc * N * 32);
    mbar_expect(bars + 1, tap_bytes * kTaps * gm.steps);
    for (int i = 0; i < kTaps * gm.steps; ++i)
      bulk_load(wsm + i * tap_bytes, reinterpret_cast<const uint8_t*>(wq) + i * tap_bytes,
                tap_bytes, bars + 1);
    if (tensor_in && tl < total) request_window(tl);
  }
  unsigned phase = 0;
  bool store_pending = false;  // thread 0's store of the last tile may still read `res`
  bool weights = false;        // the weights have landed
  const unsigned a0 = smem_addr(win), b0 = smem_addr(wsm);
  const unsigned lbo = static_cast<unsigned>(gm.ps) * 16;  // bytes from one plane to the next

  // step nc of this warpgroup's i-th m-block from d into the result: this
  // lane holds, of each n-tile, channels 2t and 2t+1, which go where the
  // table says
  auto epilogue = [&](const float (&d)[ND], int i, int nc) {
    uint32_t* const res32 = reinterpret_cast<uint32_t*>(res);
    unsigned short* const resh = reinterpret_cast<unsigned short*>(res);
#pragma unroll
    for (int jn = 0; jn < kStepNt; ++jn) {
      const int ntg = nc * kStepNt + jn;
      if (ntg >= gm.nt) continue;  // the zero pad of the last step
      const float2 s2 = reinterpret_cast<const float2*>(ssb + 8 * ntg)[t];
      const float2 b2 = reinterpret_cast<const float2*>(ssb + 8 * gm.nt + 8 * ntg)[t];
      const int2 at = reinterpret_cast<const int2*>(tab + 8 * ntg)[t];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // computed for dropped pixels too (their sums are zeros or
        // garbage): only the store is conditional
        const int e = 4 * jn + 2 * hr;
        const float v0 = epilogue_value<T, P, R2>(d[e], lo_of<P>(d, e), s2.x, b2.x);
        const float v1 = epilogue_value<T, P, R2>(d[e + 1], lo_of<P>(d, e + 1), s2.y, b2.y);
        const typename Op::T2 y2 = Op::pack(v0, v1);
        const uint32_t yb = *reinterpret_cast<const uint32_t*>(&y2);
        const int p0 = px[i][hr];
        if (gm.runh % 2 == 0) {
          // an even run: the pair lies in one run at an even place
          if ((p0 | at.x) >= 0) res32[(p0 + at.x) >> 1] = yb;
        } else {
          if ((p0 | at.x) >= 0) resh[p0 + at.x] = static_cast<unsigned short>(yb & 0xffffu);
          if ((p0 | at.y) >= 0) resh[p0 + at.y] = static_cast<unsigned short>(yb >> 16);
        }
      }
    }
  };

  for (; tl < total; tl += gridDim.x) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    if (tensor_in) {
      // the boxes have landed, zeros where the image ends (torch's zero
      // padding): re-lay them as planes. A warp takes one row of one box at
      // a time, whose words are contiguous: lane l moves the words l,
      // l + 32, ... to their pixels' planes.
      mbar_wait(bars, phase);
      phase ^= 1;
      const int skew = ((tx0 - 1) * pw) & 3;  // words from a box's start to its first pixel
      for (int item = warp; item < gm.hi * gm.bx.nbox; item += kTailThreads / 32) {
        const int row = item / gm.bx.nbox, box = item - row * gm.bx.nbox;
        const int c0 = box << gm.bx.ppb_log2;  // the box's first window column
        const int here =
            gm.wi - c0 < (1 << gm.bx.ppb_log2) ? gm.wi - c0 : 1 << gm.bx.ppb_log2;
        const uint32_t* src = raw + box * gm.bx.box_words + row * gm.bx.box_w + skew;
        uint32_t* const dst = win + (row * gm.wi + c0) * 4;
        uint32_t v[kWords];
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          if (lane + 32 * k < here * pw) v[k] = src[lane + 32 * k];
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          if (lane + 32 * k < here * pw) dst[to[k]] = v[k];
      }
    } else {
      load_window_planes<kTailThreads>(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.ps,
                                       gm.kc, reinterpret_cast<uint8_t*>(win));
      cp_async_wait();
    }
    if (store_pending) bulk_wait_read();
    fence_proxy_async();  // the MMAs read the planes
    __syncthreads();      // the planes are whole; raw and the result are free again
    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) request_window(tl + gridDim.x);
    if (!weights) {
      mbar_wait(bars + 1, 0);
      weights = true;
    }

    // this warpgroup's m-blocks wg, wg + WGS: each step's MMAs are waited
    // for before its epilogue reads them (an epilogue that reads one
    // accumulator set while another's MMAs are pending makes ptxas
    // serialize every MMA); the other warpgroups' MMAs fill the time
#pragma unroll
    for (int i = 0; i < kTailBlocks; ++i) {
      if (i >= nb) break;
      for (int nc = 0; nc < gm.steps; ++nc) {
        float d[ND];
        tail_mmas<T, N>(d, a0 + static_cast<unsigned>(64 * (wg + WGS * i)) * 16, lbo,
                        b0 + static_cast<unsigned>(nc * kTaps * gm.kc * N * 32), gm.wi, gm.kc);
        epilogue(d, i, nc);
      }
    }

    // the finished tile to device memory: by one tensor store that drains
    // under the next tile (the image's edges clip it), or with plain stores
    const int npx = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const long long row0 = static_cast<long long>(n) * h + ty0;  // the tile's first image row
    if (tensor_out) fence_proxy_async();
    __syncthreads();  // the result is whole, and the planes are free again
    if (tensor_out) {
      if (threadIdx.x == 0) {
        tensor_store_3d(out_map_at, res, tx0 * (run / 4), ty0 * r, n);
        bulk_commit();
        store_pending = true;
      }
    } else if (run % 8 == 0) {
      copy_out_rows<uint2, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else if (run % 4 == 0) {
      copy_out_rows<uint32_t, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else {
      copy_out_rows<unsigned short, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow,
                                                  tx0);
    }
  }
  if (store_pending) bulk_wait_read();  // before the shared memory goes
}

// ---- the 2-byte path in channel groups, on mma.sync.m16n8k16 -------------

// Widths, regions and work split of a channel group, and its shared memory:
// [whole packed weights of the block's channel group, wsz 16-byte units]
// [raw window boxes][result][window][scales and biases][channel table]
// [mbarrier], the middle ones in 32-bit words; the first three are
// multiples of 128 bytes, which the tensor copies ask of their
// shared-memory addresses. The stage's last m-tile reads up to kOverrun
// pixels past the window's pixels; the window has room for them.
//
// Channel groups. The conv's r*r*cout output channels, in the packed order
// k' = (i*r + j)*cout + c, are split into `groups` runs of cg channels: one
// group a shuffle position (i, j), or a part of one, cout / cg of them a
// position. A block computes one group for every tile it takes; its result
// holds, for each pixel of the tile, the group's cg values, which belong at
// output row r*y + i, column r*x + j, channels from c0 on.
struct TailGeom {
  int kc, nt, nch;  // k-chunks of 16 inputs, n-tiles of 8 outputs of a group, their chunks
  int sw;           // words per pixel of the window
  int cg;           // channels of a group
  int hi, wi;       // window rows and pitch
  int tiles, passes;  // m-tiles of 16 output indices; passes of kWarps * MT m-tiles
  Boxes bx;           // the window's tensor copies
  int wsz, win_words, raw_words, res_words, sbsz, tabsz;
};

// P: products a fragment (the packed weights' terms)
__host__ __device__ inline TailGeom tail_geom(int cin, int cout, int r, Tile t, int P,
                                              int groups) {
  TailGeom g;
  g.kc = kchunks(cin);
  g.cg = cout * r * r / groups;
  g.nt = ntiles(g.cg);
  g.nch = cdiv(g.nt, kNtChunk);
  g.sw = pixel_words(cin);
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  // output indices p = row * wi + c; the last one kept is (th - 1, tw - 1)
  g.tiles = cdiv(t.th * g.wi - 2, 16);
  g.passes = cdiv(g.tiles, kWarps * mtiles(P));
  g.bx = boxes_of(cin, g.hi, g.wi);
  g.wsz = 9 * g.kc * g.nt * frag_units(P);
  g.raw_words = g.bx.nbox * g.bx.box_words;
  g.res_words = cdiv(t.th * t.tw * g.cg * 2, 128) * 32;
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

// x: NHWC (nimg, h, wd, cin) of T (__half: fasthi16, P = 2, and fast16, P =
// 1 with R2; __nv_bfloat16: fast, P = 1 with R2); out: NHWC (nimg, r*h,
// r*wd, cout) of T. wq: the packed weights of ops/kernels/tail.py
// pack_tail_f16 (P = 2) or pack_tail_2byte (P = 1) in `groups` channel
// groups (TailGeom) one after the other, each packed as a stage of its
// own: output channels in the order (i, j, c), then [chunk of n-tiles]
// [ky][kx][k-chunk][n-tile][lane][{b0, b1} of each term]. sb: per group
// [1/S per channel][bias per channel] in that order, padded to whole
// n-tiles (1 and 0 in the pad); S = 1 under P = 1. One block walks over
// the items blockIdx.x, blockIdx.x + gridDim.x, ... (item = tile * groups +
// group, tile = image * tiles_h * tiles_w + tile row * tiles_w + tile
// column); gridDim.x is a multiple of groups, so a block keeps one group.
// tensor_in: the input's rows are such that tensor copies can move them
// (the host function says when): in_map is x as 32-bit words
// (wd * cin / 2, h, nimg) with boxes of (box_w words, hi rows). Otherwise
// plain loads do the copies. R2: the two roundings (epilogue_value).
template <typename T, int P, bool R2>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_pixelshuffle_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    const uint4* __restrict__ wq, const float* __restrict__ sb,
                                    int nimg, int h, int wd, int cin, int cout, int r, Tile tile,
                                    int groups, int tiles_h, int tiles_w, int tensor_in,
                                    const __grid_constant__ CUtensorMap in_map) {
  using Op = Op2<T>;
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
  const int pw = cin / 2;               // words of an input pixel, where tensor_in
  const int grp = blockIdx.x % groups;  // this block's channel group

  // once per block: the group's weights (in flight until the first tile's
  // barrier), scales and biases, and where a channel goes in the result:
  // channel k' of the group is value k' of the pixel's cg; -1: pad
  stage_weights_async(wsm, wq + static_cast<size_t>(grp) * gm.wsz, gm.wsz);
  for (int i = threadIdx.x; i < gm.sbsz; i += kThreads) ssb[i] = __ldg(sb + grp * gm.sbsz + i);
  for (int i = threadIdx.x; i < gm.tabsz; i += kThreads) tab[i] = i < gm.cg ? i : -1;
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
  // map's address is taken here, in the kernel's own scope: it must stay the
  // address of the kernel's parameter.
  const CUtensorMap* const in_map_at = &in_map;
  auto request_window = [&](int tl) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    mbar_expect(bar, static_cast<unsigned>(gm.bx.nbox * gm.hi * gm.bx.box_w * 4));
    for (int b = 0; b < gm.bx.nbox; ++b)
      tensor_load_3d(raw + b * gm.bx.box_words, in_map_at,
                     (((tx0 - 1) * pw) & ~3) + (b << gm.bx.ppb_log2) * pw, ty0 - 1, n, bar);
  };

  int tl = blockIdx.x;
  if (tensor_in && threadIdx.x == 0 && tl < total) request_window(tl);
  unsigned phase = 0;
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
      for (int item = warp; item < gm.hi * gm.bx.nbox; item += kWarps) {
        const int row = item / gm.bx.nbox, box = item - row * gm.bx.nbox;
        const int c0 = box << gm.bx.ppb_log2;  // the box's first window column
        const int here =
            gm.wi - c0 < (1 << gm.bx.ppb_log2) ? gm.wi - c0 : 1 << gm.bx.ppb_log2;
        const uint32_t* src = raw + box * gm.bx.box_words + row * gm.bx.box_w + skew;
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
      // m-tile): where the pixel's cg values start in the result; -1:
      // dropped (beyond cnt, and the pitch trick's garbage columns and rows)
      int px[MT][2];
      {
        int rr = (mt0 * 16 + g) / gm.wi, c = mt0 * 16 + g - rr * gm.wi;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            px[m][hr] = (m < cnt && rr < tile.th && c < tile.tw) ? (rr * tile.tw + c) * gm.cg : -1;
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
          mma_conv_row_group<T, P, MT>(acc, arow, gm.sw, gm.kc, cnt, ntl, wrow, nothing);
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
              if (gm.cg % 2 == 0) {
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

    // the group's part of the finished tile to device memory
    const int npx = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const long long row0 = static_cast<long long>(n) * h + ty0;  // the tile's first image row
    __syncthreads();  // the result is whole, and the window is free again
    const int per_ij = cout / gm.cg;  // groups of one shuffle position
    const int ij = grp / per_ij, c0 = (grp - ij * per_ij) * gm.cg;
    copy_out_group_any(res, out, row0, wd, 2 * cout, r, ij / r, ij % r, 2 * c0, 2 * gm.cg,
                       tile.tw, npx, nrow, tx0);
  }
}

// An output tile and the number of channel groups (TailGeom) of a launch.
// A 2-byte plan in one group is the wgmma kernel's, in more the m16n8k16
// kernel's.
struct TailPlan {
  Tile tile;
  int groups;
};

// The plan of a kernel that needs bytes(tile, groups) of shared memory a
// block: from `first` groups on (0: the whole conv in one group), at a 16x22
// or a 16x14 tile where it fits, else one group a shuffle position (i, j) at
// those tiles, then 2, 3, ... groups a position (each a whole share of
// cout); then the same order at 8x14 and 8x8 tiles. The last plan if none
// fits (the host function refuses it). A tile of th x tw has
// ceil((th * (tw + 2) - 2) / 16) m-tiles: 24, 16 and 8 of them split evenly
// over the 8 warps.
template <typename Bytes>
inline TailPlan pick_plan(int cout, int r, Bytes bytes, int first = 0) {
  const Tile tiles[2][2] = {{{16, 22}, {16, 14}}, {{8, 14}, {8, 8}}};
  for (int size = 0; size < 2; ++size)
    for (int s = first; s <= cout; ++s) {  // s = 0: one group; else s groups a position
      if (s > 0 && cout % s) continue;
      const int groups = s ? r * r * s : 1;
      for (const Tile& t : tiles[size])
        if (bytes(t, groups) <= kMaxSmem) return {t, groups};
    }
  return {tiles[1][1], first ? r * r * cout : 1};
}

// The plan of a 2-byte path with P products: the wgmma kernel's first tile
// whose layout fits a block in one group, in this order: 16x22 and 8x22
// take 6 and 3 m-blocks of 64 (as many for each warpgroup), 16x14 4, 8x14
// and 8x8 2; else the m16n8k16 kernel's channel groups (pick_plan from one
// a shuffle position on).
inline TailPlan pick_tail_plan(int cin, int cout, int r, int P) {
  const Tile tiles[] = {{16, 22}, {8, 22}, {16, 14}, {8, 14}, {8, 8}};
  for (const Tile& t : tiles) {
    const WgTail g = wg_tail(cin, cout, r, t, P);
    if (static_cast<size_t>(g.bytes) <= kMaxSmem && g.blocks <= kTailWarpgroups * kTailBlocks)
      return {t, 1};
  }
  return pick_plan(
      cout, r, [&](Tile t, int g) { return tail_mma_smem_bytes(cin, cout, r, t, P, g); }, 1);
}

// ---- the f32 and bf16 paths on split TF32, on warpgroup MMA ------------

// The folded form takes the taps into K up to this many input channels (one
// k-chunk of 16); the per-tap form takes up to kMaxKc32 k-chunks (64
// channels); wider inputs, and shapes whose result leaves no room for a
// tile of kTailWarpgroups m-blocks, take the grouped m16n8k8 kernel.
constexpr int kFoldMaxCin = 16;
constexpr int kMaxKc32 = 4;
// k-steps of 8 (tap, channel) pairs a folded unit takes: each k-step's
// products summed from zero (tools/accumulation_model.py: a fresh sum over
// 4 k-steps at K = 27 models 3.0-5.3x an f32 FMA chain's error, over one
// 1.5-2.5x)
constexpr int kFoldSteps = 1;

__host__ __device__ inline bool tail_tf32_folded(int cin) { return cin <= kFoldMaxCin; }

// The wgmma split-TF32 tail's widths, regions and work, and its shared
// memory, byte offsets: [the ring's mbarriers and release counters][the
// ring: nbuf buffers of one unit's weights][result][window][biases]
// [channel table][the folded form's (tap, channel) offsets], the first
// three at multiples of 128 bytes (bulk copies into the ring, the tensor
// store from the result). A unit is one tap of one step (per tap) or
// kFoldSteps k-steps of K = 9 cin (folded); a step's units run in turn
// through the ring. The window is f32 at sw words a pixel; the tile's last
// m-block reads up to 2 wi + 2 pixels past its end (rows the epilogue
// drops). nbuf: as many buffers as fit, up to kRing32 (0 or 1: no plan).
struct WgTail32 {
  int kc, nt, steps;  // k-chunks of 16 inputs, n-tiles of 8 conv channels, steps of kStepNt n-tiles
  int units, ks;      // units of a step, k-steps of a unit
  int sw, runh;       // window words a pixel; values of one pixel's run in an output row
  int hi, wi, blocks;  // window rows and pitch; m-blocks of 64 output indices
  int unit_bytes, nbuf;
  int ring, res, win, bias, tab, foff, bytes;
};

__host__ __device__ inline WgTail32 wg_tail32(int cin, int cout, int r, Tile t, int vbytes) {
  WgTail32 g;
  const bool fold = tail_tf32_folded(cin);
  g.kc = kchunks(cin);
  g.nt = ntiles(cout * r * r);
  g.steps = cdiv(g.nt, kStepNt);
  g.ks = fold ? kFoldSteps : 2 * g.kc;
  g.units = fold ? cdiv(9 * cin, 8 * kFoldSteps) : kTaps;
  // odd under the folded form: a lane's rows g lie in 8 banks
  g.sw = fold ? (cin | 1) : pixel_words_f32(cin);
  g.runh = r * cout;
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  g.blocks = cdiv(t.th * g.wi - 2, 64);
  g.unit_bytes = g.ks * 2 * kStepB32;
  const int res_b = cdiv(t.th * t.tw * r * g.runh * vbytes, 128) * 128;
  const int win_b = cdiv((64 * g.blocks + 2 * g.wi + 2) * g.sw * 4, 16) * 16;
  const int foff_b = fold ? 8 * kFoldSteps * g.units * 4 : 0;
  const int fixed = kRing32Head + res_b + win_b + 2 * 8 * g.nt * 4 + foff_b;
  const int room = (static_cast<int>(kMaxSmem) - fixed) / g.unit_bytes;
  g.nbuf = room < 0 ? 0 : room < kRing32 ? room : kRing32;
  g.ring = kRing32Head;
  g.res = g.ring + g.nbuf * g.unit_bytes;
  g.win = g.res + res_b;
  g.bias = g.win + win_b;
  g.tab = g.bias + 8 * g.nt * 4;
  g.foff = g.tab + 8 * g.nt * 4;
  g.bytes = g.foff + foff_b;
  return g;
}

// x: NHWC (nimg, h, wd, cin) of T (float: parity, high and mixed, P = 3;
// bf16: fasthi, P = 2; P = 1 only in the control of tools/chain_check.py);
// out: NHWC (nimg, r*h, r*wd, cout) of T. wq: the packed weights of
// ops/kernels/tail.py pack_tail_wgmma_tf32 (KC = the k-chunks of cin, per
// tap) or pack_tail_wgmma_tf32_fold (KC = 0, folded): the conv's channels
// in the order (i, j, c), [step of kStepNt n-tiles][unit][k-step][hi, lo]
// and per k-step and term a 48 x 8 B operand, [group of 8 columns]
// [k 0-3, k 4-7][8 columns][4 k], zero past the conv's channels and past
// cin (per tap) or 9 cin (folded). bias: in that order, padded to whole
// n-tiles. A persistent grid: block b takes the tiles b, b + gridDim.x, ...
// of the nimg * tiles_h * tiles_w (image, tile row, tile column) items; its
// units of weights run on across tiles through the ring. out_rank as in the
// grouped kernel's host function: 0, plain stores; 4, one tensor store a
// tile, out as (run words, wd, r * h, nimg) with boxes (run words, tw,
// r * th, 1); 3, out as rows of words (wd * run / 4, r * h, nimg) with boxes
// of a tile's rows.
template <typename T, int P, int KC>
__global__ void __launch_bounds__(kTailThreads, 1)
    conv3x3_pixelshuffle_wgmma_tf32_kernel(const T* __restrict__ x, T* __restrict__ out,
                                           const uint8_t* __restrict__ wq,
                                           const float* __restrict__ bias, int nimg, int h,
                                           int wd, int cin, int cout, int r, Tile tile,
                                           int tiles_h, int tiles_w, int out_rank,
                                           const __grid_constant__ CUtensorMap out_map) {
  constexpr int WGS = kTailWarpgroups;
  constexpr bool FOLD = KC == 0;
  constexpr int KS = FOLD ? kFoldSteps : 2 * KC;  // k-steps a unit
  // k-steps a group, chosen on the card (ROADMAP, Decisions on the
  // split-TF32 tail's warpgroup MMA): 2 under 3 products (16 A registers;
  // a whole tap at 3 k-chunks, 48, spills at the 168-register cap of 384
  // threads: tools/chain_clocks.py --kernel tail_tf32 --variant kgunit); a
  // unit's under 2 products up to 3 k-chunks (24 registers), else 2
  constexpr int KG = FOLD ? KS : P == 3 || KS > 6 ? 2 : KS;
  extern __shared__ __align__(128) uint8_t smem[];
  const WgTail32 gm = wg_tail32(cin, cout, r, tile, sizeof(T));
  Ring32 ring(smem, gm.nbuf, gm.unit_bytes);
  T* const res = reinterpret_cast<T*>(smem + gm.res);
  float* const win = reinterpret_cast<float*>(smem + gm.win);
  float* const sbias = reinterpret_cast<float*>(smem + gm.bias);
  int* const tab = reinterpret_cast<int*>(smem + gm.tab);
  int* const foff = reinterpret_cast<int*>(smem + gm.foff);
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int nchan = cout * r * r;
  const int run = gm.runh * static_cast<int>(sizeof(T));  // bytes of a pixel's run in an output row

  // once per block: biases; where a channel goes in the result (channel
  // k' = (i*r + j)*cout + c of a pixel lies i output rows down, at (j, c)
  // of the pixel's run; in values from the pixel's run in row 0; -1: pad);
  // folded, the window offset of each K index (tap, channel), -1 past 9 cin
  for (int i = threadIdx.x; i < 8 * gm.nt; i += kTailThreads) {
    sbias[i] = __ldg(bias + i);
    tab[i] = i < nchan ? (i / gm.runh) * tile.tw * gm.runh + i % gm.runh : -1;
  }
  if (FOLD)
    for (int k = threadIdx.x; k < 8 * kFoldSteps * gm.units; k += kTailThreads) {
      const int tap = k / cin, ky = tap / 3;
      foff[k] = k < 9 * cin ? (ky * gm.wi + tap - 3 * ky) * gm.sw + k - tap * cin : -1;
    }
  ring.init();

  const int per_img = tiles_h * tiles_w;
  const int total = nimg * per_img;  // items
  auto origin = [&](int tl, int& n, int& ty0, int& tx0) {
    n = tl / per_img;
    const int rem = tl - n * per_img;
    const int ty = rem / tiles_w;
    ty0 = ty * tile.th;
    tx0 = (rem - ty * tiles_w) * tile.tw;
  };
  // the units of weights this block reads through the ring, a tile's
  // steps x units after another's
  const int per_tile = gm.steps * gm.units;
  const int bx = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);
  const int jtotal = (bx < total ? (total - 1 - bx) / grid + 1 : 0) * per_tile;
  auto fetch = [&](int jj) {
    if (jj < jtotal)
      ring.load(jj, wq + static_cast<size_t>(jj % per_tile) * gm.unit_bytes,
                static_cast<unsigned>(gm.unit_bytes));
  };
  __syncthreads();  // the barriers, counters and tables are in place
  if (threadIdx.x == 0)
    for (int jj = 0; jj < gm.nbuf; ++jj) fetch(jj);

  // this warpgroup's m-blocks (wg, wg + WGS), the warps that read the
  // weights (a warpgroup without an m-block does not), and this lane's row
  // g of its first m-block in the window
  const int nb = (gm.blocks - wg + WGS - 1) / WGS;
  const int active = 4 * (gm.blocks < WGS ? gm.blocks : WGS);
  const float* const a0 = win + (64 * wg + 16 * (warp % 4) + g) * gm.sw + (FOLD ? 0 : 4 * t);
  // where this lane's rows g and g+8 of m-block mb start in the result's
  // row 0 of their tile row (-1: dropped, past the tile and the pitch
  // trick's columns)
  auto pixel = [&](int mb, int hr) {
    const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr, row = p / gm.wi, c = p - row * gm.wi;
    return row < tile.th && c < tile.tw ? (row * r * tile.tw + c) * gm.runh : -1;
  };

  // step nc's running sums of m-block mb, + bias, rounded to T, into the
  // result where the table says: this lane holds, of each n-tile, channels
  // 2t and 2t+1
  auto epilogue = [&](const float (&s)[24], int mb, int nc) {
    const int px0 = pixel(mb, 0), px1 = pixel(mb, 1);
#pragma unroll
    for (int jn = 0; jn < kStepNt; ++jn) {
      const int ntg = nc * kStepNt + jn;
      if (ntg >= gm.nt) continue;  // the zero pad of the last step
      const float2 b2 = reinterpret_cast<const float2*>(sbias + 8 * ntg)[t];
      const int2 to = reinterpret_cast<const int2*>(tab + 8 * ntg)[t];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int e = 4 * jn + 2 * hr, p0 = hr ? px1 : px0;
        const float v0 = Act<T>::store_out(s[e] + b2.x);
        const float v1 = Act<T>::store_out(s[e + 1] + b2.y);
        if (gm.runh % 2 == 0) {
          // an even run: the pair lies in one run at an even place
          if ((p0 | to.x) >= 0) store_pair(res + p0 + to.x, make_float2(v0, v1));
        } else {
          if ((p0 | to.x) >= 0) res[p0 + to.x] = Act<T>::store(v0);
          if ((p0 | to.y) >= 0) res[p0 + to.y] = Act<T>::store(v1);
        }
      }
    }
  };

  // thread 0's tensor store of the last tile may still read the result; the
  // map's address is taken here, in the kernel's own scope
  bool store_pending = false;
  const CUtensorMap* const out_map_at = &out_map;
  for (int tl = blockIdx.x; tl < total; tl += gridDim.x) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    if (store_pending) {
      bulk_wait_read();
      store_pending = false;
    }
    load_window_f32<kTailThreads>(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw,
                                  FOLD ? 0 : gm.kc, win);
    __syncthreads();  // the window is whole, and the last tile's store has read the result

    // each step over all its units, a unit's weights read by both of a
    // warpgroup's m-blocks, wg and wg + WGS, whose running sums both stay
    // live
    for (int nc = 0; nc < gm.steps; ++nc) {
      float sum[kTailBlocks][24];
#pragma unroll
      for (int i = 0; i < kTailBlocks; ++i)
#pragma unroll
        for (int e = 0; e < 24; ++e) sum[i][e] = 0.f;
      for (int u = 0; u < gm.units; ++u) {
        if (nb > 0) {
          const unsigned b = ring.wait();
          const int ky = u / 3;
          const int tap_at = FOLD ? 0 : (ky * gm.wi + u - 3 * ky) * gm.sw;
          // the unit's products of each m-block summed from zero, then
          // added to the running sums in f32 (the tensor cores truncate
          // as they accumulate); the other warpgroups' MMAs fill the waits
#pragma unroll
          for (int i = 0; i < kTailBlocks; ++i) {
            if (i >= nb) break;
            float d[24];
            unit_mmas<P, FOLD, KS, KG>(d, a0 + WGS * 64 * gm.sw * i + tap_at, gm.sw,
                                       foff + 8 * kFoldSteps * u, b, t);
#pragma unroll
            for (int e = 0; e < 24; ++e) sum[i][e] += d[e];
          }
          // every MMA of this warp has read the unit
          ring.release(active, fetch);
        }
        ring.advance();
      }
#pragma unroll
      for (int i = 0; i < kTailBlocks; ++i)
        if (i < nb) epilogue(sum[i], wg + WGS * i, nc);
    }

    // the finished tile to device memory: by one tensor store that drains
    // under the next window's load (the image's edges clip it), or with
    // plain stores in the widest unit that the run and the output's
    // alignment allow
    const int npx = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const long long row0 = static_cast<long long>(n) * h + ty0;  // the tile's first image row
    const uintptr_t base = reinterpret_cast<uintptr_t>(out);
    if (out_rank) fence_proxy_async();
    __syncthreads();  // the result is whole, and the window is free again
    if (out_rank) {
      if (threadIdx.x == 0) {
        if (out_rank == 4)
          tensor_store_4d(out_map_at, res, 0, tx0, ty0 * r, n);
        else
          tensor_store_3d(out_map_at, res, tx0 * (run / 4), ty0 * r, n);
        bulk_commit();
        store_pending = true;
      }
    } else if (run % 16 == 0 && base % 16 == 0) {
      copy_out_rows<uint4, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else if (run % 8 == 0 && base % 8 == 0) {
      copy_out_rows<uint2, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else if (run % 4 == 0 && base % 4 == 0) {
      copy_out_rows<uint32_t, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx, nrow, tx0);
    } else {
      copy_out_rows<unsigned short, kTailThreads>(res, out, row0, wd, run, r, tile.tw, npx,
                                                  nrow, tx0);
    }
  }
  if (store_pending) bulk_wait_read();  // before the shared memory goes
}

// ---- split TF32 in channel groups, on mma.sync.m16n8k8 -------------------

// Widths, regions and work split of a channel group of the split-TF32 tail
// (TailGeom's groups), and its shared memory: [2 weight buffers of wsz
// 16-byte units][window][result][biases][channel table], the last four in
// 32-bit words. A weight buffer holds one tap of one chunk of n-tiles. The
// window has room for the kOverrun pixels that the stage's last m-tile
// reads past it.
struct TailGeom32 {
  int kc, nt, nch;    // k-chunks of 16 inputs, n-tiles of 8 outputs of a group, their chunks
  int sw;             // words per pixel of the window
  int cg;             // channels of a group
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
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  g.tiles = cdiv(t.th * g.wi - 2, 16);
  g.passes = cdiv(g.tiles, kWarps * kMT32);
  g.steps = g.passes * g.nch * 9;
  g.wsz = g.kc * (g.nt < kNtChunk ? g.nt : kNtChunk) * 64;
  g.win_words = cdiv((g.hi * g.wi + kOverrun) * g.sw, 32) * 32;
  g.res_words = cdiv(t.th * t.tw * g.cg * vbytes, 16) * 4;
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

// x: NHWC (nimg, h, wd, cin) of T (float: P = 3; bf16: P = 2; P = 1 only in
// the control of tools/chain_check.py); out: NHWC (nimg, r*h, r*wd, cout)
// of T. wq: the packed weights of ops/kernels/tail.py pack_tail_tf32 in
// `groups` channel groups (TailGeom) one after the other, each packed as a
// stage of its own: output channels in the order (i, j, c), then [chunk of
// n-tiles][tap][k-chunk][n-tile][hi, lo][lane][4 words]; bias: per group,
// padded to whole n-tiles. One block walks over the items blockIdx.x,
// blockIdx.x + gridDim.x, ... (item = tile * groups + group, tile = image
// * tiles_h * tiles_w + tile row * tiles_w + tile column); gridDim.x is a
// multiple of groups, so a block keeps one group. Its weight steps (a tap
// of a chunk of a pass) run on across tiles, so the next tile's first tap
// is in flight while the next window comes in; each group's run of a pixel
// goes out with plain stores.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_pixelshuffle_tf32_kernel(const T* __restrict__ x, T* __restrict__ out,
                                     const uint4* __restrict__ wq, const float* __restrict__ bias,
                                     int nimg, int h, int wd, int cin, int cout, int r, Tile tile,
                                     int groups, int tiles_h, int tiles_w) {
  extern __shared__ __align__(128) uint4 smem16[];
  const TailGeom32 gm = tail_geom32(cin, cout, r, tile, sizeof(T), groups);
  uint4* const wbuf0 = smem16;
  float* const win = reinterpret_cast<float*>(smem16 + 2 * gm.wsz);
  T* const res = reinterpret_cast<T*>(win + gm.win_words);
  float* const sbias = win + gm.win_words + gm.res_words;
  int* const tab = reinterpret_cast<int*>(sbias + gm.bsz);
  auto wbuf = [&](int b) { return wbuf0 + (b & 1) * gm.wsz; };
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = blockIdx.x % groups;  // this block's channel group
  const uint4* const wg = wq + static_cast<size_t>(grp) * 9 * gm.kc * gm.nt * 64;

  // where a channel goes in the result, as in the m16n8k16 kernel: channel
  // k' of the group is value k' of the pixel's cg; -1: pad
  for (int i = threadIdx.x; i < gm.bsz; i += kThreads) sbias[i] = __ldg(bias + grp * gm.bsz + i);
  for (int i = threadIdx.x; i < gm.tabsz; i += kThreads) tab[i] = i < gm.cg ? i : -1;

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
  while (tl < total) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    const bool more = tl + static_cast<int>(gridDim.x) < total;
    int mt0 = 0, cnt = 0;  // this warp's m-tiles in the current pass
    for (int s = 0; s < gm.steps; ++s, ++j) {
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

      // the epilogue on the running sums: + bias, rounded to T, into the
      // result where the table says. The up to 2 * kMT32 pixels of this
      // lane (rows g and g+8 of each m-tile): where the pixel's cg values
      // start in the result; -1: dropped
      int px[kMT32][2];
      {
        int rr = (mt0 * 16 + g) / gm.wi, c = mt0 * 16 + g - rr * gm.wi;
#pragma unroll
        for (int m = 0; m < kMT32; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            px[m][hr] = (m < cnt && rr < tile.th && c < tile.tw) ? (rr * tile.tw + c) * gm.cg : -1;
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
            if (gm.cg % 2 == 0) {
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

    __syncthreads();  // every warp is done with the window, and the result is whole
    // the group's part of the finished tile out with plain stores; then the
    // next tile's window in
    const int npx = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const long long row0 = static_cast<long long>(n) * h + ty0;  // the tile's first image row
    const int vb = static_cast<int>(sizeof(T)), per_ij = cout / gm.cg;
    const int ij = grp / per_ij, c0 = (grp - ij * per_ij) * gm.cg;
    copy_out_group_any(res, out, row0, wd, vb * cout, r, ij / r, ij % r, vb * c0, vb * gm.cg,
                       tile.tw, npx, nrow, tx0);
    tl += gridDim.x;
    if (more) {
      origin(tl, n, ty0, tx0);
      load_window_f32(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw, gm.kc, win);
    }
  }
}

// The plan of a split-TF32 path on values of vbytes: the wgmma kernel's
// first tile whose layout fits a block in one group with at least two
// weight buffers, an m-block for each warpgroup and at most kTailBlocks
// (16x22: 6 m-blocks, 8x22: 3; a 16x14 tile needs more of both regions
// than 8x22), where cin takes at most kMaxKc32 k-chunks; else the
// m16n8k8 kernel's channel groups (pick_plan from one a shuffle position
// on): inputs over 64 channels, and the x2 upsamplers' 52 -> 208 and
// 64 -> 256 under f32 activations, whose results leave room for 2 m-blocks
// at most.
inline TailPlan pick_tail_plan32(int cin, int cout, int r, int vbytes) {
  if (kchunks(cin) <= kMaxKc32) {
    const Tile tiles[] = {{16, 22}, {8, 22}};
    for (const Tile& t : tiles) {
      const WgTail32 g = wg_tail32(cin, cout, r, t, vbytes);
      if (g.nbuf >= 2 && g.blocks >= kTailWarpgroups &&
          g.blocks <= kTailWarpgroups * kTailBlocks)
        return {t, 1};
    }
  }
  return pick_plan(
      cout, r, [&](Tile t, int g) { return tail_tf32_smem_bytes(cin, cout, r, t, vbytes, g); },
      1);
}

}  // namespace esr

using namespace esr;

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (null if
// it has none)
typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The launch of one 2-byte path's kernel: the wgmma kernel where the plan
// has one channel group, else the m16n8k16 kernel in groups (which takes
// no tensor store).
template <typename T, int P, bool R2>
static int launch_tail_2byte(dim3 grid, size_t smem, void* stream, const void* x, void* out,
                             const uint4* wq, const float* sb, int n, int h, int wd, int cin,
                             int cout, int r, Tile t, int groups, int tiles_h, int tiles_w,
                             int tensor_in, int tensor_out, const CUtensorMap& in_map,
                             const CUtensorMap& out_map) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (groups == 1)
    return launch_threads(conv3x3_pixelshuffle_wgmma_kernel<T, P, R2>, grid, kTailThreads, smem,
                          stream, xt, ot, wq, sb, n, h, wd, cin, cout, r, t, tiles_h, tiles_w,
                          tensor_in, tensor_out, in_map, out_map);
  return launch(conv3x3_pixelshuffle_mma_kernel<T, P, R2>, grid, smem, stream, xt, ot, wq, sb, n,
                h, wd, cin, cout, r, t, groups, tiles_h, tiles_w, tensor_in, in_map);
}

// The launch of a split-TF32 path with P products: the wgmma kernel where
// the plan has one channel group, in its form for cin (folded, or per tap
// at cin's k-chunks), else the m16n8k8 kernel in groups (which takes no
// tensor store). tools/chain_check.py --one-product patches fasthi's call
// to P = 1.
template <typename T, int P>
static int launch_tail_tf32(dim3 grid, size_t smem, void* stream, const void* x, void* out,
                            const void* wq, const float* bias, int n, int h, int wd, int cin,
                            int cout, int r, Tile t, int groups, int tiles_h, int tiles_w,
                            int out_rank, const CUtensorMap& out_map) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (groups > 1)
    return launch(conv3x3_pixelshuffle_tf32_kernel<T, P>, grid, smem, stream, xt, ot,
                  static_cast<const uint4*>(wq), bias, n, h, wd, cin, cout, r, t, groups, tiles_h,
                  tiles_w);
  const uint8_t* wb = static_cast<const uint8_t*>(wq);
  const auto go = [&](auto kernel) {
    return launch_threads(kernel, grid, kTailThreads, smem, stream, xt, ot, wb, bias, n, h, wd,
                          cin, cout, r, t, tiles_h, tiles_w, out_rank, out_map);
  };
  switch (tail_tf32_folded(cin) ? 0 : kchunks(cin)) {
    case 0:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 0>);
    case 2:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 2>);
    case 3:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 3>);
    default:  // the plan takes at most kMaxKc32 k-chunks in one group
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 4>);
  }
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
// conv3x3_pixelshuffle): decided by the shapes alone
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
  const int vb = dtype == 0 ? 4 : 2;
  if (P && pl.groups == 1) return wg_tail(cin, cout, r, pl.tile, P).bytes;
  if (P) return static_cast<long long>(tail_mma_smem_bytes(cin, cout, r, pl.tile, P, pl.groups));
  if (pl.groups == 1) return wg_tail32(cin, cout, r, pl.tile, vb).bytes;
  return static_cast<long long>(tail_tf32_smem_bytes(cin, cout, r, pl.tile, vb, pl.groups));
}

// The channel groups of the launch (TailGeom), in which the weights are
// packed: 1, or r * r * s with s dividing cout. dtype and fast as in
// conv3x3_pixelshuffle. A 2-byte path (fast, or dtype 1) in one group runs
// the wgmma kernel, in more the m16n8k16 kernel; a split-TF32 path in one
// group the split-TF32 wgmma kernel, in more the m16n8k8 kernel.
extern "C" int conv3x3_pixelshuffle_groups(int dtype, int fast, int cin, int cout, int r) {
  return plan_of(dtype, fast, cin, cout, r).groups;
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, cin) NHWC contiguous;
// out: (n, r*h, r*wd, cout) NHWC contiguous.
// fast = 0, dtype 1 (fasthi16): in one channel group, w is the f16 hi/lo
// split as wgmma operands with the conv's channels in shuffled order, and b
// the scales and biases, as conv3x3_pixelshuffle_wgmma_kernel<__half, 2,
// false> reads them; in more, the split in fragment order, as
// conv3x3_pixelshuffle_mma_kernel<__half, 2, false> reads it.
// fast = 1, dtype 1 or 2 (fast16, fast): w is the weights rounded to the
// activation type, one term in the same two layouts, and b scales of 1 and
// the biases rounded to it, as the kernels <T, 1, true> read them.
// fast = 0, dtype 0 and 2 (parity, high, mixed, fasthi): in one channel
// group, w is the TF32 hi/lo split as wgmma B operands with the conv's
// channels in shuffled order, per tap or folded as cin chooses
// (tail_tf32_folded), and b the biases, as
// conv3x3_pixelshuffle_wgmma_tf32_kernel reads them; in more, the split in
// fragment order, as conv3x3_pixelshuffle_tf32_kernel reads it.
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
    if (dtype == 0)
      return launch_tail_tf32<float, 3>(grid, smem, stream, x, out, w, bf, n, h, wd, cin, cout, r,
                                        t, groups, tiles_h, tiles_w, out_rank, out_map);
    return launch_tail_tf32<__nv_bfloat16, 2>(grid, smem, stream, x, out, w, bf, n, h, wd, cin,
                                              cout, r, t, groups, tiles_h, tiles_w, out_rank,
                                              out_map);
  }
  // Tensor copies take rows that are multiples of 16 bytes from a 16-byte
  // aligned base, boxes of at most 256 elements a side, and whole 32-bit
  // words: channel pairs of the input, a pixel's run of the output. The
  // maps view both tensors as words, whatever the 2-byte type.
  const int hi = t.th + 2;
  const Boxes bx = boxes_of(cin, hi, t.tw + 2);
  const long long in_row = static_cast<long long>(wd) * cin * 2;
  const long long out_row = static_cast<long long>(wd) * r * cout * 2;
  const int box_w = t.tw * r * cout * 2;  // bytes of one output row of a tile
  int tensor_in = cin % 2 == 0 && cin <= 126 && in_row % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 && hi <= 256;
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
      const cuuint32_t box[3] = {static_cast<cuuint32_t>(bx.box_w), static_cast<cuuint32_t>(hi),
                                 1};
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
    return launch_tail_2byte<__half, 1, true>(grid, smem, stream, x, out, wq, bf, n, h, wd, cin,
                                              cout, r, t, groups, tiles_h, tiles_w, tensor_in,
                                              tensor_out, in_map, out_map);
  if (fast)
    return launch_tail_2byte<__nv_bfloat16, 1, true>(grid, smem, stream, x, out, wq, bf, n, h, wd,
                                                     cin, cout, r, t, groups, tiles_h, tiles_w,
                                                     tensor_in, tensor_out, in_map, out_map);
  return launch_tail_2byte<__half, 2, false>(grid, smem, stream, x, out, wq, bf, n, h, wd, cin,
                                             cout, r, t, groups, tiles_h, tiles_w, tensor_in,
                                             tensor_out, in_map, out_map);
}
