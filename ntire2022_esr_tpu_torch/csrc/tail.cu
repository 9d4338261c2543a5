// conv3x3_pixelshuffle: conv2d(x, w, b, padding=1) to r*r*cout channels,
// rounded to the activation type as ops/nn.py store_out does, then
// PixelShuffle(r) in torch's channel-major order:
//   out[n, r*h+i, r*w+j, c] = conv[n, h, w, c*r*r + i*r + j].
// The x4 upsamplers of RLFN and of 34 other zoo models (r = 4), the
// library's upsamplers, and the x2 upsamplers of the HR tails of models
// 27, 28 and 33 (r = 2; ops/fused.py).
//
// Replaces ntire2022_esr_tpu/ops/pallas/tail.py fused_conv3x3_pixelshuffle.
// A block takes a low-resolution tile plus a one-pixel halo into shared
// memory, the conv result stays in shared memory, and the shuffled
// high-resolution tile is written out a step of 48 conv channels at a time,
// so the (h, w, r*r*cout) intermediate never reaches device memory.
//
// Bound on an H100 (see PERF.md): at RLFN's widths (46 -> 48, r = 4) the
// function does 9*46*48 = 19,872 MACs per low-resolution pixel and moves
// 92 + 96 bytes per pixel in f16. On the card's best rate for the work
// (f16 tensor cores, 989 TFLOP/s) the operations take 0.34 ms at batch
// 128 x 256^2 and the bytes 0.47 ms at 3.35 TB/s: it is bound by bytes
// under one product; fasthi16's two products take 0.67 ms and bound it.
//
// Two kernels share that plan, and every shape runs in one block a tile
// (one channel group). The conv's channels are packed in the order
// k' = (i*r + j)*cout + c (ops/kernels/tail.py shuffled_order), so the
// shuffle costs nothing in the MMAs: the r*cout channels [i*r*cout,
// (i+1)*r*cout) of a low-resolution pixel (y, x) are the contiguous run of
// output row r*y + i at column r*x (24 bytes at RLFN's widths). The conv's
// channels run in steps of 48 (kStepNt n-tiles, the N of the MMAs), the
// last zero-padded. Each kernel's epilogue runs on the accumulator
// registers (unscale, bias, the round to the activation type, f16
// saturating) and stores channel pairs into a result buffer in shared
// memory, where a table says each channel goes. A plan whose result holds
// the whole tile (every 2-byte plan with resident weights: RLFN's and the
// zoo's x4 upsamplers to 3 channels, a conv of more steps where that
// fits) keeps the tile's result in the tile's layout and writes it out
// after the tile's last step, by one tensor store; otherwise each step's 48 channels leave
// the block as soon as their epilogue ends, while the next step's MMAs
// run: a step's channels [48s, 48s + 48) are, for each row i they reach, a
// piece of that row's run of every pixel (at 52 -> 208, r = 2, step 2 is
// 8 values at the end of row 0's 104-value run and 40 at the start of row
// 1's), and one tensor store a 16-byte chunk of them moves it (StepOut).
// So no block needs a whole tile's result: 34 KB a step at 16x22 in 2
// bytes, where the whole tile at 64 -> 256, r = 2 takes 180 KB.
//
// 2-byte activations (fasthi16, fast16, fast),
// conv3x3_pixelshuffle_wgmma_kernel<T, P, R2> (the weights resident) and
// conv3x3_pixelshuffle_wgmma_ring_kernel<T, P, R2> (the weights streamed):
// the conv as one stage of the chain's warpgroup-MMA design (conv_chain.cu, wgmma_chain.cuh),
// wgmma.mma_async.m64nNk16 with f32 accumulation and both operands read
// from shared memory through matrix descriptors. M = output indices in
// m-blocks of 64 (the pitch trick of common.cuh: index row * wi + c, a
// tap an offset of ky * wi + kx pixels, the two columns past each row
// dropped), K = 9 taps x input channels in k-chunks of 16, N = the 48 conv
// channels of one step. Under fasthi16 (P = 2) the f32 weights are split
// into two f16 terms side by side in N (N = 96: hi, then lo; f32-grade);
// under fast16 and fast (P = 1) they are packed once rounded to T, one
// exact product, and the epilogue rounds each sum to T before it adds the
// bias (R2: two roundings, as ops/nn.py conv2d computes a 2-byte
// contraction's output). The products are summed in f32 over the whole
// conv. What the design does about the card's limits:
//  - one persistent block an SM, three warpgroups (384 threads);
//  - the weights a unit at a time, a unit one tap of one step (kc 16-byte
//    k-steps of N columns: 12,288 bytes at 64 channels under P = 2): where
//    every unit of a tile fits beside the rest and the whole tile's result
//    at some tile (RLFN's 46 -> 48: 83 KB under P = 2, 41 KB under P = 1;
//    SCET's 64 -> 64 under P = 1 at 8x22) they arrive once a block by bulk
//    copies (cp.async.bulk) to one mbarrier and stay (the resident
//    kernel); otherwise (SCET's 64 -> 64 under P = 2, the x2 upsamplers'
//    52 -> 208 and 64 -> 256) they stream through the ring of
//    wgmma_chain.cuh (Ring32): up to 4 buffers, one bulk copy a unit to
//    the buffer's mbarrier, the last warp done with a buffer asks for the
//    unit nbuf later, across steps and tiles (the ring kernel). Two
//    kernels, so that the ring's state and the per-step copy-out take no
//    registers or code from the resident form's MMAs (in one kernel they
//    read 5-10% slower at RLFN's 46 -> 48, PERF.md);
//  - the window as planes of 8 channels, 16 bytes a pixel a plane: 8
//    consecutive output indices at any tap offset are one 128-byte core
//    matrix, so a descriptor (LBO a plane, SBO 8 pixels) addresses an
//    m-block at any tap; no ldmatrix, so no pad words. The planes lie an
//    odd number of pixels apart, so that one pixel's words fall in
//    different banks;
//  - a 16x22 tile is 6 m-blocks, two for each warpgroup. With the weights
//    resident a warpgroup issues a step's 9 kc MMAs of one m-block as one
//    group and waits for them before its epilogue. With the weights
//    streamed it issues, for each tap of a step, one group of its
//    m-blocks' kc MMAs, and waits for it only after it has issued the next
//    tap's (wgmma.wait_group 1), so the tensor cores do not drain between
//    units; then it releases that tap's unit. Under one product both
//    m-blocks' accumulator sets (2 x 24 registers) stay live over the
//    step's taps, and each unit is read once a tile; under two products a
//    set is 48 registers and two spill at the 168-register cap of 384
//    threads, so one m-block a pass, each unit read twice a tile. No
//    accumulator is read under a pending MMA (which would make ptxas
//    serialize every MMA); all three warpgroups issue at once and share
//    the tensor cores;
//  - the next tile's window arrives under this tile's MMAs: tensor copies
//    (TMA, cp.async.bulk.tensor) bring its rows as boxes into a raw buffer
//    and report to an mbarrier; what lies outside the image arrives as
//    zeros. A pixel is 92 bytes there at RLFN's widths, which no tensor map
//    can lay out as planes (its rows are no multiple of 16 bytes), so all
//    warps re-lay the window into the planes when it has landed, a warp a
//    box row at a time, each lane's plane offsets computed once a block.
//    The planes take the next window only when every MMA of the tile is
//    done (a second buffer of planes does not fit beside fasthi16's
//    weights, and 4-byte copies of the next window into it under the MMAs
//    slowed them: ROADMAP, Decisions on the tail's warpgroup MMA);
//  - shapes whose rows are no multiples of 16 bytes take plain copies
//    instead: 4-byte cp.async into the planes for the window, and stores
//    with no division in the loop (no served shape takes them): of the
//    widest unit a run allows in the resident kernel (copy_out_rows), of
//    single values in the ring kernel (copy_out_piece).
// Shared memory at 46 -> 48, r = 4, P = 2 and the 16x22 tile: the weights
// 82,944 bytes, the raw boxes 40,704, the result 33,792, the planes with
// their reach 41,584; 199,728 of the 232,448 bytes a block may have. At
// 64 -> 256, r = 2, P = 2: planes 55,440, raw boxes 57,600, one step's
// result 33,792, a ring of 4 units 49,152; 199,184. What keeps it from its
// bound is in PERF.md and tools/chain_clocks.py --kernel tail (the
// resident kernel) and --kernel tail_ring.
//
// f32 and bf16 activations with f32 weights (parity, high, mixed, fasthi),
// conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, KC>: the same plan on split
// TF32 and warpgroup MMA, wgmma.mma_async.m64n48k8.f32.tf32.tf32 with A
// from registers and B from shared memory (wgmma_chain.cuh wgmma_tf32_rs).
// The host splits each weight into two TF32 terms (ops/kernels/conv_chain.py
// split_tf32), the kernel each activation in registers (cvt.rna; a bf16
// value is an exact TF32 value, its lo term zero), and P products a k-step
// go into one accumulator set: a_hi w_hi, a_hi w_lo, a_lo w_hi under f32
// activations (P = 3), the first two under bf16 (P = 2). The tensor cores
// truncate as they accumulate, so each unit's products are summed from
// zero and added to the running sums in f32, rounded to nearest
// (wgmma_chain.cuh "split TF32"). What the design does about the card's
// limits:
//  - a unit is one tap (KC = cin's k-chunks of 16: 2 to 4 unrolled, or
//    KC = 0, any number, the k-steps in a loop: inputs over 64 channels),
//    or, up to 16 input channels (KC = kFoldKc, folded), kFoldSteps
//    k-steps of K = 9 cin (tap, channel) pairs: at cin = 3 the whole conv
//    is 4 units of 8 values a step where the per-tap form runs 18 k-steps
//    on a K padded to 16 a tap;
//  - M = output indices in m-blocks of 64 (the pitch trick), up to two for
//    each of three warpgroups (16x22: 6; 8x22: 3; 8x8: 2 and 4x4: 1, where
//    a warpgroup without an m-block reads no unit; it has none at any
//    tile of the launch, so it never waits on the ring and no phase of a
//    buffer can alias); both m-blocks of a warpgroup read each unit's
//    weights, their running sums live at once; N = the 48 conv channels of
//    a step: a wider conv runs its steps in turn, each a full pass over
//    the units with sums of its own, the last zero-padded;
//  - A from registers: the f32 window at sw = 16 (mod 32) words a pixel, so
//    that a quarter warp's 16-byte loads cover the banks once (folded, an
//    odd stride of cin words and a table of each K index's offset); a warp
//    loads and splits its 16 rows of an m-block. A unit's A registers stay
//    live until its wait (written under a pending MMA they would serialize
//    every MMA), so a warpgroup issues an m-block's unit in groups of KG
//    k-steps, waits for each before it writes the next group's registers,
//    and adds the unit's sums after the last: it reads no accumulator under
//    a pending MMA; the other warpgroups' MMAs fill its waits;
//  - the weights of a unit (the hi and lo B operands, 48 x 8 TF32 values a
//    k-step each: 18 KB a tap at 46 channels) come through a ring of up to
//    4 buffers (Ring32), so the copies run ahead of the MMAs, across steps
//    and tiles, with no barrier of the block between units;
//  - the window comes in by plain batched loads, which do not overlap the
//    MMAs (a second f32 window does not fit beside the first, the result
//    and the ring).
// Shared memory at 46 -> 48, r = 4, f32 and the 16x22 tile: the ring 73,728
// bytes (4 taps), the result 67,584, the window 83,328; 225,152 of the
// 232,448 bytes a block may have. At 52 -> 208 and 64 -> 256, r = 2, f32:
// the 8x22 tile, window 77,440, one step's result 33,792, a ring of 4
// units of 24,576.
// Bound: 19,872 MACs a pixel against 376 bytes a pixel at f32: bound by
// operations, 2.0 ms at batch 128 x 256^2 at 3 TF32 products a MAC on the
// card's 495 TFLOP/s; under bf16 activations 1.0 ms at 3 bf16 products (the
// weight split into three bf16 terms) on its 989 TFLOP/s, as in conv_chain.cu.
#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked

#include <cstring>

#include "wgmma_chain.cuh"

namespace esr {

// ---- tensor copies and the step's copy-out -------------------------------

// Hopper's tensor copies (TMA): one instruction moves a box of a tensor
// between device and shared memory without passing through registers. The
// tensor map (made on the host, cuTensorMapEncodeTiled) holds base, extents
// and strides; what lies outside the tensor is read as zeros and not
// written, on either side of it. A load reports to an mbarrier, a store to
// the issuing thread's bulk group.
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

__device__ inline void tensor_store_5d(const CUtensorMap* map, const void* src, int c0, int c1,
                                       int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
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

// How the result leaves the block (the host function chooses it from the
// shapes, the plan and the output's alignment). A conv of one step (48
// channels or fewer: RLFN's and the zoo's x4 upsamplers to 3 channels), or
// a plan whose result holds the whole tile (nres = 0), keeps the tile's
// result in the tile's layout, [tile row y][i][x][run], the r * th output
// rows of the tile in order, written out after the tile's last step:
//  - kOutRows where a tile's rows are multiples of 16 bytes of at most 256
//    words (2-byte RLFN, 24-byte runs: 528 bytes a tile row): one tensor
//    store of a box of (tw runs, r * th, 1) of out viewed as (wd runs,
//    r * h, n), the widest boxes;
//  - kOutRuns else, where a pixel's run in an output row is a multiple of
//    16 bytes (f32 at RLFN's 12 values: 1,056-byte tile rows): one tensor
//    store of a box of (run, tw, r * th, 1) of out viewed as (run, wd,
//    r * h, n) in 32-bit words;
//  - kOutTilePlain otherwise: each row i's runs copied with plain stores.
// Otherwise each step's result is written out as soon as it is made:
//  - kOutPixels where a pixel's run is a multiple of 16 bytes: the step's
//    48 values of each tile pixel in chunks (chunk_values: the most values
//    that divide both 48 and a run, a multiple of 16 bytes), [chunk][tile
//    pixel][chunk values], each chunk at a multiple of 128 bytes (tiles
//    have multiples of 8 pixels); a chunk's channels lie in one row i's
//    run, so one tensor store a chunk moves a box of (a chunk, tw, 1, th,
//    1) to coordinates (its channels' place in the run, tx0, i, ty0, n) of
//    out viewed as (run, wd, r, h, n): no box reaches past a run or starts
//    before one, and the map clips only at the image's edges (a box whose
//    inner coordinate lay outside the run, clipped there, killed the
//    kernel with an illegal instruction);
//  - kOutPlain otherwise (odd runs, a misaligned output): the step's 48
//    values of each tile pixel side by side, [tile pixel][48], each piece
//    of a row's run (a step's channels in one row i) copied with plain
//    stores of the widest unit that its offsets allow.
constexpr int kOutPlain = 0, kOutRuns = 1, kOutRows = 2, kOutTilePlain = 3, kOutPixels = 4;
constexpr int kStepCh = 8 * kStepNt;  // conv channels of one step

__host__ __device__ inline bool tile_layout(int out_mode) {
  return out_mode == kOutRuns || out_mode == kOutRows || out_mode == kOutTilePlain;
}

// Bytes of a result buffer at tile t on values of vb bytes: one step's 48
// values of each tile pixel (nres > 0: a multiple of 128 bytes; the tile's
// layout of a one-step conv holds at most as many), or (nres = 0) the
// whole tile's nch channels
__host__ __device__ inline int res_bytes_of(int nch, Tile t, int vb, int nres) {
  return cdiv(t.th * t.tw * (nres ? kStepCh : nch) * vb, 128) * 128;
}

// The numbers of result buffers a plan may take for a conv of `steps`
// steps, in order of preference: the whole tile (0) where it has more than
// one step, two step results, one
__host__ __device__ inline int res_choices(int steps, int* nres) {
  int k = 0;
  if (steps > 1) nres[k++] = 0;
  nres[k++] = 2;
  nres[k++] = 1;
  return k;
}

// Values of one chunk of kOutPixels: the most that divides both a step (48)
// and a run, so that no chunk straddles a step or a run (a multiple of 16
// bytes where a run is: 16 bytes at 52 -> 208, r = 2; 32 at 64 -> 256;
// a step's 96 at 24 -> 96)
__host__ __device__ inline int chunk_values(int runh) {
  int a = kStepCh, b = runh;
  while (b) {
    const int c = a % b;
    a = b;
    b = c;
  }
  return a;
}

// Values from one tile pixel to the next in the result of a launch's
// layout: a run in the tile's layout, a chunk in kOutPixels', a step's 48
// in kOutPlain's
__host__ __device__ inline int per_pixel(int out_mode, int runh) {
  return tile_layout(out_mode) ? runh : out_mode == kOutPixels ? chunk_values(runh) : kStepCh;
}

// Where each conv channel k' goes in a step's result: its offset in values,
// the value of the tile pixel at (row, c) at offset + pixel * per_pixel,
// where pixel is row * r * tw + c in the tile's layout and row * tw + c
// otherwise (the kernels' px); -1 for the zero pad past the conv's
// channels.
__device__ inline void fill_table(int* tab, int nt, int nch, int runh, Tile t, int out_mode,
                                  int threads) {
  const int chunk = chunk_values(runh);
  for (int k = threadIdx.x; k < 8 * nt; k += threads) {
    const int q = k % kStepCh;  // the channel's place in its step
    int e = -1;
    if (k < nch && tile_layout(out_mode))
      e = k / runh * t.tw * runh + k % runh;
    else if (k < nch && out_mode == kOutPixels)
      e = q / chunk * t.th * t.tw * chunk + q % chunk;
    else if (k < nch)
      e = q;
    tab[k] = e;
  }
}

// The finished tile to device memory with plain stores, for shapes whose
// output rows the bulk store does not take. The result holds the tile's
// r * th output rows of tw * run bytes each; of each, the first npx * run
// bytes go out, for the first nrow tile rows. For each i the block's
// THREADS threads walk over [tile row][pixel][unit of the run], so that
// consecutive threads store consecutive units of one output row, and no
// loop divides.
template <typename U, int THREADS>
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

// One piece of the result (row i, byte ob of each pixel's run, lenb bytes)
// to device memory with plain stores: src holds the piece's first value of
// tile pixel (y, x) at y * rowp + x * pitch bytes; the first npx pixels of
// the first nrow tile rows go to output row r*y + i. The block walks over
// [tile row][pixel][value], so that consecutive threads store consecutive
// values of one pixel's piece, and no loop divides. U: the activation
// type's bits, the one unit every offset allows (no served shape takes
// this copy, and a copy in wider units, beside the MMAs in the same
// kernel, measured slower there: PERF.md).
template <typename U, int THREADS>
__device__ inline void copy_out_piece(const uint8_t* src, int pitch, int rowp, void* out,
                                      long long row0, int wd, int runb, int r, int i, int ob,
                                      int lenb, int npx, int nrow, int tx0) {
  constexpr int kU = static_cast<int>(sizeof(U));
  char* dst = reinterpret_cast<char*>(out);
  const long long row_bytes = static_cast<long long>(wd) * runb;  // one output row of the image
  for (Walk wk(threadIdx.x, npx, lenb / kU, THREADS); wk.r < nrow; wk.step())
    *reinterpret_cast<U*>(dst + ((row0 + wk.r) * r + i) * row_bytes +
                          static_cast<long long>(tx0 + wk.c) * runb + ob + wk.q * kU) =
        *reinterpret_cast<const U*>(src + wk.r * rowp + wk.c * pitch + wk.q * kU);
}

// The bits of an activation type, for copies
template <typename T> struct Bits { using type = unsigned short; };
template <> struct Bits<float> { using type = uint32_t; };

// What a step's result needs to leave the block: out and its map, how
// (out_mode), the run (runh values of vb bytes, U their bits), the tile and
// where it lies
template <int THREADS, typename U>
struct StepOut {
  void* out;
  const CUtensorMap* map;
  int out_mode, nch, runh, vb, r, wd;
  Tile tile;
  int n, ty0, tx0, npx, nrow;
  long long row0;  // the tile's first image row over all images

  // step s's result (in rb; the tile's in the tile's layout) to device
  // memory: thread 0 issues the tensor stores and commits them as one bulk
  // group, or the block copies the pieces with plain stores
  __device__ void operator()(const uint8_t* rb, int s) const {
    const int k0 = s * kStepCh, k1 = k0 + kStepCh < nch ? k0 + kStepCh : nch;
    const int runb = runh * vb;
    if (out_mode == kOutPlain || out_mode == kOutTilePlain) {
      // the tile's rows i whole, or the step's piece of each row it reaches
      const bool rows = out_mode == kOutTilePlain;
      const int i1 = rows ? r : cdiv(k1, runh);
      for (int i = rows ? 0 : k0 / runh; i < i1; ++i) {
        const int a = rows || k0 < i * runh ? i * runh : k0;
        const int b = rows || k1 > (i + 1) * runh ? (i + 1) * runh : k1;
        const int pitch = rows ? runb : kStepCh * vb;
        copy_out_piece<U, THREADS>(rows ? rb + i * tile.tw * runb : rb + (a - k0) * vb, pitch,
                                   (rows ? r : 1) * tile.tw * pitch, out, row0, wd, runb, r, i,
                                   (a - i * runh) * vb, (b - a) * vb, npx, nrow, tx0);
      }
      return;
    }
    if (threadIdx.x != 0) return;
    if (out_mode == kOutPixels) {
      const int chunk = chunk_values(runh), chunk_bytes = tile.th * tile.tw * chunk * vb;
      for (int k = k0; k < k1; k += chunk) {
        const int i = k / runh;
        tensor_store_5d(map, rb + (k - k0) / chunk * chunk_bytes, (k - i * runh) * vb / 4, tx0, i,
                        ty0, n);
      }
    } else if (out_mode == kOutRuns) {  // the whole tile
      tensor_store_4d(map, rb, 0, tx0, ty0 * r, n);
    } else {
      tensor_store_3d(map, rb, tx0 * (runb / 4), ty0 * r, n);
    }
    bulk_commit();
  }
};

// Warpgroups of a block of the wgmma tails: each takes every third m-block
// of a tile, as the chain's kernel (conv_chain.cu kChainWarpgroups)
constexpr int kTailWarpgroups = 3;
constexpr int kTailThreads = 128 * kTailWarpgroups;
// m-blocks of a warpgroup in a tile, at most: the plans' tiles have up to 6
constexpr int kTailBlocks = 2;
// the window's mbarrier (2-byte ring kernel), past the ring's mbarriers and
// counters in the kRing32Head bytes before the weights
constexpr int kWindowBar = 64;

// A launch's plan, decided by the shapes alone: the tile, the ring's
// buffers (0: every unit of weights stays in shared memory; the 2-byte
// resident kernel only) and the result buffers (0: the whole tile's; 1 or
// 2 step results).
struct TailPlan {
  Tile tile;
  int nbuf, nres;
};

// ---- the 2-byte path, on warpgroup MMA ----------------------------------

// The wgmma tail's widths, regions and work, and its shared memory, byte
// offsets: [the ring's mbarriers and counters, the window's mbarrier]
// [weights: nbuf ring buffers of one unit, or every unit][raw window boxes]
// [nres step results][window planes][scales and biases][channel table], the
// first four at multiples of 128 bytes, which the bulk and tensor copies
// ask of their shared-memory addresses. The window is 2 kc planes of 8
// channels, ps pixels of 16 bytes apart; a tile's last m-block reads up to
// 2 wi + 2 pixels past the last plane's window (rows that the epilogue
// drops), and the scales start past that reach.
struct WgTail {
  int kc, nch, nt, steps;  // k-chunks of 16 inputs, conv channels, n-tiles of 8, steps
  int runh;                // values of one pixel's run in an output row: r * cout
  int hi, wi, ps;          // window rows, pitch, and pixels from one plane to the next
  int blocks;              // m-blocks of 64 output indices
  Boxes bx;                // the window's tensor copies
  int units, unit_bytes;   // units of weights a tile reads (a tap of a step each), bytes of one
  int nbuf, nres, res_bytes;  // ring buffers (0: resident); result buffers (0: the tile's), bytes
  int w, raw, res, win, sb, tab, bytes;
};

__host__ __device__ inline WgTail wg_tail(int cin, int cout, int r, Tile t, int P, int nbuf,
                                          int nres) {
  WgTail g;
  g.kc = kchunks(cin);
  g.nch = cout * r * r;
  g.nt = ntiles(g.nch);
  g.steps = cdiv(g.nt, kStepNt);
  g.runh = r * cout;
  g.hi = t.th + 2;
  g.wi = t.tw + 2;
  // odd: the words of a pixel's planes lie in different banks
  g.ps = (g.hi * g.wi) | 1;
  // output indices p = row * wi + c; the last one kept is (th - 1, tw - 1)
  g.blocks = cdiv(t.th * g.wi - 2, 64);
  g.bx = boxes_of(cin, g.hi, g.wi);
  g.units = g.steps * kTaps;
  g.unit_bytes = g.kc * 8 * kStepNt * P * 32;
  g.nbuf = nbuf;
  g.nres = nres;
  g.res_bytes = res_bytes_of(g.nch, t, 2, nres);
  g.w = kRing32Head;
  g.raw = g.w + (nbuf ? nbuf : g.units) * g.unit_bytes;
  g.res = g.raw + g.bx.nbox * g.bx.box_words * 4;
  g.win = g.res + (nres ? nres : 1) * g.res_bytes;
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
// tile row, tile column) items. The plans whose weights stay in shared
// memory (TailPlan nbuf = 0), with the whole tile's result (nres = 0):
// every unit of weights arrives once a block, and every step's MMAs of an
// m-block run before the next m-block's. tensor_in: the input's rows are
// such that tensor copies can move them (the host function says when):
// in_map is x as 32-bit words (wd * cin / 2, h, nimg) with boxes of (box_w
// words, hi rows); otherwise plain loads do the copies. out_mode (StepOut):
// kOutRows, out_map is out as words (wd * r * cout / 2, r * h, nimg) with
// boxes of one tile; kOutRuns, out as (run, wd, r * h, nimg) in words with
// boxes of a tile's runs; kOutTilePlain, plain stores. R2: the two
// roundings (epilogue_value).
template <typename T, int P, bool R2>
__global__ void __launch_bounds__(kTailThreads, 1)
    conv3x3_pixelshuffle_wgmma_kernel(const T* __restrict__ x, T* __restrict__ out,
                                      const uint4* __restrict__ wq, const float* __restrict__ sb,
                                      int nimg, int h, int wd, int cin, int cout, int r,
                                      Tile tile, int tiles_h, int tiles_w, int tensor_in,
                                      int out_mode, const __grid_constant__ CUtensorMap in_map,
                                      const __grid_constant__ CUtensorMap out_map) {
  using Op = Op2<T>;
  constexpr int WGS = kTailWarpgroups, N = 8 * kStepNt * P, ND = N / 2;
  constexpr int kWords = 8;  // a box row has at most 256 words: 8 a lane
  extern __shared__ __align__(128) uint8_t smem[];
  const WgTail gm = wg_tail(cin, cout, r, tile, P, 0, 0);
  const bool tensor_out = out_mode != kOutTilePlain;
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
        if (out_mode == kOutRows)
          tensor_store_3d(out_map_at, res, tx0 * (run / 4), ty0 * r, n);
        else
          tensor_store_4d(out_map_at, res, 0, tx0, ty0 * r, n);
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

// One tap of one step for this warpgroup's nb m-blocks into d, issued as
// one group and not waited for (the weights streamed; the caller waits for
// it under the next tap's group): m-block i's A operand at a + i * mstride
// (the window's planes, lbo bytes apart, at the tap's offset), the tap's B
// operands from b, one of N x 16 a k-chunk. first: the step's first tap,
// which starts the sums. Nothing touches d between the groups of a step.
template <typename T, int N, int ND, int MB>
__device__ inline void tap_issue(float (&d)[MB][ND], int nb, unsigned a, unsigned mstride,
                                 unsigned lbo, unsigned b, int kc, bool first) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < MB; ++i) {
    if (i >= nb) break;
    for (int c = 0; c < kc; ++c) {
      const uint64_t da = wgmma_desc(a + i * mstride + 2 * c * lbo, lbo, 128);
      const uint64_t db = wgmma_desc(b + static_cast<unsigned>(c) * N * 32, 128, 256);
      Wgmma<T>::ss(d[i], da, db, !first || c != 0);
    }
  }
  wgmma_commit();
}

// x: NHWC (nimg, h, wd, cin) of T (__half: fasthi16, P = 2, and fast16,
// P = 1 with R2; __nv_bfloat16: fast, P = 1 with R2); out: NHWC (nimg,
// r*h, r*wd, cout) of T. wq: the packed weights of ops/kernels/tail.py
// pack_tail_wgmma_f16 (P = 2) or pack_tail_wgmma_2byte (P = 1): the conv's
// channels in the order (i, j, c), packed as one stage of the chain's
// wgmma pack, [step of kStepNt n-tiles][tap][k-chunk] and per k-step an
// N x 16 B operand (N = 8 kStepNt P; under P = 2 the hi terms' columns,
// then the lo terms'; zero past the conv's channels): unit (step, tap) is
// kc k-steps at (step * 9 + tap) * unit_bytes. sb: [1/S per channel][bias
// per channel] in that order, padded to whole n-tiles (1 and 0 in the pad);
// S = 1 under P = 1. A persistent grid: block b takes the tiles b,
// b + gridDim.x, ... of the nimg * tiles_h * tiles_w (image, tile row,
// tile column) items; its units of weights run on across tiles through
// the ring (the plans with plan.nbuf > 0: every unit of weights fits with
// the whole tile's result at no tile). tensor_in: the input's rows are
// such that tensor copies can move them (the host function says when):
// in_map is x as 32-bit words (wd * cin / 2, h, nimg) with boxes of
// (box_w words, hi rows); otherwise plain loads do the copies. out_mode
// and out_map: StepOut. R2: the two roundings (epilogue_value).
template <typename T, int P, bool R2>
__global__ void __launch_bounds__(kTailThreads, 1)
    conv3x3_pixelshuffle_wgmma_ring_kernel(const T* __restrict__ x, T* __restrict__ out,
                                           const uint4* __restrict__ wq,
                                           const float* __restrict__ sb, int nimg, int h, int wd,
                                           int cin, int cout, int r, TailPlan plan, int tiles_h,
                                           int tiles_w, int tensor_in, int out_mode,
                                           const __grid_constant__ CUtensorMap in_map,
                                           const __grid_constant__ CUtensorMap out_map) {
  using Op = Op2<T>;
  constexpr int WGS = kTailWarpgroups, MB = kTailBlocks, N = 8 * kStepNt * P, ND = N / 2;
  // m-blocks whose sums a warpgroup holds at once: both under one product
  // (2 x 24 registers), one under two (48; two sets of 48 spill at the
  // 168-register cap of 384 threads), whose m-blocks then take a pass over
  // the step's units each
  constexpr int MBR = P == 2 ? 1 : MB;
  constexpr int kWords = 8;  // a box row has at most 256 words: 8 a lane
  extern __shared__ __align__(128) uint8_t smem[];
  const Tile tile = plan.tile;
  const WgTail gm = wg_tail(cin, cout, r, tile, P, plan.nbuf, plan.nres);
  Ring32 ring(smem, gm.nbuf, gm.unit_bytes);
  uint64_t* const wbar = reinterpret_cast<uint64_t*>(smem + kWindowBar);
  uint32_t* const raw = reinterpret_cast<uint32_t*>(smem + gm.raw);
  uint8_t* const res = smem + gm.res;
  uint32_t* const win = reinterpret_cast<uint32_t*>(smem + gm.win);
  float* const ssb = reinterpret_cast<float*>(smem + gm.sb);
  int* const tab = reinterpret_cast<int*>(smem + gm.tab);
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int pw = cin / 2;  // words of an input pixel, where tensor_in
  // a channel pair lies side by side in the result, at an even value
  const bool pairs = !tile_layout(out_mode) || gm.runh % 2 == 0;

  // once per block: scales and biases; where a channel goes in a step's
  // result; and zero planes where tensor copies bring the windows
  // (re-laying one writes no pad channel)
  for (int i = threadIdx.x; i < 16 * gm.nt; i += kTailThreads) ssb[i] = __ldg(sb + i);
  fill_table(tab, gm.nt, gm.nch, gm.runh, tile, out_mode, kTailThreads);
  if (tensor_in)
    for (int i = threadIdx.x; i < (gm.sb - gm.win) / 4; i += kTailThreads) win[i] = 0u;
  ring.init();
  if (threadIdx.x == 0) mbar_init(wbar, 1);
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
  // the tile pixel of this lane's rows g and g+8 of each of its m-blocks
  // (of its warp's 16 output indices) as fill_table counts it; -1: dropped
  // (past the tile, and the pitch trick's columns)
  const int nb = (gm.blocks - wg + WGS - 1) / WGS;  // this warpgroup's m-blocks a tile
  const int lay = tile_layout(out_mode) ? r : 1;   // output rows a tile row in the result
  const int per = per_pixel(out_mode, gm.runh);
  int px[MB][2];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 64 * (wg + WGS * i) + 16 * (warp % 4) + g + 8 * hr;
      const int row = p / gm.wi, c = p - row * gm.wi;
      px[i][hr] = row < tile.th && c < tile.tw ? (row * lay * tile.tw + c) * per : -1;
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
    mbar_expect(wbar, static_cast<unsigned>(gm.bx.nbox * gm.hi * gm.bx.box_w * 4));
    for (int b = 0; b < gm.bx.nbox; ++b)
      tensor_load_3d(raw + b * gm.bx.box_words, in_map_at,
                     (((tx0 - 1) * pw) & ~3) + (b << gm.bx.ppb_log2) * pw, ty0 - 1, n, wbar);
  };
  // the units of weights this block reads through the ring: a tile's
  // steps, each in `passes` passes over its taps, after another's
  const uint8_t* const wbytes = reinterpret_cast<const uint8_t*>(wq);
  const int passes = cdiv(cdiv(gm.blocks, WGS), MBR);
  const int per_tile = gm.steps * passes * kTaps;
  const int bx = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);
  const int jtotal = (bx < total ? (total - 1 - bx) / grid + 1 : 0) * per_tile;
  auto fetch = [&](int jj) {
    if (jj < jtotal) {
      const int u = jj % per_tile, step = u / (passes * kTaps);
      ring.load(jj, wbytes + static_cast<size_t>(step * kTaps + u % kTaps) * gm.unit_bytes,
                static_cast<unsigned>(gm.unit_bytes));
    }
  };

  // step nc of tile tl's result (in rb) to device memory; what StepOut
  // needs is made here, so that none of it is live over the MMAs
  auto store_step = [&](const uint8_t* rb, int tl, int nc) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    const StepOut<kTailThreads, unsigned short> step_out{
        out, out_map_at, out_mode, gm.nch, gm.runh, 2, r, wd, tile, n, ty0, tx0,
        wd - tx0 < tile.tw ? wd - tx0 : tile.tw, h - ty0 < tile.th ? h - ty0 : tile.th,
        static_cast<long long>(n) * h + ty0};
    step_out(rb, nc);
  };

  int tl = blockIdx.x;
  if (threadIdx.x == 0) {
    for (int jj = 0; jj < gm.nbuf; ++jj) fetch(jj);
    if (tensor_in && tl < total) request_window(tl);
  }
  unsigned phase = 0;
  const unsigned a0 = smem_addr(win) + static_cast<unsigned>(64 * wg) * 16;
  const unsigned lbo = static_cast<unsigned>(gm.ps) * 16;  // bytes from one plane to the next
  int sc = 0;  // steps of this block so far, across tiles: step sc writes result sc % nres

  // step nc of this warpgroup's i-th m-block from d into the result rb:
  // this lane holds, of each n-tile, channels 2t and 2t+1, which go where
  // the table says
  auto epilogue = [&](const float (&d)[ND], int i, int nc, uint8_t* rb) {
    uint32_t* const r32 = reinterpret_cast<uint32_t*>(rb);
    unsigned short* const r16 = reinterpret_cast<unsigned short*>(rb);
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
        const int p = px[i][hr];
        if (pairs) {
          if ((p | at.x) >= 0) r32[(p + at.x) >> 1] = yb;
        } else {
          if ((p | at.x) >= 0) r16[p + at.x] = static_cast<unsigned short>(yb & 0xffffu);
          if ((p | at.y) >= 0) r16[p + at.y] = static_cast<unsigned short>(yb >> 16);
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
      mbar_wait(wbar, phase);
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
    // one result buffer (or the tile's): the last store has read it
    if (gm.nres <= 1 && threadIdx.x == 0) bulk_wait_read();
    fence_proxy_async();  // the MMAs read the planes
    __syncthreads();      // the planes are whole; raw is free again
    if (tensor_in && threadIdx.x == 0 && tl + gridDim.x < total) request_window(tl + gridDim.x);

    for (int nc = 0; nc < gm.steps; ++nc, ++sc) {
      uint8_t* const rb = gm.nres ? res + (sc % gm.nres) * gm.res_bytes : res;
      // in each pass over the step's units a tap's MMAs of the pass's
      // m-blocks are waited for before the tap's unit is released; their
      // accumulator sets live over the step's taps
      for (int q = 0; q < passes; ++q) {
        float d[MBR][ND];
        // this warpgroup's m-blocks of the pass, and the warps that read
        // its units (a warpgroup without one has none in any tile: it
        // never waits on the ring, and no phase of a buffer can alias)
        const int nbq = nb - MBR * q < 0 ? 0 : nb - MBR * q < MBR ? nb - MBR * q : MBR;
        const int left = gm.blocks - WGS * MBR * q;
        const int active = 4 * (left < WGS ? left : WGS);
#pragma unroll
        for (int i = 0; i < MBR; ++i) fence_acc(d[i]);
        for (int tap = 0; tap < kTaps; ++tap) {
          if (nbq > 0) {
            const unsigned b = ring.wait();
            const int ky = tap / 3;
            tap_issue<T, N, ND, MBR>(
                d, nbq,
                a0 + static_cast<unsigned>(WGS * 64 * MBR * q + ky * gm.wi + tap - 3 * ky) * 16,
                static_cast<unsigned>(WGS * 64 * 16), lbo, b, gm.kc, tap == 0);
            if (tap > 0) {
              wgmma_wait<1>();  // the tap before's MMAs are done, this tap's run on
              ring.release_prev(active, fetch);  // every MMA of this warp has read it
            }
          }
          ring.advance();
        }
        if (nbq > 0) {
          wgmma_wait<0>();
          ring.release_prev(active, fetch);
        }
#pragma unroll
        for (int i = 0; i < MBR; ++i) fence_acc(d[i]);
        if (q == 0 && gm.nres == 1 && nc > 0) {
          if (threadIdx.x == 0) bulk_wait_read();
          __syncthreads();  // the step before has left the one result buffer
        }
#pragma unroll
        for (int i = 0; i < MBR; ++i)
          if (i < nbq) epilogue(d[i], MBR * q + i, nc, rb);
      }
      if (gm.nres == 0 && nc + 1 < gm.steps) continue;  // the tile's result: out after the last
      if (out_mode != kOutPlain) fence_proxy_async();  // the tensor stores read the result
      // two result buffers: the step before's store has read the one the
      // next step writes
      if (gm.nres == 2 && threadIdx.x == 0) bulk_wait_read();
      __syncthreads();  // the step's result is whole (after the last: the planes are free again)
      store_step(rb, tl, nc);
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes
}

// The plan of a 2-byte path with P products: the first tile, in the order
// 16x22, 8x22 (6 and 3 m-blocks of 64, as many for each warpgroup), 16x14
// (4), 8x14 and 8x8 (2), whose layout fits a block with every unit of
// weights resident and the whole tile's result (the resident kernel;
// streaming the weights measured slower than a smaller tile with resident
// weights: SCET's 64 -> 64 under fast, PERF.md); else the first tile with
// the deepest ring (4 to 2 buffers) and the whole tile's result, two step
// results or one, where they fit (the ring kernel). The last plan if none
// fits (the host function refuses it).
inline TailPlan pick_tail_plan(int cin, int cout, int r, int P) {
  const Tile tiles[] = {{16, 22}, {8, 22}, {16, 14}, {8, 14}, {8, 8}};
  const auto fits = [&](Tile t, int nbuf, int nres) {
    const WgTail g = wg_tail(cin, cout, r, t, P, nbuf, nres);
    return static_cast<size_t>(g.bytes) <= kMaxSmem && g.blocks <= kTailWarpgroups * kTailBlocks;
  };
  for (const Tile& t : tiles)  // the weights resident
    if (fits(t, 0, 0)) return {t, 0, 0};
  int nres[3];
  const int kres = res_choices(cdiv(ntiles(cout * r * r), kStepNt), nres);
  for (const Tile& t : tiles)  // else streamed
    for (int nbuf = kRing32; nbuf >= 2; --nbuf)
      for (int k = 0; k < kres; ++k)
        if (fits(t, nbuf, nres[k])) return {t, nbuf, nres[k]};
  return {tiles[4], 2, 1};
}

// ---- the f32 and bf16 paths on split TF32, on warpgroup MMA ------------

// The folded form takes the taps into K up to this many input channels (one
// k-chunk of 16); wider inputs take the per-tap form, unrolled at 2 to 4
// k-chunks, a loop over k-steps beyond.
constexpr int kFoldMaxCin = 16;
constexpr int kFoldKc = -1;  // the KC of the folded form
// k-steps of 8 (tap, channel) pairs a folded unit takes: each k-step's
// products summed from zero (tools/accumulation_model.py: a fresh sum over
// 4 k-steps at K = 27 models 3.0-5.3x an f32 FMA chain's error, over one
// 1.5-2.5x)
constexpr int kFoldSteps = 1;

__host__ __device__ inline bool tail_tf32_folded(int cin) { return cin <= kFoldMaxCin; }

// The wgmma split-TF32 tail's widths, regions and work, and its shared
// memory, byte offsets: [the ring's mbarriers and release counters][the
// ring: nbuf buffers of one unit's weights][nres step results][window]
// [biases][channel table][the folded form's (tap, channel) offsets], the
// first three at multiples of 128 bytes (bulk copies into the ring, the
// tensor stores from the results). A unit is one tap of one step (per tap)
// or kFoldSteps k-steps of K = 9 cin (folded); a step's units run in turn
// through the ring. The window is f32 at sw words a pixel; the tile's last
// m-block reads up to 2 wi + 2 pixels past its end (rows the epilogue
// drops).
struct WgTail32 {
  int kc, nch, nt, steps;  // k-chunks of 16 inputs, conv channels, n-tiles of 8, steps
  int units, ks;           // units of a step, k-steps of a unit
  int sw, runh;            // window words a pixel; values of one pixel's run in an output row
  int hi, wi, blocks;      // window rows and pitch; m-blocks of 64 output indices
  int unit_bytes, nbuf, nres, res_bytes;
  int ring, res, win, bias, tab, foff, bytes;
};

__host__ __device__ inline WgTail32 wg_tail32(int cin, int cout, int r, Tile t, int vbytes,
                                              int nbuf, int nres) {
  WgTail32 g;
  const bool fold = tail_tf32_folded(cin);
  g.kc = kchunks(cin);
  g.nch = cout * r * r;
  g.nt = ntiles(g.nch);
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
  g.nbuf = nbuf;
  g.nres = nres;
  g.res_bytes = res_bytes_of(g.nch, t, vbytes, nres);
  const int win_b = cdiv((64 * g.blocks + 2 * g.wi + 2) * g.sw * 4, 16) * 16;
  const int foff_b = fold ? 8 * kFoldSteps * g.units * 4 : 0;
  g.ring = kRing32Head;
  g.res = g.ring + nbuf * g.unit_bytes;
  g.win = g.res + (nres ? nres : 1) * g.res_bytes;
  g.bias = g.win + win_b;
  g.tab = g.bias + 8 * g.nt * 4;
  g.foff = g.tab + 8 * g.nt * 4;
  g.bytes = g.foff + foff_b;
  return g;
}

// x: NHWC (nimg, h, wd, cin) of T (float: parity, high and mixed, P = 3;
// bf16: fasthi, P = 2; P = 1 only in the control of tools/chain_check.py);
// out: NHWC (nimg, r*h, r*wd, cout) of T. wq: the packed weights of
// ops/kernels/tail.py pack_tail_wgmma_tf32 (KC = the k-chunks of cin, or 0
// for any number; per tap) or pack_tail_wgmma_tf32_fold (KC = kFoldKc,
// folded): the conv's channels in the order (i, j, c), [step of kStepNt
// n-tiles][unit][k-step][hi, lo] and per k-step and term a 48 x 8 B
// operand, [group of 8 columns][k 0-3, k 4-7][8 columns][4 k], zero past
// the conv's channels and past cin (per tap) or 9 cin (folded). bias: in
// that order, padded to whole n-tiles. A persistent grid: block b takes the
// tiles b, b + gridDim.x, ... of the nimg * tiles_h * tiles_w (image, tile
// row, tile column) items; its units of weights run on across steps and
// tiles through the ring. out_mode and out_map: StepOut.
template <typename T, int P, int KC>
__global__ void __launch_bounds__(kTailThreads, 1)
    conv3x3_pixelshuffle_wgmma_tf32_kernel(const T* __restrict__ x, T* __restrict__ out,
                                           const uint8_t* __restrict__ wq,
                                           const float* __restrict__ bias, int nimg, int h,
                                           int wd, int cin, int cout, int r, TailPlan plan,
                                           int tiles_h, int tiles_w, int out_mode,
                                           const __grid_constant__ CUtensorMap out_map) {
  constexpr int WGS = kTailWarpgroups;
  constexpr bool FOLD = KC == kFoldKc;
  constexpr int KS = FOLD ? kFoldSteps : 2 * KC;  // k-steps a unit (0: the unit's, at run time)
  // k-steps a group, chosen on the card (ROADMAP, Decisions on the
  // split-TF32 tail's warpgroup MMA): 2 under 3 products (16 A registers;
  // a whole tap at 3 k-chunks, 48, spills at the 168-register cap of 384
  // threads: tools/chain_clocks.py --kernel tail_tf32 --variant kgunit) or
  // at any width; a unit's under 2 products up to 3 k-chunks (24
  // registers), else 2
  constexpr int KG = FOLD ? KS : P == 3 || KS == 0 || KS > 6 ? 2 : KS;
  extern __shared__ __align__(128) uint8_t smem[];
  const Tile tile = plan.tile;
  const WgTail32 gm = wg_tail32(cin, cout, r, tile, sizeof(T), plan.nbuf, plan.nres);
  Ring32 ring(smem, gm.nbuf, gm.unit_bytes);
  uint8_t* const res = smem + gm.res;
  float* const win = reinterpret_cast<float*>(smem + gm.win);
  float* const sbias = reinterpret_cast<float*>(smem + gm.bias);
  int* const tab = reinterpret_cast<int*>(smem + gm.tab);
  int* const foff = reinterpret_cast<int*>(smem + gm.foff);
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  // a channel pair lies side by side in the result, at an even value
  const bool pairs = !tile_layout(out_mode) || gm.runh % 2 == 0;

  // once per block: biases; where a channel goes in a step's result;
  // folded, the window offset of each K index (tap, channel), -1 past 9 cin
  for (int i = threadIdx.x; i < 8 * gm.nt; i += kTailThreads) sbias[i] = __ldg(bias + i);
  fill_table(tab, gm.nt, gm.nch, gm.runh, tile, out_mode, kTailThreads);
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
  // the tile pixel of this lane's rows g and g+8 of m-block mb as
  // fill_table counts it (-1: dropped, past the tile and the pitch trick's
  // columns)
  const int lay = tile_layout(out_mode) ? r : 1;  // output rows a tile row in the result
  const int per = per_pixel(out_mode, gm.runh);
  auto pixel = [&](int mb, int hr) {
    const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr, row = p / gm.wi, c = p - row * gm.wi;
    return row < tile.th && c < tile.tw ? (row * lay * tile.tw + c) * per : -1;
  };

  // step nc's running sums of m-block mb, + bias, rounded to T, into the
  // result rb where the table says: this lane holds, of each n-tile,
  // channels 2t and 2t+1
  auto epilogue = [&](const float (&s)[24], int mb, int nc, T* rb) {
    const int px0 = pixel(mb, 0), px1 = pixel(mb, 1);
#pragma unroll
    for (int jn = 0; jn < kStepNt; ++jn) {
      const int ntg = nc * kStepNt + jn;
      if (ntg >= gm.nt) continue;  // the zero pad of the last step
      const float2 b2 = reinterpret_cast<const float2*>(sbias + 8 * ntg)[t];
      const int2 to = reinterpret_cast<const int2*>(tab + 8 * ntg)[t];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int e = 4 * jn + 2 * hr, p = hr ? px1 : px0;
        const float v0 = Act<T>::store_out(s[e] + b2.x);
        const float v1 = Act<T>::store_out(s[e + 1] + b2.y);
        if (pairs) {
          if ((p | to.x) >= 0) store_pair(rb + p + to.x, make_float2(v0, v1));
        } else {
          if ((p | to.x) >= 0) rb[p + to.x] = Act<T>::store(v0);
          if ((p | to.y) >= 0) rb[p + to.y] = Act<T>::store(v1);
        }
      }
    }
  };

  // step nc of tile tl's result (in rb) to device memory; what StepOut
  // needs is made here, so that none of it is live over the MMAs. The
  // map's address is taken in the kernel's own scope
  const CUtensorMap* const out_map_at = &out_map;
  auto store_step = [&](const uint8_t* rb, int tl, int nc) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    const StepOut<kTailThreads, typename Bits<T>::type> step_out{
        out, out_map_at, out_mode, gm.nch, gm.runh, static_cast<int>(sizeof(T)), r, wd, tile, n,
        ty0, tx0, wd - tx0 < tile.tw ? wd - tx0 : tile.tw, h - ty0 < tile.th ? h - ty0 : tile.th,
        static_cast<long long>(n) * h + ty0};
    step_out(rb, nc);
  };
  int sc = 0;  // steps of this block so far, across tiles: step sc writes result sc % nres
  for (int tl = blockIdx.x; tl < total; tl += gridDim.x) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    load_window_f32<kTailThreads>(x, n, h, wd, cin, ty0 - 1, tx0 - 1, gm.hi, gm.wi, gm.sw,
                                  FOLD ? 0 : gm.kc, win);
    // one result buffer (or the tile's): the last store has read it (it
    // drained under the window's load)
    if (gm.nres <= 1 && threadIdx.x == 0) bulk_wait_read();
    __syncthreads();  // the window is whole

    // each step over all its units, a unit's weights read by both of a
    // warpgroup's m-blocks, wg and wg + WGS, whose running sums both stay
    // live
    for (int nc = 0; nc < gm.steps; ++nc, ++sc) {
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
                                       foff + 8 * kFoldSteps * u, b, t, gm.ks);
#pragma unroll
            for (int e = 0; e < 24; ++e) sum[i][e] += d[e];
          }
          // every MMA of this warp has read the unit
          ring.release(active, fetch);
        }
        ring.advance();
      }
      T* const rb = reinterpret_cast<T*>(gm.nres ? res + (sc % gm.nres) * gm.res_bytes : res);
      if (gm.nres == 1 && nc > 0) {
        if (threadIdx.x == 0) bulk_wait_read();
        __syncthreads();  // the step before has left the one result buffer
      }
#pragma unroll
      for (int i = 0; i < kTailBlocks; ++i)
        if (i < nb) epilogue(sum[i], wg + WGS * i, nc, rb);
      if (gm.nres == 0 && nc + 1 < gm.steps) continue;  // the tile's result: out after the last
      if (out_mode != kOutPlain) fence_proxy_async();  // the tensor stores read the result
      // two result buffers: the step before's store has read the one the
      // next step writes
      if (gm.nres == 2 && threadIdx.x == 0) bulk_wait_read();
      __syncthreads();  // the step's result is whole (after the last: the window is free again)
      store_step(reinterpret_cast<const uint8_t*>(rb), tl, nc);
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes
}

// The plan of a split-TF32 path on values of vbytes: the first tile, in the
// order 16x22 (6 m-blocks), 8x22 (3), 8x8 (2) and 4x4 (1; a 16x14 tile
// needs more of the window and the result than 8x22), whose layout fits a
// block with the deepest ring (4 to 2 buffers), two step results where
// they fit, else one. The last plan if none fits (the host function
// refuses it).
inline TailPlan pick_tail_plan32(int cin, int cout, int r, int vbytes) {
  const Tile tiles[] = {{16, 22}, {8, 22}, {8, 8}, {4, 4}};
  int nres[3];
  const int kres = res_choices(cdiv(ntiles(cout * r * r), kStepNt), nres);
  for (const Tile& t : tiles)
    for (int nbuf = kRing32; nbuf >= 2; --nbuf)
      for (int k = 0; k < kres; ++k) {
        const WgTail32 g = wg_tail32(cin, cout, r, t, vbytes, nbuf, nres[k]);
        if (static_cast<size_t>(g.bytes) <= kMaxSmem &&
            g.blocks <= kTailWarpgroups * kTailBlocks)
          return {t, nbuf, nres[k]};
      }
  return {tiles[3], 2, 1};
}

}  // namespace esr

using namespace esr;

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (null if
// it has none)
typedef CUresult (*TensorMapEncode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The launch of one 2-byte path's kernel: the resident kernel, or the
// ring kernel where the plan streams the weights
template <typename T, int P, bool R2>
static int launch_tail_2byte(dim3 grid, size_t smem, void* stream, const void* x, void* out,
                             const uint4* wq, const float* sb, int n, int h, int wd, int cin,
                             int cout, int r, TailPlan pl, int tiles_h, int tiles_w,
                             int tensor_in, int out_mode, const CUtensorMap& in_map,
                             const CUtensorMap& out_map) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (pl.nbuf)
    return launch_threads(conv3x3_pixelshuffle_wgmma_ring_kernel<T, P, R2>, grid, kTailThreads,
                          smem, stream, xt, ot, wq, sb, n, h, wd, cin, cout, r, pl, tiles_h,
                          tiles_w, tensor_in, out_mode, in_map, out_map);
  return launch_threads(conv3x3_pixelshuffle_wgmma_kernel<T, P, R2>, grid, kTailThreads, smem,
                        stream, xt, ot, wq, sb, n, h, wd, cin, cout, r, pl.tile, tiles_h, tiles_w,
                        tensor_in, out_mode, in_map, out_map);
}

// The launch of a split-TF32 path with P products, in its form for cin:
// folded, per tap unrolled at cin's 2 to 4 k-chunks, or per tap at any
// number. tools/chain_check.py --one-product patches fasthi's call to
// P = 1.
template <typename T, int P>
static int launch_tail_tf32(dim3 grid, size_t smem, void* stream, const void* x, void* out,
                            const void* wq, const float* bias, int n, int h, int wd, int cin,
                            int cout, int r, TailPlan pl, int tiles_h, int tiles_w, int out_mode,
                            const CUtensorMap& out_map) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const uint8_t* wb = static_cast<const uint8_t*>(wq);
  const auto go = [&](auto kernel) {
    return launch_threads(kernel, grid, kTailThreads, smem, stream, xt, ot, wb, bias, n, h, wd,
                          cin, cout, r, pl, tiles_h, tiles_w, out_mode, out_map);
  };
  switch (tail_tf32_folded(cin) ? kFoldKc : kchunks(cin)) {
    case kFoldKc:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, kFoldKc>);
    case 2:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 2>);
    case 3:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 3>);
    case 4:
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 4>);
    default:  // over 64 input channels
      return go(conv3x3_pixelshuffle_wgmma_tf32_kernel<T, P, 0>);
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
  if (P) return wg_tail(cin, cout, r, pl.tile, P, pl.nbuf, pl.nres).bytes;
  return wg_tail32(cin, cout, r, pl.tile, dtype == 0 ? 4 : 2, pl.nbuf, pl.nres).bytes;
}

// The plan of a launch (ops/kernels/tail.py wgmma_plan reckons the same):
// plan[0..3] = tile rows, tile columns, ring buffers (0: the weights stay
// in shared memory), step result buffers. dtype and fast as in
// conv3x3_pixelshuffle.
extern "C" void conv3x3_pixelshuffle_plan(int dtype, int fast, int cin, int cout, int r,
                                          int* plan) {
  const TailPlan pl = plan_of(dtype, fast, cin, cout, r);
  plan[0] = pl.tile.th;
  plan[1] = pl.tile.tw;
  plan[2] = pl.nbuf;
  plan[3] = pl.nres;
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, cin) NHWC contiguous;
// out: (n, r*h, r*wd, cout) NHWC contiguous.
// fast = 0, dtype 1 (fasthi16): w is the f16 hi/lo split as wgmma operands
// with the conv's channels in shuffled order, and b the scales and biases,
// as conv3x3_pixelshuffle_wgmma_kernel<__half, 2, false> reads them.
// fast = 1, dtype 1 or 2 (fast16, fast): w is the weights rounded to the
// activation type, one term in the same layout, and b scales of 1 and the
// biases rounded to it, as the kernels <T, 1, true> read them.
// fast = 0, dtype 0 and 2 (parity, high, mixed, fasthi): w is the TF32
// hi/lo split as wgmma B operands with the conv's channels in shuffled
// order, per tap or folded as cin chooses (tail_tf32_folded), and b the
// biases, as conv3x3_pixelshuffle_wgmma_tf32_kernel reads them.
// Every grid is persistent: one block for each SM of the current device,
// or for each tile if there are fewer. Returns cudaGetLastError() after
// the launch.
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
  const int tiles_h = cdiv(h, t.th), tiles_w = cdiv(wd, t.tw);
  const long long total = static_cast<long long>(n) * tiles_h * tiles_w;  // items
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(total < sms ? total : sms));
  const TensorMapEncode encode = tensor_map_encoder();

  // How the result leaves the block (StepOut): the whole tile (one step,
  // or a plan with the tile's result) by one tensor store, a box of (tw
  // runs, r * th, 1) where a tile's rows are multiples of 16 bytes
  // (kOutRows), else of (run, tw, r * th, 1) where a pixel's run in an
  // output row is (kOutRuns); each step's result by a box of a chunk of
  // every tile pixel's run (kOutPixels) where the runs are multiples of 16
  // bytes. The boxes are at most 256 elements a side, whole 32-bit words,
  // from a 16-byte aligned base. Else plain stores.
  const int vb = dtype == 0 ? 4 : 2;
  const int steps = cdiv(ntiles(cout * r * r), kStepNt);
  const long long runb = static_cast<long long>(vb) * r * cout, out_row = runb * wd;
  const long long tile_row = runb * t.tw;
  const bool out_ok = encode && reinterpret_cast<uintptr_t>(out) % 16 == 0 && t.th * r <= 256;
  const bool whole = steps == 1 || pl.nres == 0;  // the result in the tile's layout
  int out_mode = whole ? kOutTilePlain : kOutPlain;
  if (out_ok && whole && runb % 4 == 0 && out_row % 16 == 0 && tile_row % 16 == 0 &&
      tile_row / 4 <= 256)
    out_mode = kOutRows;  // the widest boxes: whole tile rows
  else if (out_ok && whole && runb % 16 == 0 && runb / 4 <= 256)
    out_mode = kOutRuns;
  else if (out_ok && !whole && runb % 16 == 0)
    out_mode = kOutPixels;
  CUtensorMap out_map;
  memset(&out_map, 0, sizeof(out_map));
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const cuuint64_t rows = static_cast<cuuint64_t>(h) * r;
  CUresult made = CUDA_SUCCESS;
  if (out_mode == kOutRuns) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(runb / 4), static_cast<cuuint64_t>(wd),
                                rows, static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(runb),
                                   static_cast<cuuint64_t>(out_row),
                                   static_cast<cuuint64_t>(out_row) * rows};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(runb / 4), static_cast<cuuint32_t>(t.tw),
                               static_cast<cuuint32_t>(t.th * r), 1};
    made = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4, out, dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else if (out_mode == kOutRows) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(out_row / 4), rows,
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(out_row),
                                   static_cast<cuuint64_t>(out_row) * rows};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(tile_row / 4),
                               static_cast<cuuint32_t>(t.th * r), 1};
    made = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, out, dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else if (out_mode == kOutPixels) {
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(runb / 4), static_cast<cuuint64_t>(wd),
                                static_cast<cuuint64_t>(r), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[4] = {static_cast<cuuint64_t>(runb),
                                   static_cast<cuuint64_t>(out_row),
                                   static_cast<cuuint64_t>(out_row) * r,
                                   static_cast<cuuint64_t>(out_row) * rows};
    const cuuint32_t box[5] = {static_cast<cuuint32_t>(chunk_values(r * cout) * vb / 4),
                               static_cast<cuuint32_t>(t.tw), 1, static_cast<cuuint32_t>(t.th),
                               1};  // a chunk of a run, of every tile pixel
    made = encode(&out_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 5, out, dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (made != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  if (!P) {
    if (dtype == 0)
      return launch_tail_tf32<float, 3>(grid, smem, stream, x, out, w, bf, n, h, wd, cin, cout, r,
                                        pl, tiles_h, tiles_w, out_mode, out_map);
    return launch_tail_tf32<__nv_bfloat16, 2>(grid, smem, stream, x, out, w, bf, n, h, wd, cin,
                                              cout, r, pl, tiles_h, tiles_w, out_mode, out_map);
  }
  // The window by tensor copies where the input's rows are multiples of 16
  // bytes from a 16-byte aligned base, in boxes of at most 256 words: the
  // map views x as words (channel pairs), whatever the 2-byte type.
  const int hi = t.th + 2;
  const Boxes bx = boxes_of(cin, hi, t.tw + 2);
  const long long in_row = static_cast<long long>(wd) * cin * 2;
  const int tensor_in = encode && cin % 2 == 0 && cin <= 126 && in_row % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(x) % 16 == 0 && hi <= 256;
  CUtensorMap in_map;
  memset(&in_map, 0, sizeof(in_map));
  if (tensor_in) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(in_row / 4), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(in_row),
                                   static_cast<cuuint64_t>(in_row) * h};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(bx.box_w), static_cast<cuuint32_t>(hi), 1};
    if (encode(&in_map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(x), dims, strides,
               box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint4* wq = static_cast<const uint4*>(w);
  if (fast && dtype == 1)
    return launch_tail_2byte<__half, 1, true>(grid, smem, stream, x, out, wq, bf, n, h, wd, cin,
                                              cout, r, pl, tiles_h, tiles_w, tensor_in, out_mode,
                                              in_map, out_map);
  if (fast)
    return launch_tail_2byte<__nv_bfloat16, 1, true>(grid, smem, stream, x, out, wq, bf, n, h, wd,
                                                     cin, cout, r, pl, tiles_h, tiles_w, tensor_in,
                                                     out_mode, in_map, out_map);
  return launch_tail_2byte<__half, 2, false>(grid, smem, stream, x, out, wq, bf, n, h, wd, cin,
                                             cout, r, pl, tiles_h, tiles_w, tensor_in, out_mode,
                                             in_map, out_map);
}
