// conv3x3_chain: `depth` same-padded 3x3 convolutions, each + bias,
// rounded to the activation type as ops/nn.py store_out does, then
// LeakyReLU(slope); then + x when `residual`. The RLFB body of RLFN.
//
// Replaces ntire2022_esr_tpu/ops/pallas/conv_chain.py fused_conv3x3_chain.
// One block per (image, output tile). The tile plus a halo of `depth`
// pixels is loaded once; the stages run in shared memory as ping-pong
// buffers, each stage's region two pixels smaller than the one before, and
// only the last stage's tile goes back to device memory. After every stage
// but the last, positions outside the image are zeroed, so the next stage
// sees torch's zero padding. Unlike the Pallas kernel, each stage's output
// is rounded to the storage type (f16 saturating under fasthi16): the
// unfused graph's per-conv rounding, which the shipped tier's accuracy was
// measured on.
//
// Two kernels share that plan.
//
// 2-byte activations (fasthi16, fast16, fast), conv3x3_chain_mma_kernel<T,
// P, R2>: each stage is an implicit GEMM of mma.sync.m16n8k16 instructions
// on activations of T (f16 or bf16), accumulated in f32 (mma_stage.cuh
// gives the fragment and shared-memory layouts). Under fasthi16 (P = 2) the
// f32 weights are split into two f16 terms, two products a fragment
// (f32-grade); under fast16 and fast (P = 1) the weights are 2-byte
// themselves, packed once rounded to T, one exact product a fragment, and
// the epilogue rounds each sum to T before it adds the bias (R2: two
// roundings, as ops/nn.py conv2d computes a 2-byte contraction's output).
// What the design does about the card's limits:
//  - activations are 2-byte in shared memory, so a 16x32 tile with its
//    halo (22x38, then 20x36 pixels of 112 bytes) fits beside a double
//    buffer of weights: 225 KB under P = 2, 198 KB under P = 1; one block
//    of 8 warps per SM (the 27 KB that one term frees does not fit the next
//    taller tile, 20x32; an 18x32 tile does not divide RLFN's 256 rows and
//    takes a third pass at its first stage);
//  - the weights of one kernel row of one stage (27 KB at 48x48 channels
//    under P = 2, 13.5 KB under P = 1) are fetched with cp.async while the
//    previous row's MMAs run; one barrier per row;
//  - a warp accumulates up to 3 m-tiles of 16 pixels x 6 n-tiles of 8
//    channels in P sets (144 or 72 registers), so each weight fragment read
//    from shared memory feeds 3P MMAs; a stage's m-tiles take one or more
//    passes, 3 a warp while that many are left, then the rest split evenly;
//  - the epilogue runs on the accumulator registers: unscale (P = 2), bias,
//    the round to T (f16 saturating), LeakyReLU, zero outside the image,
//    and a store of T for the next stage; scales and biases wait in shared
//    memory;
//  - the window and the output tile are copied with many loads in flight
//    per thread, and no loop divides.
// Bound on an H100 (see PERF.md): at RLFN's 46->48->48->46 widths the chain
// does 9*(46*48+48*48+48*46) = 59,616 MACs per pixel and moves 184 bytes
// per pixel, so it is bound by operations: 1.03 ms at batch 128 x 256^2 on
// 2-byte tensor cores (989 TFLOP/s, one product per MAC). The kernel does P
// products per MAC, a 20% halo at the 16x32 tile and 5-9% of dropped
// columns from the pitch trick, on mma.sync, which issues at two thirds of
// that rate; and its copies and epilogues do not overlap its MMAs.
//
// f32 and bf16 activations with f32 weights (parity, high, mixed, fasthi),
// conv3x3_chain_tf32_kernel: the same plan on split TF32 (mma.sync.m16n8k8,
// mma_stage.cuh "split TF32"): f32 weights as two TF32 terms packed on the
// host, activations split in registers, three products per fragment under
// f32 activations and two under bf16, each tap summed from zero by the MMAs
// and added to the running sums in f32. What the design does about the
// card's limits:
//  - activations are f32 in shared memory (a pixel of 48 channels is 192
//    bytes), so the tile is 16x16: its window and second buffer (22x22 and
//    20x20 pixels) take 170 KB, and the weights are staged one tap at a
//    time (18 KB at 48x48 channels, hi and lo), double-buffered with
//    cp.async, one barrier per tap: 207 KB. The halo recomputes
//    (20^2 + 18^2 + 16^2) / (3 * 16^2) = 1.28x the MACs of the tile;
//  - a warp holds 2 m-tiles x 6 n-tiles of running sums and of one tap's
//    sums (96 registers) and the next k-chunk's activations, so ptxas
//    spills nothing (3 m-tiles held 144 registers of sums, spilled, and
//    were no faster; PERF.md); the m-tiles of a stage (28, 23 and 18 at
//    RLFN's depth 3) take two passes of up to 16 each;
//  - the epilogue on the running sums: + bias, the store's rounding to T,
//    LeakyReLU with the slope rounded to T, zero outside the image.
// Bound: 60,480 MACs a pixel, against 368 bytes a pixel at f32: bound by
// operations. f32-grade products on f32 activations take 3 TF32 products at
// the card's 495 TFLOP/s of dense TF32: 6.15 ms at batch 128 x 256^2. On
// bf16 activations the cheapest f32-grade form is 3 bf16 products (the
// weight split into three bf16 terms) at 989 TFLOP/s: 3.08 ms. The kernel
// issues mma.sync, which reaches 325 TFLOP/s of TF32 on the card, over 1.42x
// the MACs (halo, the pitch trick's columns, whole m-tiles), and its shared
// loads and copies overlap its MMAs only in part.
#include "mma_stage.cuh"

namespace esr {

constexpr int kMaxDepth = 4;

struct Widths {
  int c[kMaxDepth + 1];  // c[0] input channels, c[k+1] output channels of stage k
};

// ---- the 2-byte path on the tensor cores ------------------------------

// Stage k of a chain: widths, regions and work split.
struct Stage {
  int cin, cout, kc, nt, nch;  // k-chunks of 16, n-tiles of 8, chunks of kNtChunk n-tiles
  int wi, ho, wo;              // input pitch; output rows and columns
  int tiles, passes;           // m-tiles of 16 output indices; passes of kWarps * MT m-tiles
  int woff;                    // this stage's packed weights, in 16-byte units
  int sboff;                   // this stage's scales and biases, in floats
};

// P: products a fragment (the packed weights' terms); MT: m-tiles a warp
__host__ __device__ inline Stage stage_of(const Widths& cw, int depth, Tile t, int k, int P,
                                          int MT) {
  Stage s;
  s.woff = 0;
  s.sboff = 0;
  for (int j = 0; j < k; ++j) {
    s.woff += 9 * kchunks(cw.c[j]) * ntiles(cw.c[j + 1]) * frag_units(P);
    s.sboff += 2 * 8 * ntiles(cw.c[j + 1]);
  }
  s.cin = cw.c[k];
  s.cout = cw.c[k + 1];
  s.kc = kchunks(s.cin);
  s.nt = ntiles(s.cout);
  s.nch = cdiv(s.nt, kNtChunk);
  s.wi = t.tw + 2 * (depth - k);
  s.wo = s.wi - 2;
  s.ho = t.th + 2 * (depth - k) - 2;
  // output indices p = r * wi + c; the last one kept is (ho - 1, wo - 1)
  s.tiles = cdiv(s.ho * s.wi - 2, 16);
  s.passes = cdiv(s.tiles, kWarps * MT);
  return s;
}

// Shared memory: [buf0][buf1][2 weight buffers of wsz 16-byte units][every
// stage's scales and biases, sbsz floats], the activation buffers in 32-bit
// words, `sw` words per pixel. A stage's last m-tile reads up to kOverrun
// pixels past its region: into buf1 from buf0 and into the weights from
// buf1, never past the allocation.
__host__ __device__ inline void mma_layout(const Widths& cw, int depth, Tile t, int P, int* wsz,
                                           int* sw, int* words0, int* words1, int* sbsz) {
  int w = 0, cmax = cw.c[0], sb = 0;
  for (int k = 0; k < depth; ++k) {
    const int nt = ntiles(cw.c[k + 1]);
    sb += 2 * 8 * nt;
    const int r = 3 * kchunks(cw.c[k]) * (nt < kNtChunk ? nt : kNtChunk) * frag_units(P);
    w = r > w ? r : w;
    // a stage's output holds whole n-tiles and the next stage's whole k-chunks
    const int c = kchunks(cw.c[k + 1]) * 16;
    cmax = c > cmax ? c : cmax;
  }
  *wsz = w;
  *sbsz = sb;
  *sw = pixel_words(cmax);
  const int hi = t.th + 2 * depth, wi = t.tw + 2 * depth;
  *words0 = hi * wi * *sw;
  const int px1 = (hi - 2) * (wi - 2);
  *words1 = (px1 > kOverrun ? px1 : kOverrun) * *sw;
}

__host__ __device__ inline size_t mma_smem_bytes(const Widths& cw, int depth, Tile t, int P) {
  int wsz, sw, words0, words1, sbsz;
  mma_layout(cw, depth, t, P, &wsz, &sw, &words0, &words1, &sbsz);
  return static_cast<size_t>(2) * wsz * 16 + static_cast<size_t>(words0 + words1 + sbsz) * 4;
}

// Where the chain's loop stands: stage, chunk of n-tiles, pass, kernel row.
// One step of it is one staged block of weights.
struct Cursor {
  int k, nc, pass, ky;
};

template <int P, int MT>
__device__ inline void advance(Cursor& c, Stage& s, const Widths& cw, int depth, Tile t) {
  if (++c.ky < 3) return;
  c.ky = 0;
  if (++c.pass < s.passes) return;
  c.pass = 0;
  if (++c.nc < s.nch) return;
  c.nc = 0;
  if (++c.k < depth) s = stage_of(cw, depth, t, c.k, P, MT);
}

__device__ inline int ntl_of(const Stage& s, int nc) {
  const int left = s.nt - nc * kNtChunk;
  return left < kNtChunk ? left : kNtChunk;
}

template <int P>
__device__ inline void fetch_weights(uint4* dst, const uint4* __restrict__ wq, const Stage& s,
                                     const Cursor& c) {
  const int ntl = ntl_of(s, c.nc);
  const int row = 3 * s.kc * ntl * frag_units(P);
  stage_weights_async(dst, wq + s.woff + 9 * s.kc * kNtChunk * frag_units(P) * c.nc + row * c.ky,
                      row);
}

// x, out: NHWC of T (__half: fasthi16, P = 2, and fast16, P = 1 with R2;
// __nv_bfloat16: fast, P = 1 with R2). wq: the packed weights of
// ops/kernels/conv_chain.py, per stage [chunk of n-tiles][ky][kx][k-chunk]
// [n-tile][lane][{b0, b1} of each term]: pack_chain_f16 (P = 2, hi and lo)
// or pack_chain_2byte (P = 1). sb: per stage [1/S per channel][bias per
// channel], both padded to whole n-tiles (1 and 0 in the pad); S = 1 under
// P = 1, and not read. R2: the two roundings (epilogue_value).
template <typename T, int P, bool R2>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_chain_mma_kernel(const T* __restrict__ x, T* __restrict__ out,
                             const uint4* __restrict__ wq, const float* __restrict__ sb, int h,
                             int wd, int depth, Widths cw, Tile tile, float slope, int residual,
                             int tiles_w) {
  using Op = Op2<T>;
  using T2 = typename Op::T2;
  constexpr int MT = mtiles(P);
  extern __shared__ uint4 smem16[];
  int wsz, sw, words0, words1, sbsz;
  mma_layout(cw, depth, tile, P, &wsz, &sw, &words0, &words1, &sbsz);
  // buffer b of each pair, by arithmetic on the shared-memory base (a
  // pointer array indexed at run time would make every access generic)
  uint32_t* const abuf0 = reinterpret_cast<uint32_t*>(smem16);
  uint4* const wbuf0 = smem16 + (words0 + words1) / 4;
  auto wbuf = [&](int b) { return wbuf0 + (b & 1) * wsz; };
  auto abuf = [&](int b) { return abuf0 + (b & 1) * words0; };
  // the epilogues read scales and biases from here: from device memory each
  // read would be a round trip to L2 that nothing hides
  float* const ssb = reinterpret_cast<float*>(wbuf0 + 2 * wsz);
  for (int i = threadIdx.x; i < sbsz; i += kThreads) ssb[i] = __ldg(sb + i);

  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * tile.th;
  const int tx0 = (blockIdx.x % tiles_w) * tile.tw;
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the slope rounded to T, as ops/nn.py leaky_relu (and JAX) round it
  const T2 slope2 = Op::splat(slope);
  const int c0 = cw.c[0];

  Cursor cur{0, 0, 0, 0};
  Stage st = stage_of(cw, depth, tile, 0, P, MT);
  fetch_weights<P>(wbuf(0), wq, st, cur);  // in flight while the window loads

  // the input window, zero outside the image and in the pad channels
  load_window_2byte(x, n, h, wd, c0, ty0 - depth, tx0 - depth, tile.th + 2 * depth, st.wi, sw,
                    st.kc, abuf0);

  float acc[P][MT][kNtChunk][4];  // this warp's sums of the pass, one set a term
  int mt0 = 0, cnt = 0;  // this warp's m-tiles in the current pass
  for (int j = 0; cur.k < depth; ++j) {
    cp_async_wait_all();
    __syncthreads();  // this step's weights and the previous stage's output are in place
    Cursor nxt = cur;
    Stage nst = st;
    advance<P, MT>(nxt, nst, cw, depth, tile);
    // the next step's weights, fetched into the buffer that the last step
    // read; every thread calls this once in this step
    auto prefetch = [&]() {
      if (nxt.k < depth) fetch_weights<P>(wbuf(j + 1), wq, nst, nxt);
    };

    const int ntl = ntl_of(st, cur.nc);
    if (cur.ky == 0) {
      // a pass begins with zeroed sums: MT m-tiles a warp while that many
      // are left, and the rest split evenly in the last pass (every row ends
      // at a barrier, so a pass costs what its busiest warp does)
      const int first = cur.pass * kWarps * MT;
      const int left = st.tiles - first;
      const int here = left < kWarps * MT ? left : kWarps * MT;
      mt0 = first + warp * here / kWarps;
      cnt = first + (warp + 1) * here / kWarps - mt0;
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int nn = 0; nn < kNtChunk; ++nn)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[p][m][nn][i] = 0.f;
    }
    const uint32_t* src = abuf(cur.k);
    const uint32_t* arow = src + (mt0 * 16 + cur.ky * st.wi + lane % 16) * sw + 4 * (lane / 16);
    const Frag<P>* wrow = reinterpret_cast<const Frag<P>*>(wbuf(j)) + lane;
    mma_conv_row_any<T, P, MT>(acc, arow, sw, st.kc, cnt, ntl, wrow, prefetch);

    if (cur.ky == 2) {
      // epilogue on the accumulators: this lane holds, of each m-tile, rows
      // g and g+8 and, of each n-tile, channels 2t and 2t+1
      uint32_t* dst = abuf(cur.k + 1);
      const bool last = cur.k == depth - 1;  // the last stage writes only in-image pixels out
      const int halo = depth - 1 - cur.k;    // the region starts `halo` pixels before the tile
      const float* sc = ssb + st.sboff;
      const float* bi = sc + 8 * st.nt;
      // the up to 2 * MT pixels of this lane: store offset (-1: dropped) and mask
      int off[MT][2];
      bool inside[MT][2];
      int r = (mt0 * 16 + g) / st.wi, c = mt0 * 16 + g - r * st.wi;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // rows g, g+8: output indices 8 apart
          // beyond cnt, and the pitch trick's garbage
          off[m][hr] = (m < cnt && r < st.ho && c < st.wo) ? (r * st.wo + c) * sw + t : -1;
          const int gy = ty0 - halo + r, gx = tx0 - halo + c;
          inside[m][hr] = last || (gy >= 0 && gy < h && gx >= 0 && gx < wd);
          c += 8;  // the pitch is at least 10, so this wraps once at most
          if (c >= st.wi) {
            c -= st.wi;
            ++r;
          }
        }
      }
#pragma unroll
      for (int nn = 0; nn < kNtChunk; ++nn) {
        if (nn >= ntl) continue;
        const int ntg = cur.nc * kNtChunk + nn;
        const float2 s2 = reinterpret_cast<const float2*>(sc + 8 * ntg)[t];
        const float2 b2 = reinterpret_cast<const float2*>(bi + 8 * ntg)[t];
        uint32_t* d = dst + 4 * ntg;
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
            // both channels at once in T: the store's rounding, then
            // LeakyReLU, y < 0 ? rn(y * slope) : y (a product of two values
            // of T, rounded once, is the exact product rounded once, as the
            // f32 product rounded to T is); the sign bits select, so -0
            // stays -0 either way
            const T2 y2 = Op::pack(v[0], v[1]);
            const T2 p2 = __hmul2(y2, slope2);
            const uint32_t yb = *reinterpret_cast<const uint32_t*>(&y2);
            const uint32_t pb = *reinterpret_cast<const uint32_t*>(&p2);
            const uint32_t neg = ((yb >> 15) & 0x00010001u) * 0xffffu;
            const uint32_t out2 = inside[m][hr] ? ((pb & neg) | (yb & ~neg)) : 0u;
            if (off[m][hr] >= 0) d[off[m][hr]] = out2;
          }
        }
      }
      // zero the rest of the next stage's last k-chunk
      if (cur.nc == st.nch - 1 && (st.nt & 1)) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (off[m][hr] >= 0) dst[off[m][hr] + 4 * st.nt] = 0u;
      }
    }
    cur = nxt;
    st = nst;
  }
  __syncthreads();

  // the finished tile is in abuf(depth) at pitch tile.tw; write it out
  // coalesced, adding the input's centre (re-read from device memory) if residual
  const uint32_t* fin = abuf(depth);
  const int cout = cw.c[depth];
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  unsigned short* os = reinterpret_cast<unsigned short*>(out);
  if (cout % 2 == 0) {
    // a word (channel pair) per thread, kOutBatch at a time so that the
    // residual's loads from device memory are in flight together
    constexpr int kOutBatch = 12;
    const int pw = cout / 2;
    const long long img = static_cast<long long>(n) * h * wd * cout;
    Walk wk(threadIdx.x, tile.tw, pw);
    while (wk.r < tile.th) {
      long long e[kOutBatch];  // element offset in out (and in x, if residual); -1: outside
      uint32_t v[kOutBatch], xv[kOutBatch];
#pragma unroll
      for (int u = 0; u < kOutBatch; ++u) {
        const int gy = ty0 + wk.r, gx = tx0 + wk.c;
        e[u] = -1;
        if (wk.r < tile.th && gy < h && gx < wd) {
          e[u] = img + (static_cast<long long>(gy) * wd + gx) * cout + 2 * wk.q;
          v[u] = fin[(wk.r * tile.tw + wk.c) * sw + wk.q];
          if (residual) xv[u] = __ldg(reinterpret_cast<const uint32_t*>(xs + e[u]));
        }
        wk.step();
      }
#pragma unroll
      for (int u = 0; u < kOutBatch; ++u) {
        if (e[u] < 0) continue;
        if (residual) {
          // the add in f32 rounded once to T: the correctly rounded sum
          const float2 a = Op::unpack(*reinterpret_cast<const T2*>(&v[u]));
          const float2 b = Op::unpack(*reinterpret_cast<const T2*>(&xv[u]));
          const T2 y2 = Op::pack(a.x + b.x, a.y + b.y);
          v[u] = *reinterpret_cast<const uint32_t*>(&y2);
        }
        *reinterpret_cast<uint32_t*>(os + e[u]) = v[u];
      }
    }
  } else {
    for (int i = threadIdx.x; i < tile.th * tile.tw * cout; i += blockDim.x) {
      const int pix = i / cout, co = i % cout;
      const int gy = ty0 + pix / tile.tw, gx = tx0 + pix % tile.tw;
      if (gy >= h || gx >= wd) continue;
      const long long gp = (static_cast<long long>(n) * h + gy) * wd + gx;
      const uint32_t v = fin[pix * sw + (co >> 1)];
      unsigned short y = static_cast<unsigned short>(co & 1 ? v >> 16 : v & 0xffffu);
      if (residual) y = Op::to_bits(Op::from_bits(y) + Op::from_bits(xs[gp * c0 + co]));
      os[gp * cout + co] = y;
    }
  }
}

// ---- the f32 and bf16 paths on split TF32 -----------------------------

// Stage k of a chain on the split-TF32 path: widths, regions and work split.
struct Stage32 {
  int cin, cout, kc, nt, nch;  // k-chunks of 16, n-tiles of 8, chunks of kNtChunk n-tiles
  int wi, ho, wo;              // input pitch; output rows and columns
  int tiles, passes;           // m-tiles of 16 output indices; passes of kWarps * kMT32 m-tiles
  int woff;                    // this stage's packed weights, in 16-byte units
  int boff;                    // this stage's biases, in floats
};

__host__ __device__ inline Stage32 stage32_of(const Widths& cw, int depth, Tile t, int k) {
  Stage32 s;
  s.woff = 0;
  s.boff = 0;
  for (int j = 0; j < k; ++j) {
    s.woff += 9 * kchunks(cw.c[j]) * ntiles(cw.c[j + 1]) * 64;
    s.boff += 8 * ntiles(cw.c[j + 1]);
  }
  s.cin = cw.c[k];
  s.cout = cw.c[k + 1];
  s.kc = kchunks(s.cin);
  s.nt = ntiles(s.cout);
  s.nch = cdiv(s.nt, kNtChunk);
  s.wi = t.tw + 2 * (depth - k);
  s.wo = s.wi - 2;
  s.ho = t.th + 2 * (depth - k) - 2;
  s.tiles = cdiv(s.ho * s.wi - 2, 16);
  s.passes = cdiv(s.tiles, kWarps * kMT32);
  return s;
}

// Shared memory: [buf0][buf1][2 weight buffers of wsz 16-byte units][every
// stage's biases, bsz floats], the activation buffers f32, `sw` words per
// pixel. A weight buffer holds one tap of one chunk of n-tiles. Reads past
// a region's end stay inside the allocation, as in mma_layout.
__host__ __device__ inline void tf32_layout(const Widths& cw, int depth, Tile t, int* wsz, int* sw,
                                            int* words0, int* words1, int* bsz) {
  int w = 0, cmax = cw.c[0], b = 0;
  for (int k = 0; k < depth; ++k) {
    const int nt = ntiles(cw.c[k + 1]);
    b += 8 * nt;
    const int r = kchunks(cw.c[k]) * (nt < kNtChunk ? nt : kNtChunk) * 64;
    w = r > w ? r : w;
    const int c = kchunks(cw.c[k + 1]) * 16;
    cmax = c > cmax ? c : cmax;
  }
  *wsz = w;
  *bsz = b;
  *sw = pixel_words_f32(cmax);
  const int hi = t.th + 2 * depth, wi = t.tw + 2 * depth;
  *words0 = hi * wi * *sw;
  const int px1 = (hi - 2) * (wi - 2);
  *words1 = (px1 > kOverrun ? px1 : kOverrun) * *sw;
}

__host__ __device__ inline size_t tf32_smem_bytes(const Widths& cw, int depth, Tile t) {
  int wsz, sw, words0, words1, bsz;
  tf32_layout(cw, depth, t, &wsz, &sw, &words0, &words1, &bsz);
  return static_cast<size_t>(2) * wsz * 16 + static_cast<size_t>(words0 + words1 + bsz) * 4;
}

// Where the split-TF32 chain's loop stands: stage, chunk of n-tiles, pass,
// tap. One step of it is one staged block of weights.
struct Cursor32 {
  int k, nc, pass, tap;
};

__device__ inline void advance32(Cursor32& c, Stage32& s, const Widths& cw, int depth, Tile t) {
  if (++c.tap < 9) return;
  c.tap = 0;
  if (++c.pass < s.passes) return;
  c.pass = 0;
  if (++c.nc < s.nch) return;
  c.nc = 0;
  if (++c.k < depth) s = stage32_of(cw, depth, t, c.k);
}

__device__ inline int ntl32(const Stage32& s, int nc) {
  const int left = s.nt - nc * kNtChunk;
  return left < kNtChunk ? left : kNtChunk;
}

__device__ inline void fetch_tap(uint4* dst, const uint4* __restrict__ wq, const Stage32& s,
                                 const Cursor32& c) {
  const int n16 = s.kc * ntl32(s, c.nc) * 64;
  stage_weights_async(dst, wq + s.woff + 9 * s.kc * kNtChunk * 64 * c.nc + n16 * c.tap, n16);
}

// x, out: NHWC of T (float: parity, high and mixed, P = 3; bf16: fasthi,
// P = 2; P = 1 only in the control of tools/chain_check.py). wq: the packed
// weights of ops/kernels/conv_chain.py pack_chain_tf32, per stage [chunk of
// n-tiles][tap][k-chunk][n-tile][hi, lo][lane][4 words]. bias: per stage,
// padded to whole n-tiles (0 in the pad).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_chain_tf32_kernel(const T* __restrict__ x, T* __restrict__ out,
                              const uint4* __restrict__ wq, const float* __restrict__ bias, int h,
                              int wd, int depth, Widths cw, Tile tile, float slope, int residual,
                              int tiles_w) {
  extern __shared__ uint4 smem16[];
  int wsz, sw, words0, words1, bsz;
  tf32_layout(cw, depth, tile, &wsz, &sw, &words0, &words1, &bsz);
  float* const abuf0 = reinterpret_cast<float*>(smem16);
  uint4* const wbuf0 = smem16 + (words0 + words1) / 4;
  auto wbuf = [&](int b) { return wbuf0 + (b & 1) * wsz; };
  auto abuf = [&](int b) { return abuf0 + (b & 1) * words0; };
  float* const sbias = reinterpret_cast<float*>(wbuf0 + 2 * wsz);
  for (int i = threadIdx.x; i < bsz; i += kThreads) sbias[i] = __ldg(bias + i);

  const int n = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_w) * tile.th;
  const int tx0 = (blockIdx.x % tiles_w) * tile.tw;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the slope rounded to T, as ops/nn.py leaky_relu (and JAX) round it
  const float slope_t = Act<T>::rn(slope);
  const int c0 = cw.c[0];

  Cursor32 at{0, 0, 0, 0};
  Stage32 st = stage32_of(cw, depth, tile, 0);
  fetch_tap(wbuf(0), wq, st, at);  // in flight while the window loads
  load_window_f32(x, n, h, wd, c0, ty0 - depth, tx0 - depth, tile.th + 2 * depth, st.wi, sw, st.kc,
                  abuf0);

  float sum[kMT32][kNtChunk][4];  // this warp's running sums of the pass
  int mt0 = 0, cnt = 0;  // this warp's m-tiles in the current pass
  for (int j = 0; at.k < depth; ++j) {
    cp_async_wait_all();
    __syncthreads();  // this tap's weights and the previous stage's output are in place
    Cursor32 nxt = at;
    Stage32 nst = st;
    advance32(nxt, nst, cw, depth, tile);
    if (nxt.k < depth) fetch_tap(wbuf(j + 1), wq, nst, nxt);  // into the buffer the last step read

    const int ntl = ntl32(st, at.nc);
    if (at.tap == 0) {
      // a pass begins with zeroed sums: kMT32 m-tiles a warp while that
      // many are left, and the rest split evenly in the last pass
      const int first = at.pass * kWarps * kMT32;
      const int left = st.tiles - first;
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
    const int ky = at.tap / 3, kx = at.tap - 3 * ky;
    const float* a = abuf(at.k) + (mt0 * 16 + g + ky * st.wi + kx) * sw + 4 * t;
    const uint4* wt = wbuf(j) + lane;
    mma_tap_tf32_any<P, kMT32>(sum, a, sw, st.kc, cnt, ntl, wt);

    if (at.tap == 8) {
      // epilogue on the accumulators: this lane holds, of each m-tile, rows
      // g and g+8 and, of each n-tile, channels 2t and 2t+1
      float* dst = abuf(at.k + 1);
      const bool last = at.k == depth - 1;  // the last stage writes only in-image pixels out
      const int halo = depth - 1 - at.k;    // the region starts `halo` pixels before the tile
      const float* bi = sbias + st.boff;
      int off[kMT32][2];  // word of channel 2t of the pixel in dst; -1: dropped
      bool inside[kMT32][2];
      int r = (mt0 * 16 + g) / st.wi, c = mt0 * 16 + g - r * st.wi;
#pragma unroll
      for (int m = 0; m < kMT32; ++m) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {  // rows g, g+8: output indices 8 apart
          off[m][hr] = (m < cnt && r < st.ho && c < st.wo) ? (r * st.wo + c) * sw + 2 * t : -1;
          const int gy = ty0 - halo + r, gx = tx0 - halo + c;
          inside[m][hr] = last || (gy >= 0 && gy < h && gx >= 0 && gx < wd);
          c += 8;  // the pitch is at least 10, so this wraps once at most
          if (c >= st.wi) {
            c -= st.wi;
            ++r;
          }
        }
      }
#pragma unroll
      for (int nn = 0; nn < kNtChunk; ++nn) {
        if (nn >= ntl) continue;
        const int ntg = at.nc * kNtChunk + nn;
        const float2 b2 = reinterpret_cast<const float2*>(bi + 8 * ntg)[t];
#pragma unroll
        for (int m = 0; m < kMT32; ++m) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            // computed for dropped pixels too: only the store is conditional
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = Act<T>::store_out(sum[m][nn][2 * hr + e] + (e ? b2.y : b2.x));
              if (v < 0.f) v = Act<T>::rn(v * slope_t);
              y[e] = inside[m][hr] ? v : 0.f;
            }
            if (off[m][hr] >= 0)
              *reinterpret_cast<float2*>(dst + off[m][hr] + 8 * ntg) = make_float2(y[0], y[1]);
          }
        }
      }
      // zero the rest of the next stage's last k-chunk
      if (at.nc == st.nch - 1 && (st.nt & 1)) {
#pragma unroll
        for (int m = 0; m < kMT32; ++m)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (off[m][hr] >= 0)
              *reinterpret_cast<float2*>(dst + off[m][hr] + 8 * st.nt) = make_float2(0.f, 0.f);
      }
    }
    at = nxt;
    st = nst;
  }
  __syncthreads();

  // out with the finished tile, f32 in abuf(depth) at pitch tile.tw:
  // coalesced, plus the input's centre (re-read from device memory) if residual
  const float* fin = abuf(depth);
  const int cout = cw.c[depth];
  if (cout % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0) {
    // a channel pair per thread, kOutBatch at a time so that the residual's
    // loads from device memory are in flight together
    constexpr int kOutBatch = 12;
    const long long img = static_cast<long long>(n) * h * wd * cout;
    Walk wk(threadIdx.x, tile.tw, cout / 2);
    while (wk.r < tile.th) {
      long long e[kOutBatch];  // element offset in out (and in x, if residual); -1: outside
      float2 v[kOutBatch], xv[kOutBatch];
#pragma unroll
      for (int u = 0; u < kOutBatch; ++u) {
        const int gy = ty0 + wk.r, gx = tx0 + wk.c;
        e[u] = -1;
        if (wk.r < tile.th && gy < h && gx < wd) {
          e[u] = img + (static_cast<long long>(gy) * wd + gx) * cout + 2 * wk.q;
          v[u] = *reinterpret_cast<const float2*>(fin + (wk.r * tile.tw + wk.c) * sw + 2 * wk.q);
          if (residual) xv[u] = load_pair(x + e[u]);
        }
        wk.step();
      }
#pragma unroll
      for (int u = 0; u < kOutBatch; ++u) {
        if (e[u] < 0) continue;
        if (residual)
          v[u] = make_float2(Act<T>::rn(v[u].x + xv[u].x), Act<T>::rn(v[u].y + xv[u].y));
        store_pair(out + e[u], v[u]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < tile.th * tile.tw * cout; i += blockDim.x) {
      const int pix = i / cout, co = i % cout;
      const int gy = ty0 + pix / tile.tw, gx = tx0 + pix % tile.tw;
      if (gy >= h || gx >= wd) continue;
      const long long gp = (static_cast<long long>(n) * h + gy) * wd + gx;
      float y = fin[pix * sw + co];
      if (residual) y = Act<T>::rn(y + Act<T>::load(x[gp * c0 + co]));
      out[gp * cout + co] = Act<T>::store(y);
    }
  }
}

inline bool valid(int depth, const Widths& cw) {
  if (depth < 1 || depth > kMaxDepth) return false;
  for (int k = 0; k <= depth; ++k)
    if (cw.c[k] < 1) return false;
  return true;
}

// The largest output tile of the m16n8k16 kernel with P products whose
// buffers fit a block's shared memory (the smallest one if none does).
inline Tile pick_tile(const Widths& cw, int depth, int P) {
  const Tile cands[] = {{16, 32}, {16, 16}, {8, 16}, {8, 8}};
  for (const Tile& t : cands)
    if (mma_smem_bytes(cw, depth, t, P) <= kMaxSmem) return t;
  return cands[3];
}

// The same for the split-TF32 kernel.
inline Tile pick_tile32(const Widths& cw, int depth) {
  const Tile cands[] = {{16, 16}, {8, 16}, {8, 8}};
  for (const Tile& t : cands)
    if (tf32_smem_bytes(cw, depth, t) <= kMaxSmem) return t;
  return cands[2];
}

}  // namespace esr

using namespace esr;

// Dynamic shared memory one block needs, in bytes (0 for invalid widths).
// dtype and fast as in conv3x3_chain.
extern "C" long long conv3x3_chain_smem_bytes(int dtype, int fast, int depth, int c0, int c1,
                                              int c2, int c3, int c4) {
  const Widths cw{{c0, c1, c2, c3, c4}};
  if (!valid(depth, cw)) return 0;
  const int P = mma_products(dtype, fast);
  if (P) return static_cast<long long>(mma_smem_bytes(cw, depth, pick_tile(cw, depth, P), P));
  return static_cast<long long>(tf32_smem_bytes(cw, depth, pick_tile32(cw, depth)));
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, c0) and out:
// (n, h, wd, c_depth), NHWC contiguous.
// fast = 0, dtype 1 (fasthi16): w is the f16 hi/lo split in fragment order
// and b the scales and biases, as conv3x3_chain_mma_kernel<__half, 2, false>
// reads them.
// fast = 1, dtype 1 or 2 (fast16, fast): w is the weights rounded to the
// activation type, one term in fragment order, and b scales of 1 and the
// biases rounded to it, as conv3x3_chain_mma_kernel<T, 1, true> reads them:
// one product a fragment, and the epilogue rounds each sum before it adds
// the bias (two roundings).
// fast = 0, dtype 0 and 2 (parity, high, mixed, fasthi): w is the TF32
// hi/lo split in fragment order and b the biases, as
// conv3x3_chain_tf32_kernel reads them.
// Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_chain(int dtype, int fast, const void* x, void* out, const void* w,
                             const void* b, int n, int h, int wd, int depth, int c0, int c1,
                             int c2, int c3, int c4, float slope, int residual, void* stream) {
  const Widths cw{{c0, c1, c2, c3, c4}};
  if (!valid(depth, cw) || n < 1 || n > 65535 || h < 1 || wd < 1 || dtype < 0 || dtype > 2 ||
      (fast && dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(conv3x3_chain_smem_bytes(dtype, fast, depth, c0, c1, c2, c3, c4));
  const float* bf = static_cast<const float*>(b);
  const uint4* wq = static_cast<const uint4*>(w);
  const int P = mma_products(dtype, fast);
  const Tile t = P ? pick_tile(cw, depth, P) : pick_tile32(cw, depth);
  const int tiles_w = cdiv(wd, t.tw);
  const dim3 grid(cdiv(h, t.th) * tiles_w, n);
  const __half* xh = static_cast<const __half*>(x);
  __half* oh = static_cast<__half*>(out);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (fast && dtype == 1)
    return launch(conv3x3_chain_mma_kernel<__half, 1, true>, grid, smem, stream, xh, oh, wq, bf,
                  h, wd, depth, cw, t, slope, residual, tiles_w);
  if (fast)
    return launch(conv3x3_chain_mma_kernel<__nv_bfloat16, 1, true>, grid, smem, stream, xb, ob,
                  wq, bf, h, wd, depth, cw, t, slope, residual, tiles_w);
  if (dtype == 1)
    return launch(conv3x3_chain_mma_kernel<__half, 2, false>, grid, smem, stream, xh, oh, wq, bf,
                  h, wd, depth, cw, t, slope, residual, tiles_w);
  if (dtype == 0)
    return launch(conv3x3_chain_tf32_kernel<float, 3>, grid, smem, stream,
                  static_cast<const float*>(x), static_cast<float*>(out), wq, bf, h, wd, depth, cw,
                  t, slope, residual, tiles_w);
  return launch(conv3x3_chain_tf32_kernel<__nv_bfloat16, 2>, grid, smem, stream, xb, ob, wq, bf,
                h, wd, depth, cw, t, slope, residual, tiles_w);
}

// n-tiles of 8 output channels in one chunk of the packed weights
extern "C" int conv3x3_chain_ntile_chunk() { return kNtChunk; }
