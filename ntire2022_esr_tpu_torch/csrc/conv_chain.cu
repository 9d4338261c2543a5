// conv3x3_chain: `depth` same-padded 3x3 convolutions, each + bias,
// rounded to the activation type as ops/nn.py store_out does, then
// LeakyReLU(slope); then + x when `residual`. The RLFB body of RLFN.
//
// Replaces ntire2022_esr_tpu/ops/pallas/conv_chain.py fused_conv3x3_chain.
// A block computes one (image, output tile) at a time. The tile plus a
// halo of `depth` pixels is loaded once; the stages run in shared memory
// as ping-pong buffers, each stage's region two pixels smaller than the
// one before, and only the last stage's tile goes back to device memory.
// After every stage but the last, positions outside the image are zeroed,
// so the next stage sees torch's zero padding. Unlike the Pallas kernel,
// each stage's output is rounded to the storage type (f16 saturating under
// fasthi16): the unfused graph's per-conv rounding, which the shipped
// tier's accuracy was measured on.
//
// Two kernels share that plan.
//
// 2-byte activations (fasthi16, fast16, fast),
// conv3x3_chain_wgmma_kernel<T, P, R2>: each stage is an implicit
// GEMM on Hopper's warpgroup MMA, wgmma.mma_async.m64nNk16 with f32
// accumulation, both operands read from shared memory through matrix
// descriptors (wgmma_chain.cuh). M = output indices in m-blocks of 64
// (the pitch trick of mma_stage.cuh: index r * wi + c, a tap an offset of
// ky * wi + kx pixels, the two columns past each row dropped), K = 9 taps
// x input channels in k-chunks of 16, N = the 48 output channels of one
// step (kNtChunk n-tiles of 8). Under fasthi16 (P = 2) the f32 weights are
// split into two f16 terms and both sit side by side in N (N = 96: hi,
// then lo), so one A operand feeds both sums (f32-grade); under fast16
// and fast (P = 1) the weights
// are 2-byte themselves, packed once rounded to T, one exact product a
// MAC, and the epilogue rounds each sum to T before it adds the bias (R2:
// two roundings, as ops/nn.py conv2d computes a 2-byte contraction's
// output). The products are summed in f32 over a whole stage.
// What the design does about the card's limits:
//  - activations in shared memory as planes of 8 channels, 16 bytes a
//    pixel: a core matrix of the A operand (8 output indices x 8 channels)
//    is 128 contiguous bytes at any pixel, so a descriptor addresses an
//    m-block at any tap offset (LBO: the next plane, SBO: 8 pixels); no
//    ldmatrix, so no pad words (96 bytes a pixel at 48 channels), which
//    leaves room for a whole step's weights;
//  - a step (one chunk of 6 n-tiles of a stage, zero-padded: one step a
//    stage at RLFN's widths, redundant MMAs at narrower ones) keeps
//    all 9 taps of its weights in shared memory (83 KB at RLFN's widths
//    under P = 2), fetched by one bulk copy a tap (cp.async.bulk), each
//    reported to its tap's mbarrier: the first m-block's MMAs of a tap
//    start as its weights land, and the last of the warps that have
//    m-blocks in the step to be done with its MMAs asks for the next
//    step's, under the epilogues;
//  - three warpgroups a block (384 threads): each takes every third
//    m-block, issues its 9 kc MMAs as one group and waits for them before
//    its epilogue (an epilogue that reads one accumulator set while another
//    set's MMAs are pending makes ptxas serialize every MMA), so one
//    warpgroup's epilogue runs while the others' MMAs keep the tensor
//    cores busy; three measured faster than two and four, and than
//    admitting one or two warpgroups' MMAs at a time (ROADMAP Decisions
//    (PR 18));
//  - a persistent grid of one block an SM, which walks over (image, tile)
//    items: under an odd depth the next tile's window is copied (4-byte
//    cp.async with zero fill outside the image) into the buffer the last
//    stage read, while this tile is written out, and the next tile's first
//    weights come under the last epilogues;
//  - the last stage adds the residual (prefetched before its m-block's
//    MMAs) in its epilogue and writes NHWC rows, which thread 0 hands to
//    bulk stores (cp.async.bulk) where the rows are 16-byte runs;
//  - shared memory at RLFN's 16x32 tile and P = 2: windows of 22x38 and
//    20x36 pixels at 96 bytes (80,256 + 69,120) and the step's weights
//    (82,944), 232,400 of the 232,448 bytes a block may have.
// Bound on an H100 (see PERF.md): at RLFN's 46->48->48->46 widths the chain
// does 9*(46*48+48*48+48*46) = 59,616 MACs per pixel and moves 184 bytes
// per pixel, so it is bound by operations: 1.03 ms at batch 128 x 256^2 on
// 2-byte tensor cores (989 TFLOP/s, one product per MAC), 2.05 ms under
// P = 2. The kernel does P products per MAC, a 20% halo at the 16x32 tile,
// 5-9% of dropped columns and 4% of whole m-blocks; a single warpgroup's
// chain of accumulating MMAs at N = 96 runs at about half the tensor
// cores' rate, and the three warpgroups' epilogues overlap the MMAs only
// in part (PERF.md, tools/chain_clocks.py).
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
#include "wgmma_chain.cuh"

namespace esr {

constexpr int kMaxDepth = 4;

struct Widths {
  int c[kMaxDepth + 1];  // c[0] input channels, c[k+1] output channels of stage k
};

// ---- the 2-byte path on warpgroup MMA ---------------------------------

constexpr int kBarBytes = 80;  // the taps' mbarriers and the step counter, at the base

// Warpgroups of a block: each takes every kChainWarpgroups-th m-block of a
// stage, and while one stores its m-block the others' MMAs run (three
// measured faster than two and four under both products, ROADMAP
// Decisions (PR 18)).
constexpr int kChainWarpgroups = 3;

// one step of the chain (kStepNt n-tiles) is one chunk of the packed weights
static_assert(kStepNt == kNtChunk, "the wgmma step and the packs' chunk of n-tiles differ");

// Stage k of a chain on the wgmma path: widths, regions and work.
struct WgStage {
  int cin, cout, kc, nt, nch;  // k-chunks of 16, n-tiles of 8, steps (chunks of kStepNt)
  int wi, ho, wo;              // input pitch; output rows and columns
  int blocks;                  // m-blocks of 64 output indices
  int ps, nps;                 // pixels of the input region and of the output region
  int woff;                    // this stage's packed weights, in 16-byte units
  int sboff;                   // this stage's scales and biases, in floats
};

__host__ __device__ inline WgStage wg_stage(const Widths& cw, int depth, Tile t, int k, int P) {
  WgStage s;
  s.woff = 0;
  s.sboff = 0;
  for (int j = 0; j < k; ++j) {
    s.woff += kTaps * kchunks(cw.c[j]) * 16 * P * kStepNt * cdiv(ntiles(cw.c[j + 1]), kStepNt);
    s.sboff += 2 * 8 * ntiles(cw.c[j + 1]);
  }
  s.cin = cw.c[k];
  s.cout = cw.c[k + 1];
  s.kc = kchunks(s.cin);
  s.nt = ntiles(s.cout);
  s.nch = cdiv(s.nt, kStepNt);
  s.wi = t.tw + 2 * (depth - k);
  s.wo = s.wi - 2;
  s.ho = t.th + 2 * (depth - k) - 2;
  // output indices p = r * wi + c; the last one kept is (ho - 1, wo - 1)
  s.blocks = cdiv(s.ho * s.wi - 2, 64);
  s.ps = (s.ho + 2) * s.wi;
  s.nps = s.ho * s.wo;
  return s;
}

// Shared memory, byte offsets: [mbarriers][buf0][buf1][weights of one step]
// (then slack up to `bytes`). Stage k reads buf(k & 1) and writes
// buf((k + 1) & 1): 2 kc planes of 8 channels, a plane `ps` pixels of 16
// bytes; the last stage writes its tile as NHWC rows of cout values. A
// step's weights are one chunk of n-tiles of one stage, all 9 taps. A
// stage's last m-block reads up to 63 + 2 wi + 2 pixels past its region's
// last plane: into the next buffer or the weights, and `bytes` covers it.
struct WgLayout {
  int buf0, buf1, wbuf, bytes;
};

__host__ __device__ inline WgLayout wg_layout(const Widths& cw, int depth, Tile t, int P) {
  int cap[2] = {0, 0}, w = 0, reach[2] = {0, 0};
  for (int k = 0; k < depth; ++k) {
    const WgStage s = wg_stage(cw, depth, t, k, P);
    const int planes = 2 * s.kc * s.ps * 16;
    cap[k & 1] = planes > cap[k & 1] ? planes : cap[k & 1];
    const int r = ((2 * s.kc - 1) * s.ps + 64 * s.blocks + 2 * s.wi + 2) * 16;
    reach[k & 1] = r > reach[k & 1] ? r : reach[k & 1];
    const int ws = kTaps * s.kc * 16 * P * kStepNt * 16;
    w = ws > w ? ws : w;
  }
  const int fin = t.th * t.tw * cw.c[depth] * 2;
  cap[depth & 1] = fin > cap[depth & 1] ? fin : cap[depth & 1];
  WgLayout L;
  L.buf0 = kBarBytes;
  L.buf1 = L.buf0 + cdiv(cap[0], 16) * 16;
  L.wbuf = L.buf1 + cdiv(cap[1], 16) * 16;
  L.bytes = L.wbuf + w;
  const int r0 = L.buf0 + reach[0], r1 = L.buf1 + reach[1];
  L.bytes = r0 > L.bytes ? r0 : L.bytes;
  L.bytes = r1 > L.bytes ? r1 : L.bytes;
  return L;
}

// One step (stage st, chunk nc of kStepNt n-tiles) of one block: this
// warpgroup's m-blocks wg, wg + WGS, ..., each all 9 taps x kc k-chunks of
// wgmma.m64nNk16 (N = 8 kStepNt P) on the stage's input planes and the
// step's weights, then its epilogue. A warp with m-blocks in the step calls
// `release()` once, when its MMAs of the step are done (the weights may
// then be replaced); a warp of a warpgroup without one (a stage of fewer
// than WGS m-blocks) neither reads the weights nor calls it.
template <typename T, int P, bool R2, int WGS, typename Release>
__device__ inline void wg_step(const WgStage& st, int nc, const uint8_t* in, uint8_t* nxt,
                               const uint8_t* wbuf, uint64_t* bars, unsigned phase,
                               const float* __restrict__ sb, bool last, int halo, int ty0,
                               int tx0, int h, int wd, int tw, typename Op2<T>::T2 slope2,
                               const unsigned short* __restrict__ xres, Release& release) {
  using Op = Op2<T>;
  using T2 = typename Op::T2;
  constexpr int NTL = kStepNt, N = 8 * NTL * P, ND = N / 2;
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int nb = (st.blocks - wg + WGS - 1) / WGS;  // this warpgroup's m-blocks
  // this lane's channels 2t, 2t+1 of each n-tile of the step: 1/S (P = 2)
  // and bias (1 and 0 in an n-tile of the last chunk's pad)
  float2 sc[NTL], bi[NTL];
#pragma unroll
  for (int jn = 0; jn < NTL; ++jn) {
    const int ntg = nc * NTL + jn, ch = 8 * ntg + 2 * t;
    const bool real = ntg < st.nt;
    sc[jn] = make_float2(1.f, 1.f);
    bi[jn] = make_float2(0.f, 0.f);
    if (P == 2 && real) sc[jn] = __ldg(reinterpret_cast<const float2*>(sb + st.sboff + ch));
    if (real) bi[jn] = __ldg(reinterpret_cast<const float2*>(sb + st.sboff + 8 * st.nt + ch));
  }
  const bool resid = last && xres != nullptr;
  const unsigned a0 = smem_addr(in), b0 = smem_addr(wbuf);
  const unsigned lbo_a = static_cast<unsigned>(st.ps) * 16;

  // one tap's kc MMAs of m-block mb into d
  auto tap_mmas = [&](float (&d)[ND], int mb, int tap) {
    const int ky = tap / 3, kx = tap - 3 * ky;
    const unsigned a = a0 + static_cast<unsigned>(64 * mb + ky * st.wi + kx) * 16;
    for (int c = 0; c < st.kc; ++c) {
      const uint64_t da = wgmma_desc(a + 2 * c * lbo_a, lbo_a, 128);
      const uint64_t db = wgmma_desc(b0 + (tap * st.kc + c) * N * 32, 128, 256);
      Wgmma<T>::ss(d, da, db, (tap | c) != 0);
    }
  };
  // m-block mb's 9 kc MMAs into d, one group, waited for; the first m-block
  // of the step waits for each tap's weights
  auto mmas_first = [&](float (&d)[ND], int mb) {
    fence_acc(d);
    wgmma_fence();
    for (int tap = 0; tap < kTaps; ++tap) {
      mbar_wait(bars + tap, phase);
      tap_mmas(d, mb, tap);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
  };
  auto mmas = [&](float (&d)[ND], int mb) {
    fence_acc(d);
    wgmma_fence();
    for (int tap = 0; tap < kTaps; ++tap) tap_mmas(d, mb, tap);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
  };

  // the residual's channel pairs at this lane's two pixels of m-block mb
  // (the last stage's input x; image n's), loaded before the m-block's
  // MMAs so that they are in flight under them
  uint32_t xr[2][NTL];
  auto load_residual = [&](int mb) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr;
      const int r = p / st.wi, c = p - r * st.wi;
      const bool ok = r < st.ho && c < st.wo && ty0 + r < h && tx0 + c < wd;
      const unsigned short* px =
          xres + (static_cast<long long>(ok ? ty0 + r : 0) * wd + (ok ? tx0 + c : 0)) * st.cout;
#pragma unroll
      for (int jn = 0; jn < NTL; ++jn) {
        const int ch = 8 * (nc * NTL + jn) + 2 * t;
        uint32_t v = 0;
        if (ok && ch < st.cout) {
          if (st.cout % 2 == 0) {
            v = __ldg(reinterpret_cast<const uint32_t*>(px + ch));
          } else {
            v = __ldg(px + ch);
            if (ch + 1 < st.cout) v |= static_cast<uint32_t>(__ldg(px + ch + 1)) << 16;
          }
        }
        xr[hr][jn] = v;
      }
    }
  };

  // the stored pair of output channels 8 ntg + 2t, +1 at accumulators i,
  // i + 1 of d: the epilogue's value (epilogue_value), the store's rounding
  // to T of both at once, then LeakyReLU: y < 0 ? rn(y * slope) : y, which
  // for 0 <= slope <= 1 (and any slope < 0) is max(y, rn(y * slope)) and
  // for slope > 1 min(y, rn(y * slope)) (a product of two values of T,
  // rounded once, is the exact product rounded once, as the f32 product
  // rounded to T is; -0 stays -0)
  const bool slope_up = Op::unpack(slope2).x > 1.f;
  auto value2 = [&](const float (&d)[ND], int i, int jn) {
    const float v0 = epilogue_value<T, P, R2>(d[i], lo_of<P>(d, i), sc[jn].x, bi[jn].x);
    const float v1 =
        epilogue_value<T, P, R2>(d[i + 1], lo_of<P>(d, i + 1), sc[jn].y, bi[jn].y);
    const T2 y2 = Op::pack(v0, v1);
    const T2 p2 = __hmul2(y2, slope2);
    const T2 l2 = slope_up ? __hmin2(y2, p2) : __hmax2(y2, p2);
    return *reinterpret_cast<const uint32_t*>(&l2);
  };

  // m-block mb from d to the next stage's planes, zero outside the image
  auto epilogue_mid = [&](const float (&d)[ND], int mb) {
    const int pstride = st.nps * 16;  // bytes from one plane to the next
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows g and g+8 of this warp's 16
      const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr;
      const int r = p / st.wi, c = p - r * st.wi;
      // past the region, and the pitch trick's columns, are dropped
      const bool keep = r < st.ho && c < st.wo;
      const int gy = ty0 - halo + r, gx = tx0 - halo + c;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      uint8_t* const plane = nxt + (r * st.wo + c) * 16 + 4 * t + nc * NTL * pstride;
#pragma unroll
      for (int jn = 0; jn < NTL; ++jn) {
        const uint32_t out2 = inside ? value2(d, 4 * jn + 2 * hr, jn) : 0u;
        if (keep && nc * NTL + jn < st.nt)
          *reinterpret_cast<uint32_t*>(plane + jn * pstride) = out2;
      }
      // the next stage reads whole k-chunks: zero the plane after an odd
      // number of n-tiles
      if (keep && nc == st.nch - 1 && (st.nt & 1))
        *reinterpret_cast<uint32_t*>(plane + (st.nt - nc * NTL) * pstride) = 0u;
    }
  };

  // the last stage's m-block mb from d, plus the residual (added in f32 and
  // rounded once to T: the correctly rounded sum), to the finished tile's
  // NHWC rows of cout values
  auto epilogue_last = [&](const float (&d)[ND], int mb) {
    const bool odd = st.cout & 1;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr;
      const int r = p / st.wi, c = p - r * st.wi;
      const bool keep = r < st.ho && c < st.wo;
      unsigned short* const fin =
          reinterpret_cast<unsigned short*>(nxt) + (r * tw + c) * st.cout + 2 * t;
#pragma unroll
      for (int jn = 0; jn < NTL; ++jn) {
        const int ntg = nc * NTL + jn, ch = 8 * ntg + 2 * t;
        uint32_t out2 = value2(d, 4 * jn + 2 * hr, jn);
        if (resid) {
          const float2 a = Op::unpack(*reinterpret_cast<const T2*>(&out2));
          const float2 b = Op::unpack(*reinterpret_cast<const T2*>(&xr[hr][jn]));
          const T2 s2 = Op::pack(a.x + b.x, a.y + b.y);
          out2 = *reinterpret_cast<const uint32_t*>(&s2);
        }
        if (keep && !odd && ch < st.cout) *reinterpret_cast<uint32_t*>(fin + 8 * ntg) = out2;
        if (keep && odd && ch < st.cout) fin[8 * ntg] = static_cast<unsigned short>(out2 & 0xffffu);
        if (keep && odd && ch + 1 < st.cout)
          fin[8 * ntg + 1] = static_cast<unsigned short>(out2 >> 16);
      }
    }
  };
  auto epilogue = [&](const float (&d)[ND], int mb) {
    if (last)
      epilogue_last(d, mb);
    else
      epilogue_mid(d, mb);
  };

  // each m-block's MMAs are waited for before its epilogue reads them (an
  // epilogue that reads one set while another set's MMAs are pending makes
  // ptxas serialize every MMA); the other warpgroups' MMAs fill the time
  float d[ND];
  if (nb > 0) {
    if (resid) load_residual(wg);
    mmas_first(d, wg);
    if (nb == 1) release();
    epilogue(d, wg);
  }
  for (int i = 1; i < nb; ++i) {
    const int mb = wg + WGS * i;
    if (resid) load_residual(mb);
    mmas(d, mb);
    if (i == nb - 1) release();
    epilogue(d, mb);
  }
}

// Thread 0: the weights of step (stage k, chunk nc) into the step buffer,
// one bulk copy a tap, each reported to its tap's mbarrier.
template <int P>
__device__ inline void fetch_step(uint8_t* wbuf, uint64_t* bars, const uint4* __restrict__ wq,
                                  const Widths& cw, int depth, Tile tile, int k, int nc) {
  const WgStage s = wg_stage(cw, depth, tile, k, P);
  const unsigned tap_bytes = static_cast<unsigned>(s.kc * 8 * kStepNt * P * 32);
  const uint8_t* src =
      reinterpret_cast<const uint8_t*>(wq + s.woff + kTaps * s.kc * 16 * P * kStepNt * nc);
  for (int tap = 0; tap < kTaps; ++tap) {
    mbar_expect(bars + tap, tap_bytes);
    bulk_load(wbuf + tap * tap_bytes, src + tap * tap_bytes, tap_bytes, bars + tap);
  }
}

// x, out: NHWC of T (__half: fasthi16, P = 2, and fast16, P = 1 with R2;
// __nv_bfloat16: fast, P = 1 with R2). wq: the packed weights of
// ops/kernels/conv_chain.py, per stage [chunk of kStepNt n-tiles][tap]
// [k-chunk] and per k-step an N x 16 operand of wgmma, [group of 8 columns][k 0-7,
// k 8-15][8 columns][8 k] (core matrices of 128 bytes: LBO 128, SBO 256),
// the columns the chunk's output channels (zero past the stage's), under
// P = 2 those of the hi terms and then those of the lo terms:
// pack_chain_f16 (P = 2) or pack_chain_2byte (P = 1). sb: per stage [1/S
// per channel][bias per channel], both padded to whole n-tiles (1 and 0 in
// the pad); S = 1 under P = 1, and not read. R2: the two roundings
// (epilogue_value). A persistent grid: block b takes tiles b, b +
// gridDim.x, ... of the n * tiles_h * tiles_w (image, output tile) items.
template <typename T, int P, bool R2>
__global__ void __launch_bounds__(128 * kChainWarpgroups, 1)
    conv3x3_chain_wgmma_kernel(const T* __restrict__ x, T* __restrict__ out,
                               const uint4* __restrict__ wq, const float* __restrict__ sb, int h,
                               int wd, int depth, Widths cw, Tile tile, float slope, int residual,
                               int tiles_w, int tiles_h, int tiles) {
  using Op = Op2<T>;
  using T2 = typename Op::T2;
  constexpr int WGS = kChainWarpgroups, THREADS = 128 * WGS;
  extern __shared__ __align__(128) uint8_t smem[];
  const WgLayout L = wg_layout(cw, depth, tile, P);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  int* const done = reinterpret_cast<int*>(smem + kTaps * 8);  // warps done with a step's MMAs
  uint8_t* const buf0 = smem + L.buf0;
  uint8_t* const buf1 = smem + L.buf1;
  uint8_t* const wbuf = smem + L.wbuf;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTaps; ++i) mbar_init(bars + i, 1);
    *done = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  // the slope rounded to T, as ops/nn.py leaky_relu (and JAX) round it
  const T2 slope2 = Op::splat(slope);
  const int c0 = cw.c[0], cout = cw.c[depth];
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const int per_image = tiles_h * tiles_w;
  auto origin = [&](int tl, int& n, int& ty0, int& tx0) {
    n = tl / per_image;
    const int rest = tl - n * per_image;
    ty0 = (rest / tiles_w) * tile.th;
    tx0 = (rest % tiles_w) * tile.tw;
  };
  auto window = [&](int tl) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    const int hi0 = tile.th + 2 * depth, wi0 = tile.tw + 2 * depth;
    load_window_planes<THREADS>(x, n, h, wd, c0, ty0 - depth, tx0 - depth, hi0, wi0, hi0 * wi0,
                                kchunks(c0), buf0);
  };

  int tl = blockIdx.x;
  if (threadIdx.x == 0) fetch_step<P>(wbuf, bars, wq, cw, depth, tile, 0, 0);
  window(tl);
  unsigned step = 0;  // steps of this block so far: step j waits for parity j & 1
  for (; tl < tiles; tl += gridDim.x) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    const long long img = static_cast<long long>(n) * h * wd * c0;  // image n in x
    cp_async_wait();
    fence_proxy_async();
    if (threadIdx.x == 0) bulk_wait_read();  // the last tile's stores have read their buffer
    __syncthreads();  // the window is in place
    const bool more = tl + static_cast<int>(gridDim.x) < tiles;
    for (int k = 0; k < depth; ++k) {
      const WgStage st = wg_stage(cw, depth, tile, k, P);
      // the warps that have m-blocks in a step of this stage
      const int active = 4 * (st.blocks < WGS ? st.blocks : WGS);
      for (int nc = 0; nc < st.nch; ++nc, ++step) {
        // the step after this one: the next chunk, the next stage, or the
        // next tile's first
        int nk = k, nnc = nc + 1;
        if (nnc == st.nch) {
          nnc = 0;
          nk = k + 1 < depth ? k + 1 : 0;
        }
        const bool fetch = nk != 0 || nnc != 0 || more;
        // the last of the active warps to be done with its MMAs of this
        // step asks for the next step's weights: the others' MMAs have
        // read the buffer (a warp without m-blocks never counts, so no
        // warp can count for a later step before they have)
        auto release = [&]() {
          __syncwarp();
          if (lane == 0) {
            __threadfence_block();
            if (atomicAdd(done, 1) == active - 1) {
              atomicExch(done, 0);
              if (fetch) fetch_step<P>(wbuf, bars, wq, cw, depth, tile, nk, nnc);
            }
          }
          __syncwarp();
        };
        wg_step<T, P, R2, WGS>(st, nc, (k & 1) ? buf1 : buf0, (k & 1) ? buf0 : buf1, wbuf, bars,
                               step & 1, sb, k == depth - 1, depth - 1 - k, ty0, tx0, h, wd,
                               tile.tw, slope2, residual ? xs + img : nullptr, release);
      }
      fence_proxy_async();  // the next stage's MMAs read this stage's stores
      __syncthreads();
    }
    // the finished tile, residual added, is in buf(depth & 1); under an
    // odd depth the last stage read buf0, which now takes the next tile's
    // window while this one is written out
    if (more && (depth & 1)) window(tl + gridDim.x);
    const unsigned short* fin = reinterpret_cast<const unsigned short*>((depth & 1) ? buf1 : buf0);
    unsigned short* os = reinterpret_cast<unsigned short*>(out);
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const int ncol = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const long long row0 = (static_cast<long long>(n) * h + ty0) * wd + tx0;
    const int row_bytes = ncol * cout * 2;
    if (row_bytes % 16 == 0 && (wd * cout * 2) % 16 == 0 && (tx0 * cout * 2) % 16 == 0 &&
        (tile.tw * cout * 2) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      // each row of the tile is one run of device memory: thread 0 hands
      // them to bulk stores, waited for before the buffer is written again
      if (threadIdx.x == 0) {
        for (int r = 0; r < nrow; ++r)
          bulk_store(os + (row0 + static_cast<long long>(r) * wd) * cout,
                     fin + r * tile.tw * cout, static_cast<unsigned>(row_bytes));
        bulk_commit();
      }
    } else {
      for (int i = threadIdx.x; i < nrow * ncol * cout; i += THREADS) {
        const int pix = i / cout, co = i % cout;
        const int r = pix / ncol, c = pix % ncol;
        os[(row0 + static_cast<long long>(r) * wd + c) * cout + co] =
            fin[(r * tile.tw + c) * cout + co];
      }
    }
    if (more && !(depth & 1)) {
      if (threadIdx.x == 0) bulk_wait_read();
      __syncthreads();  // the copy-out has read buf0
      window(tl + gridDim.x);
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes
}

// Launches the wgmma kernel of <T, P, R2>.
template <typename T, int P, bool R2>
int launch_wgmma(dim3 grid, size_t smem, void* stream, const T* x, T* out, const uint4* wq,
                 const float* sb, int h, int wd, int depth, const Widths& cw, Tile t,
                 float slope, int residual, int tiles_w, int tiles_h, int tiles) {
  return launch_threads(conv3x3_chain_wgmma_kernel<T, P, R2>, grid, 128 * kChainWarpgroups, smem,
                        stream, x, out, wq, sb, h, wd, depth, cw, t, slope, residual, tiles_w,
                        tiles_h, tiles);
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

// The largest output tile of the wgmma kernel with P products whose
// buffers fit a block's shared memory (the smallest one if none does).
inline Tile pick_tile(const Widths& cw, int depth, int P) {
  const Tile cands[] = {{16, 32}, {16, 16}, {8, 16}, {8, 8}};
  for (const Tile& t : cands)
    if (static_cast<size_t>(wg_layout(cw, depth, t, P).bytes) <= kMaxSmem) return t;
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
  if (P) return wg_layout(cw, depth, pick_tile(cw, depth, P), P).bytes;
  return static_cast<long long>(tf32_smem_bytes(cw, depth, pick_tile32(cw, depth)));
}

// dtype: 0 float, 1 half, 2 bfloat16. x: (n, h, wd, c0) and out:
// (n, h, wd, c_depth), NHWC contiguous.
// fast = 0, dtype 1 (fasthi16): w is the f16 hi/lo split as wgmma operands
// and b the scales and biases, as conv3x3_chain_wgmma_kernel<__half, 2,
// false> reads them.
// fast = 1, dtype 1 or 2 (fast16, fast): w is the weights rounded to the
// activation type, one term as wgmma operands, and b scales of 1 and the
// biases rounded to it, as conv3x3_chain_wgmma_kernel<T, 1, true> reads
// them: one product a MAC, and the epilogue rounds each sum before it adds
// the bias (two roundings). Their grid is persistent: one block for each
// SM of the current device, or for each tile if there are fewer.
// fast = 0, dtype 0 and 2 (parity, high, mixed, fasthi): w is the TF32
// hi/lo split in fragment order and b the biases, as
// conv3x3_chain_tf32_kernel reads them.
// Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_chain(int dtype, int fast, const void* x, void* out, const void* w,
                             const void* b, int n, int h, int wd, int depth, int c0, int c1,
                             int c2, int c3, int c4, float slope, int residual,
                             void* stream) {
  const Widths cw{{c0, c1, c2, c3, c4}};
  if (!valid(depth, cw) || n < 1 || n > 65535 || h < 1 || wd < 1 || dtype < 0 || dtype > 2 ||
      (fast && dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(conv3x3_chain_smem_bytes(dtype, fast, depth, c0, c1, c2, c3, c4));
  const float* bf = static_cast<const float*>(b);
  const uint4* wq = static_cast<const uint4*>(w);
  const int P = mma_products(dtype, fast);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (P) {
    const Tile t = pick_tile(cw, depth, P);
    const int tiles_w = cdiv(wd, t.tw), tiles_h = cdiv(h, t.th);
    const int tiles = n * tiles_h * tiles_w;
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(tiles < sms ? tiles : sms);
    if (fast && dtype == 1)
      return launch_wgmma<__half, 1, true>(grid, smem, stream, static_cast<const __half*>(x),
                                           static_cast<__half*>(out), wq, bf, h, wd, depth, cw, t,
                                           slope, residual, tiles_w, tiles_h, tiles);
    if (fast)
      return launch_wgmma<__nv_bfloat16, 1, true>(grid, smem, stream, xb, ob, wq, bf, h, wd, depth,
                                                  cw, t, slope, residual, tiles_w, tiles_h, tiles);
    return launch_wgmma<__half, 2, false>(grid, smem, stream, static_cast<const __half*>(x),
                                          static_cast<__half*>(out), wq, bf, h, wd, depth, cw, t,
                                          slope, residual, tiles_w, tiles_h, tiles);
  }
  const Tile t = pick_tile32(cw, depth);
  const int tiles_w = cdiv(wd, t.tw);
  const dim3 grid(cdiv(h, t.th) * tiles_w, n);
  if (dtype == 0)
    return launch(conv3x3_chain_tf32_kernel<float, 3>, grid, smem, stream,
                  static_cast<const float*>(x), static_cast<float*>(out), wq, bf, h, wd, depth, cw,
                  t, slope, residual, tiles_w);
  return launch(conv3x3_chain_tf32_kernel<__nv_bfloat16, 2>, grid, smem, stream, xb, ob, wq, bf,
                h, wd, depth, cw, t, slope, residual, tiles_w);
}

// n-tiles of 8 output channels in one chunk of the packed weights
extern "C" int conv3x3_chain_ntile_chunk() { return kNtChunk; }
