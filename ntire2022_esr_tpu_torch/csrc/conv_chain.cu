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
// (the pitch trick of common.cuh: index r * wi + c, a tap an offset of
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
// conv3x3_chain_wgmma_tf32_kernel<T, P, KC>: the same plan on split TF32
// and TF32 warpgroup MMA, wgmma.mma_async.m64n48k8.f32.tf32.tf32 with A
// from registers and B from shared memory (wgmma_chain.cuh "split TF32",
// shared with the tail's split-TF32 kernel): f32 weights as two TF32 terms
// packed on the host, activations split in registers, P products a k-step
// (3 under f32 activations, 2 under bf16), each tap's products of an
// m-block summed from zero by the MMAs and added to the running sums in
// f32. What the design does about the card's limits:
//  - activations are f32 in shared memory (a pixel of 48 channels is 192
//    bytes, 16 mod 32 words, so that a quarter warp's 16-byte A loads
//    cover the banks once), so the tile is 16x16 at RLFN's widths: windows
//    of 22x22 and 20x20 pixels (92,928 + 76,800 bytes), the last m-block
//    of a stage reading up to 10 and 26 pixels past them (rows it drops);
//  - the weights come a unit at a time (a tap of a step: 18 KB at 48x48
//    channels, hi and lo) through a ring of 3 buffers at RLFN's widths
//    (wgmma_chain.cuh Ring32): one bulk copy a unit to the buffer's
//    mbarrier, the last warp done with a buffer asks for the unit 3 later,
//    across stage boundaries and tiles, with no barrier of the block
//    between units (230,144 of the 232,448 bytes a block may have);
//  - M = output indices in m-blocks of 64 (the pitch trick), N = the 48
//    output channels of a step: three warpgroups (384 threads, 168
//    registers a thread at most), each holding the running sums of two
//    m-blocks (48 registers) beside a tap's fresh sums (24) and a group's
//    A registers; a stage's m-blocks (7, 6 and 5 at RLFN's depth 3) in
//    passes of six, so stage 0's 7th is a pass of its own for one
//    warpgroup, its taps fetched again; a group of KG k-steps is waited
//    for before the next group's A registers are written, so no
//    accumulator is read and no A register written under a pending MMA,
//    and the other warpgroups' MMAs fill the waits;
//  - the epilogue on the running sums: + bias, the store's rounding to T,
//    LeakyReLU with the slope rounded to T, zero outside the image; the
//    last stage adds the residual (read from x) and writes NHWC rows of
//    T, which thread 0 hands to bulk stores; each stage starts after a
//    barrier of the block (it reads the whole region the last one wrote);
//  - a persistent grid of one block an SM walking (image, tile) items;
//    under an odd depth the next tile's window is loaded into the buffer
//    the last stage read while this tile's rows are stored.
// Bound: 60,480 MACs a pixel, against 368 bytes a pixel at f32: bound by
// operations. f32-grade products on f32 activations take 3 TF32 products at
// the card's 495 TFLOP/s of dense TF32: 6.15 ms at batch 128 x 256^2. On
// bf16 activations the cheapest f32-grade form is 3 bf16 products (the
// weight split into three bf16 terms) at 989 TFLOP/s: 3.08 ms. The kernel
// runs 1.54x the MACs at the 16x16 tile (halo, the pitch trick's columns,
// whole m-blocks), its MMAs in groups that wait, and its window loads and
// epilogues beside them (PERF.md, tools/chain_clocks.py --kernel
// chain_tf32).
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

// ---- the f32 and bf16 paths on split TF32, on warpgroup MMA ------------

// m-blocks whose running sums a warpgroup holds at once (two, as the
// tail's: 48 registers beside a unit's 24 and its A registers)
constexpr int kChainBlocks32 = 2;
// the k-chunks of every stage's input that the unrolled instantiation
// takes (RLFN's 46 and 48 channels); other widths loop over k-steps
constexpr int kChainKc32 = 3;

// Stage k of a chain on the split-TF32 path: widths, regions and work.
struct Stage32 {
  int cin, cout, kc, nt, nch, ks;  // k-chunks of 16, n-tiles of 8, steps, k-steps of 8 a tap
  int wi, ho, wo;                  // input pitch; output rows and columns
  int blocks, passes;  // m-blocks of 64 output indices; passes of WGS * kChainBlocks32 of them
  int unit_bytes;      // one unit: the ks k-steps of one tap of one step, hi and lo
  int woff, boff;      // this stage's packed weights, in bytes; its biases, in floats
};

__host__ __device__ inline Stage32 stage32_of(const Widths& cw, int depth, Tile t, int k) {
  Stage32 s;
  s.woff = 0;
  s.boff = 0;
  for (int j = 0; j < k; ++j) {
    const int nt = ntiles(cw.c[j + 1]);
    s.woff += cdiv(nt, kStepNt) * kTaps * 2 * kchunks(cw.c[j]) * 2 * kStepB32;
    s.boff += 8 * nt;
  }
  s.cin = cw.c[k];
  s.cout = cw.c[k + 1];
  s.kc = kchunks(s.cin);
  s.nt = ntiles(s.cout);
  s.nch = cdiv(s.nt, kStepNt);
  s.ks = 2 * s.kc;
  s.wi = t.tw + 2 * (depth - k);
  s.wo = s.wi - 2;
  s.ho = t.th + 2 * (depth - k) - 2;
  // output indices p = r * wi + c; the last one kept is (ho - 1, wo - 1)
  s.blocks = cdiv(s.ho * s.wi - 2, 64);
  s.passes = cdiv(s.blocks, kChainWarpgroups * kChainBlocks32);
  s.unit_bytes = s.ks * 2 * kStepB32;
  return s;
}

// Shared memory of the split-TF32 chain, byte offsets: [the ring's
// mbarriers and counters][the ring: nbuf buffers of the largest unit]
// [buf0][buf1][every stage's biases][the tile's units: where each one's
// weights lie in the pack, and its bytes]. Stage k reads buf(k & 1) and writes
// buf((k + 1) & 1), f32 at sw words a pixel (16 mod 32: a quarter warp's
// 16-byte A loads cover the banks once); the last stage writes its tile as
// NHWC rows of cout values of T (vbytes each). A stage's last m-block reads
// up to 64 blocks + 2 wi + 2 pixels from its buffer's start, past the
// region (rows the epilogue drops): into the next buffer or the biases,
// and `bytes` covers it. nbuf: as many ring buffers as fit, up to kRing32
// (0: no plan at this tile). per_tile: the units a tile reads, (stage,
// step, pass, tap) in that order.
struct Layout32 {
  int sw, nbuf, unit, per_tile;
  int buf0, buf1, bias, units, bytes;
};

__host__ __device__ inline Layout32 layout32(const Widths& cw, int depth, Tile t, int vbytes) {
  Layout32 L;
  int cmax = 0, cap[2] = {0, 0}, reach[2] = {0, 0}, nbias = 0;
  for (int k = 0; k < depth; ++k) cmax = cw.c[k] > cmax ? cw.c[k] : cmax;
  L.sw = pixel_words_f32(cmax);
  L.unit = 0;
  L.per_tile = 0;
  for (int k = 0; k < depth; ++k) {
    const Stage32 s = stage32_of(cw, depth, t, k);
    const int in = (s.ho + 2) * s.wi * L.sw * 4, r = (64 * s.blocks + 2 * s.wi + 2) * L.sw * 4;
    cap[k & 1] = in > cap[k & 1] ? in : cap[k & 1];
    reach[k & 1] = r > reach[k & 1] ? r : reach[k & 1];
    L.unit = s.unit_bytes > L.unit ? s.unit_bytes : L.unit;
    L.per_tile += s.nch * s.passes * kTaps;
    nbias += 8 * s.nt;
  }
  const int fin = t.th * t.tw * cw.c[depth] * vbytes;
  cap[depth & 1] = fin > cap[depth & 1] ? fin : cap[depth & 1];
  L.nbuf = 0;
  for (int nbuf = kRing32; nbuf >= 2 && !L.nbuf; --nbuf) {
    L.buf0 = kRing32Head + nbuf * L.unit;
    L.buf1 = L.buf0 + cdiv(cap[0], 16) * 16;
    L.bias = L.buf1 + cdiv(cap[1], 16) * 16;
    L.units = L.bias + 4 * nbias;
    L.bytes = L.units + 8 * L.per_tile;
    L.bytes = L.buf0 + reach[0] > L.bytes ? L.buf0 + reach[0] : L.bytes;
    L.bytes = L.buf1 + reach[1] > L.bytes ? L.buf1 + reach[1] : L.bytes;
    if (static_cast<size_t>(L.bytes) <= kMaxSmem) L.nbuf = nbuf;
  }
  return L;
}

// x, out: NHWC of T (float: parity, high and mixed, P = 3; bf16: fasthi,
// P = 2; P = 1 only in the control of tools/chain_check.py). wq: the
// packed weights of ops/kernels/conv_chain.py pack_chain_wgmma_tf32, per
// stage [step of kStepNt n-tiles][tap][k-step of 8 input channels][hi,
// lo] and per k-step and term a 48 x 8 B operand, [group of 8 columns]
// [k 0-3, k 4-7][8 columns][4 k], k-step 2c + s of k-chunk c taking input
// channel 16c + 4k + 2s + (k-half) at position k of its k-half; zero past
// the stage's channels. bias: per stage, padded to whole n-tiles (0 in
// the pad). KC: every stage's input has KC k-chunks (the k-steps of a
// unit unrolled), or 0 (any widths). A persistent grid: block b takes
// tiles b, b + gridDim.x, ... of the n * tiles_h * tiles_w (image, output
// tile) items, and its units of weights run on through the ring across
// stages and tiles.
template <typename T, int P, int KC>
__global__ void __launch_bounds__(128 * kChainWarpgroups, 1)
    conv3x3_chain_wgmma_tf32_kernel(const T* __restrict__ x, T* __restrict__ out,
                                    const uint8_t* __restrict__ wq,
                                    const float* __restrict__ bias, int h, int wd, int depth,
                                    Widths cw, Tile tile, float slope, int residual, int tiles_w,
                                    int tiles_h, int tiles) {
  constexpr int WGS = kChainWarpgroups, THREADS = 128 * WGS, MB = kChainBlocks32;
  constexpr int KS = 2 * KC;  // k-steps a unit (0: the stage's)
  // k-steps a group, chosen as the tail's are: 2 under 3
  // products (16 A registers) or at any width; under 2 products a whole
  // tap of 3 k-chunks (24)
  constexpr int KG = KC == 0 || P == 3 ? 2 : KS;
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout32 L = layout32(cw, depth, tile, sizeof(T));
  Ring32 ring(smem, L.nbuf, L.unit);
  float* const buf0 = reinterpret_cast<float*>(smem + L.buf0);
  float* const buf1 = reinterpret_cast<float*>(smem + L.buf1);
  float* const sbias = reinterpret_cast<float*>(smem + L.bias);
  int2* const units = reinterpret_cast<int2*>(smem + L.units);
  // the shuffle tells the compiler that `warp` is the same in all lanes
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int sw = L.sw, c0 = cw.c[0], cout = cw.c[depth];
  // the slope rounded to T, as ops/nn.py leaky_relu (and JAX) round it
  const float slope_t = Act<T>::rn(slope);
  {
    const Stage32 s = stage32_of(cw, depth, tile, depth - 1);
    for (int i = threadIdx.x; i < s.boff + 8 * s.nt; i += THREADS) sbias[i] = __ldg(bias + i);
  }
  // the units a tile reads, in order: tap u % 9 of each pass of each step of
  // each stage; its weights lie at the stage's step and tap
  if (threadIdx.x == 32) {
    int u = 0;
    for (int k = 0; k < depth; ++k) {
      const Stage32 s = stage32_of(cw, depth, tile, k);
      for (int step = 0; step < s.nch; ++step)
        for (int pass = 0; pass < s.passes; ++pass)
          for (int tap = 0; tap < kTaps; ++tap)
            units[u++] = make_int2(s.woff + (step * kTaps + tap) * s.unit_bytes, s.unit_bytes);
    }
  }
  ring.init();

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
    load_window_f32<THREADS>(x, n, h, wd, c0, ty0 - depth, tx0 - depth, tile.th + 2 * depth,
                             tile.tw + 2 * depth, sw, kchunks(c0), buf0);
  };
  // the units of weights this block reads, a tile's after another's
  const int bx = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);
  const int jtotal = (bx < tiles ? (tiles - 1 - bx) / grid + 1 : 0) * L.per_tile;
  auto fetch = [&](int jj) {
    if (jj >= jtotal) return;
    const int2 e = units[jj % L.per_tile];
    ring.load(jj, wq + e.x, static_cast<unsigned>(e.y));
  };
  __syncthreads();  // the biases, units, barriers and counters are in place
  if (threadIdx.x == 0)
    for (int jj = 0; jj < L.nbuf; ++jj) fetch(jj);

  // LeakyReLU of a sum + bias stored in T
  auto act = [&](float v) {
    v = Act<T>::store_out(v);
    return v < 0.f ? Act<T>::rn(v * slope_t) : v;
  };
  // step nc's running sums s of m-block mb of a stage but the last, + bias,
  // rounded to T, LeakyReLU, into the next stage's buffer, zero outside the
  // image (torch's zero padding for the next stage); this lane holds rows g
  // and g+8, channels 2t and 2t+1 of each n-tile
  auto epilogue_mid = [&](const float (&s)[24], const Stage32& st, int mb, int nc, float* nxt,
                          int halo, int ty0, int tx0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr;
      const int r = p / st.wi, c = p - r * st.wi;
      if (r >= st.ho || c >= st.wo) continue;  // past the region, or the pitch trick's columns
      const int gy = ty0 - halo + r, gx = tx0 - halo + c;
      const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < wd;
      float* const px = nxt + (r * st.wo + c) * sw + 2 * t;
#pragma unroll
      for (int jn = 0; jn < kStepNt; ++jn) {
        const int ntg = nc * kStepNt + jn;
        if (ntg >= st.nt) break;  // the zero pad of the last step
        const float2 b2 = *reinterpret_cast<const float2*>(sbias + st.boff + 8 * ntg + 2 * t);
        const float v0 = act(s[4 * jn + 2 * hr] + b2.x), v1 = act(s[4 * jn + 2 * hr + 1] + b2.y);
        *reinterpret_cast<float2*>(px + 8 * ntg) =
            inside ? make_float2(v0, v1) : make_float2(0.f, 0.f);
      }
      // the next stage reads whole k-chunks: zero the n-tile after an odd count
      if (nc == st.nch - 1 && (st.nt & 1))
        *reinterpret_cast<float2*>(px + 8 * st.nt) = make_float2(0.f, 0.f);
    }
  };
  // the same for the last stage, plus the residual (image n's x, added in
  // f32 and rounded once to T: the correctly rounded sum), into the
  // finished tile's NHWC rows of cout values of T, in-image pixels only
  const bool pairs = cout % 2 == 0 && reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  auto epilogue_last = [&](const float (&s)[24], const Stage32& st, int mb, int nc, T* fin, int n,
                           int ty0, int tx0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = 64 * mb + 16 * (warp % 4) + g + 8 * hr;
      const int r = p / st.wi, c = p - r * st.wi;
      if (r >= st.ho || c >= st.wo || ty0 + r >= h || tx0 + c >= wd) continue;
      const T* const xp = x + ((static_cast<long long>(n) * h + ty0 + r) * wd + tx0 + c) * cout;
      T* const px = fin + (r * tile.tw + c) * cout;
      float2 xr[kStepNt];  // loaded together, before they are added
#pragma unroll
      for (int jn = 0; jn < kStepNt; ++jn) {
        const int ch = 8 * (nc * kStepNt + jn) + 2 * t;
        xr[jn] = make_float2(0.f, 0.f);
        if (residual && ch < cout) {
          if (pairs) {
            xr[jn] = load_pair(xp + ch);
          } else {
            xr[jn].x = Act<T>::load(__ldg(xp + ch));
            if (ch + 1 < cout) xr[jn].y = Act<T>::load(__ldg(xp + ch + 1));
          }
        }
      }
#pragma unroll
      for (int jn = 0; jn < kStepNt; ++jn) {
        const int ntg = nc * kStepNt + jn, ch = 8 * ntg + 2 * t;
        if (ch >= cout) break;
        const float2 b2 = *reinterpret_cast<const float2*>(sbias + st.boff + 8 * ntg + 2 * t);
        float v0 = act(s[4 * jn + 2 * hr] + b2.x), v1 = act(s[4 * jn + 2 * hr + 1] + b2.y);
        if (residual) {
          v0 = Act<T>::rn(v0 + xr[jn].x);
          v1 = Act<T>::rn(v1 + xr[jn].y);
        }
        if (cout % 2 == 0) {
          store_pair(px + ch, make_float2(v0, v1));
        } else {
          px[ch] = Act<T>::store(v0);
          if (ch + 1 < cout) px[ch + 1] = Act<T>::store(v1);
        }
      }
    }
  };

  int tl = blockIdx.x;
  if (tl < tiles) window(tl);
  for (; tl < tiles; tl += gridDim.x) {
    int n, ty0, tx0;
    origin(tl, n, ty0, tx0);
    if (threadIdx.x == 0) bulk_wait_read();  // the last tile's stores have read their buffer
    __syncthreads();                         // the window is in place
    const bool more = tl + static_cast<int>(gridDim.x) < tiles;
    for (int k = 0; k < depth; ++k) {
      const Stage32 st = stage32_of(cw, depth, tile, k);
      const float* const in = (k & 1) ? buf1 : buf0;
      float* const nxt = (k & 1) ? buf0 : buf1;
      for (int nc = 0; nc < st.nch; ++nc) {
        for (int pass = 0; pass < st.passes; ++pass) {
          // this warpgroup's m-blocks of the pass, mb0 and mb0 + WGS (the
          // stage's split evenly between its passes: at RLFN's 7 m-blocks
          // 3 and 4, where 6 and 1 would leave two warpgroups idle while
          // one takes the 7th alone), and the warps that read the units (a
          // warpgroup without an m-block does not)
          const int first = pass * st.blocks / st.passes;
          const int here = (pass + 1) * st.blocks / st.passes - first;
          const int nb = wg < here ? (here - wg + WGS - 1) / WGS : 0;
          const int active = 4 * (here < WGS ? here : WGS);
          const int mb0 = first + wg;
          const float* const a0 = in + (64 * mb0 + 16 * (warp % 4) + g) * sw + 4 * t;
          float sum[MB][24];
#pragma unroll
          for (int i = 0; i < MB; ++i)
#pragma unroll
            for (int e = 0; e < 24; ++e) sum[i][e] = 0.f;
          for (int tap = 0; tap < kTaps; ++tap) {
            if (nb > 0) {
              const unsigned b = ring.wait();
              const int ky = tap / 3;
              const float* const a = a0 + (ky * st.wi + tap - 3 * ky) * sw;
              // the tap's products of each m-block summed from zero, then
              // added to the running sums in f32 (the tensor cores truncate
              // as they accumulate); the other warpgroups' MMAs fill the waits
#pragma unroll
              for (int i = 0; i < MB; ++i) {
                if (i >= nb) break;
                float d[24];
                unit_mmas<P, false, KS, KG>(d, a + WGS * 64 * sw * i, sw, nullptr, b, t, st.ks);
#pragma unroll
                for (int e = 0; e < 24; ++e) sum[i][e] += d[e];
              }
              // every MMA of this warp has read the unit
              ring.release(active, fetch);
            }
            ring.advance();
          }
#pragma unroll
          for (int i = 0; i < MB; ++i) {
            if (i >= nb) break;
            if (k == depth - 1)
              epilogue_last(sum[i], st, mb0 + WGS * i, nc, reinterpret_cast<T*>(nxt), n, ty0, tx0);
            else
              epilogue_mid(sum[i], st, mb0 + WGS * i, nc, nxt, depth - 1 - k, ty0, tx0);
          }
          // a warpgroup without an m-block read none of the pass's units
          // and waited for none: it may wait for a later unit of the same
          // buffer only after the others have read these (its parity
          // would otherwise match an earlier phase)
          if (here < WGS) __syncthreads();
        }
      }
      if (k == depth - 1) fence_proxy_async();  // the bulk stores read the finished tile
      __syncthreads();  // the next stage reads this stage's whole region
    }
    // the finished tile, residual added, is in buf(depth & 1): each row one
    // run of device memory, which thread 0 hands to bulk stores where the
    // rows are 16-byte runs, else plain stores; then the next tile's window
    // into buf0, under the bulk stores where they read buf1 (an odd depth)
    const T* const fin = reinterpret_cast<const T*>((depth & 1) ? buf1 : buf0);
    const int nrow = h - ty0 < tile.th ? h - ty0 : tile.th;
    const int ncol = wd - tx0 < tile.tw ? wd - tx0 : tile.tw;
    const long long row0 = (static_cast<long long>(n) * h + ty0) * wd + tx0;
    const int vb = static_cast<int>(sizeof(T)), row_bytes = ncol * cout * vb;
    if (row_bytes % 16 == 0 && (wd * cout * vb) % 16 == 0 && (tx0 * cout * vb) % 16 == 0 &&
        (tile.tw * cout * vb) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
      if (threadIdx.x == 0) {
        for (int r = 0; r < nrow; ++r)  // a row a bulk store
          bulk_store(out + (row0 + static_cast<long long>(r) * wd) * cout,
                     fin + r * tile.tw * cout, static_cast<unsigned>(row_bytes));
        bulk_commit();
      }
    } else {
      for (int i = threadIdx.x; i < nrow * ncol * cout; i += THREADS) {
        const int pix = i / cout, co = i % cout;
        const int r = pix / ncol, c = pix % ncol;
        out[(row0 + static_cast<long long>(r) * wd + c) * cout + co] =
            fin[(r * tile.tw + c) * cout + co];
      }
    }
    if (more) {
      if (!(depth & 1)) {
        if (threadIdx.x == 0) bulk_wait_read();
        __syncthreads();  // the copy-out has read buf0
      }
      window(tl + gridDim.x);  // into buf0
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();  // before the shared memory goes
}

// Launches the split-TF32 kernel with P products: unrolled at kChainKc32
// k-chunks where every stage's input has that many (RLFN's widths), else
// with a loop over k-steps. tools/chain_check.py --one-product patches
// fasthi's call to P = 1.
template <typename T, int P>
int launch_chain_tf32(dim3 grid, size_t smem, void* stream, const void* x, void* out,
                      const void* wq, const float* bias, int h, int wd, int depth,
                      const Widths& cw, Tile t, float slope, int residual, int tiles_w,
                      int tiles_h, int tiles) {
  bool unrolled = true;
  for (int k = 0; k < depth; ++k) unrolled = unrolled && kchunks(cw.c[k]) == kChainKc32;
  const auto go = [&](auto kernel) {
    return launch_threads(kernel, grid, 128 * kChainWarpgroups, smem, stream,
                          static_cast<const T*>(x), static_cast<T*>(out),
                          static_cast<const uint8_t*>(wq), bias, h, wd, depth, cw, t, slope,
                          residual, tiles_w, tiles_h, tiles);
  };
  return unrolled ? go(conv3x3_chain_wgmma_tf32_kernel<T, P, kChainKc32>)
                  : go(conv3x3_chain_wgmma_tf32_kernel<T, P, 0>);
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

// The largest output tile of the split-TF32 kernel on values of vbytes
// whose buffers fit a block beside two ring buffers (the smallest if none
// does: the launch is then refused). At RLFN's widths and depth 3 16x16
// takes 18 m-blocks of MMAs for 256 pixels (7, 6 and 5: the 7th a pass of
// its own), 16x12 15 for 192 (6, 5, 4), 8x16 12 for 128.
inline Tile pick_tile32(const Widths& cw, int depth, int vbytes) {
  const Tile cands[] = {{16, 16}, {8, 16}, {8, 8}, {4, 4}};
  for (const Tile& t : cands)
    if (layout32(cw, depth, t, vbytes).nbuf >= 2) return t;
  return cands[3];
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
  const int vb = dtype == 0 ? 4 : 2;
  return layout32(cw, depth, pick_tile32(cw, depth, vb), vb).bytes;
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
// the bias (two roundings).
// fast = 0, dtype 0 and 2 (parity, high, mixed, fasthi): w is the TF32
// hi/lo split as TF32 wgmma B operands and b the biases, as
// conv3x3_chain_wgmma_tf32_kernel reads them.
// Every grid is persistent: one block for each SM of the current device,
// or for each tile if there are fewer. Returns cudaGetLastError() after the
// launch.
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
  const int P = mma_products(dtype, fast);
  const Tile t = P ? pick_tile(cw, depth, P) : pick_tile32(cw, depth, dtype == 0 ? 4 : 2);
  const int tiles_w = cdiv(wd, t.tw), tiles_h = cdiv(h, t.th);
  const long long items = static_cast<long long>(n) * tiles_h * tiles_w;
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(items);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles < sms ? tiles : sms);
  if (!P) {
    if (dtype == 0)
      return launch_chain_tf32<float, 3>(grid, smem, stream, x, out, w, bf, h, wd, depth, cw, t,
                                         slope, residual, tiles_w, tiles_h, tiles);
    return launch_chain_tf32<__nv_bfloat16, 2>(grid, smem, stream, x, out, w, bf, h, wd, depth, cw,
                                               t, slope, residual, tiles_w, tiles_h, tiles);
  }
  const uint4* wq = static_cast<const uint4*>(w);
  if (fast && dtype == 1)
    return launch_wgmma<__half, 1, true>(grid, smem, stream, static_cast<const __half*>(x),
                                         static_cast<__half*>(out), wq, bf, h, wd, depth, cw, t,
                                         slope, residual, tiles_w, tiles_h, tiles);
  if (fast)
    return launch_wgmma<__nv_bfloat16, 1, true>(
        grid, smem, stream, static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        wq, bf, h, wd, depth, cw, t, slope, residual, tiles_w, tiles_h, tiles);
  return launch_wgmma<__half, 2, false>(grid, smem, stream, static_cast<const __half*>(x),
                                        static_cast<__half*>(out), wq, bf, h, wd, depth, cw, t,
                                        slope, residual, tiles_w, tiles_h, tiles);
}

// n-tiles of 8 output channels in one chunk of the packed weights
extern "C" int conv3x3_chain_ntile_chunk() { return kNtChunk; }
