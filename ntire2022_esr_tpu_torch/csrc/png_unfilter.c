/* Reverse the row filters of an 8-bit PNG image, on the host.
 *
 * PNG's Avg and Paeth filters predict a byte from the reconstructed byte
 * to its left, so a row cannot be undone as one vector operation; in
 * Python they took a wavefront over anti-diagonals, 85-210x slower than
 * the None/Sub/Up rows. Here every row is undone in order, as the PNG
 * specification (section 9) states the five filters. The left and
 * upper-left bytes of each channel stay in registers, and the Paeth choice
 * is made without branches (it follows the image, so a branch would be
 * mispredicted about as often as taken). A Paeth row of RGB or RGBA
 * pixels takes SSE2 where the compiler targets it, a pixel's channels in
 * one vector.
 *
 * Built at first use with the host C compiler and loaded with ctypes by
 * ntire2022_esr_tpu_torch/utils/image.py (through ops/kernels/build.py);
 * its plain version is image.py's _unfilter_wavefront. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  const int bc = pb <= pc ? b : c;
  return ((pa <= pb) & (pa <= pc)) ? a : bc;
}

/* One row of n bytes, n a multiple of bpp; up is the reconstructed row
 * above (zeros for the first row). bpp is a constant where it is inlined. */
static inline void unfilter_row(int f, const uint8_t* in, uint8_t* cur, const uint8_t* up,
                                long long n, const int bpp) {
  int a[4] = {0, 0, 0, 0}, c[4] = {0, 0, 0, 0};
  switch (f) {
    case 0:
      memcpy(cur, in, (size_t)n);
      break;
    case 1:
      for (long long i = 0; i < n; i += bpp)
        for (int k = 0; k < bpp; ++k) a[k] = cur[i + k] = (uint8_t)(in[i + k] + a[k]);
      break;
    case 2:
      for (long long i = 0; i < n; ++i) cur[i] = (uint8_t)(in[i] + up[i]);
      break;
    case 3:
      for (long long i = 0; i < n; i += bpp)
        for (int k = 0; k < bpp; ++k)
          a[k] = cur[i + k] = (uint8_t)(in[i + k] + ((a[k] + up[i + k]) >> 1));
      break;
    case 4:
      for (long long i = 0; i < n; i += bpp)
        for (int k = 0; k < bpp; ++k) {
          const int b = up[i + k];
          a[k] = cur[i + k] = (uint8_t)(in[i + k] + paeth(a[k], b, c[k]));
          c[k] = b;
        }
      break;
  }
}

#if defined(__SSE2__)
#include <emmintrin.h>

/* bpp must reach the byte moves as a constant, or each memcpy becomes a call */
#define INLINE static inline __attribute__((always_inline))

/* A Paeth row of 3- or 4-byte pixels with a pixel's channels side by
 * side in 16-bit lanes (libpng's SSE2 formulation): the channel chains
 * run in one set of instructions. Pixels move as 32-bit words; where a
 * word would pass the end of the row (the last pixel of a 3-byte row),
 * the pixel's 3 bytes move alone. */
INLINE __m128i widen(uint32_t v) {
  return _mm_unpacklo_epi8(_mm_cvtsi32_si128((int)v), _mm_setzero_si128());
}

INLINE __m128i abs16(__m128i x) {
  const __m128i neg = _mm_cmplt_epi16(x, _mm_setzero_si128());
  return _mm_add_epi16(_mm_xor_si128(x, neg), _mm_srli_epi16(neg, 15));
}

INLINE __m128i pick(__m128i m, __m128i t, __m128i e) {
  return _mm_or_si128(_mm_and_si128(m, t), _mm_andnot_si128(m, e));
}

/* in + pred(a, b, c), bytewise mod 256, in 16-bit lanes */
INLINE __m128i paeth_px(__m128i in, __m128i a, __m128i b, __m128i c) {
  __m128i pa = _mm_sub_epi16(b, c), pb = _mm_sub_epi16(a, c);
  const __m128i pc = abs16(_mm_add_epi16(pa, pb));
  pa = abs16(pa);
  pb = abs16(pb);
  const __m128i least = _mm_min_epi16(pc, _mm_min_epi16(pa, pb));
  const __m128i pred = pick(_mm_cmpeq_epi16(least, pa), a, pick(_mm_cmpeq_epi16(least, pb), b, c));
  return _mm_and_si128(_mm_add_epi8(in, pred), _mm_set1_epi16(0xff));
}

INLINE void paeth_row_simd(const uint8_t* in, uint8_t* cur, const uint8_t* up,
                                  long long n, const int bpp) {
  __m128i a = _mm_setzero_si128(), c = _mm_setzero_si128();
  long long i = 0;
  for (; i + 4 <= n; i += bpp) {
    uint32_t vi, vb, vo;
    memcpy(&vi, in + i, 4);
    memcpy(&vb, up + i, 4);
    const __m128i b = widen(vb);
    a = paeth_px(widen(vi), a, b, c);
    c = b;
    vo = (uint32_t)_mm_cvtsi128_si32(_mm_packus_epi16(a, a));
    memcpy(cur + i, &vo, 4);  /* a 3-byte pixel's 4th byte is rewritten next */
  }
  if (i < n) {  /* the last pixel of a 3-byte row */
    uint32_t vi = 0, vb = 0, vo;
    memcpy(&vi, in + i, 3);
    memcpy(&vb, up + i, 3);
    a = paeth_px(widen(vi), a, widen(vb), c);
    vo = (uint32_t)_mm_cvtsi128_si32(_mm_packus_epi16(a, a));
    memcpy(cur + i, &vo, 3);
  }
}

/* Two Paeth rows at once, 3- or 4-byte pixels: the low four lanes undo row
 * 0's pixel j, the high four row 1's pixel j - 1, which needs nothing of
 * row 0 beyond pixel j - 1. Both chains advance in one set of
 * instructions, so a pair of rows costs about what one row does. up is
 * row 0's upper row; n the row's bytes. */
INLINE uint32_t ld(const uint8_t* p, const int bpp) {
  uint32_t v = 0;
  memcpy(&v, p, (size_t)bpp);
  return v;
}

INLINE __m128i widen2(uint32_t lo, uint32_t hi) {
  return _mm_unpacklo_epi8(_mm_set_epi32(0, 0, (int)hi, (int)lo), _mm_setzero_si128());
}

/* one step: row 0's pixel at byte i (if lo0), row 1's at byte i - bpp (if hi1) */
INLINE __m128i paeth2_step(const uint8_t* in0, const uint8_t* in1, uint8_t* r0,
                                  uint8_t* r1, const uint8_t* up, long long i, __m128i prev,
                                  __m128i prev2, uint32_t up_left, uint32_t up_i, int lo0,
                                  int hi1, const int bpp) {
  const __m128i x = widen2(lo0 ? ld(in0 + i, bpp) : 0, hi1 ? ld(in1 + i - bpp, bpp) : 0);
  const __m128i b = _mm_unpacklo_epi64(widen2(up_i, 0), prev);
  const __m128i c = _mm_unpacklo_epi64(widen2(up_left, 0), prev2);
  const __m128i d = paeth_px(x, prev, b, c);
  const __m128i packed = _mm_packus_epi16(d, d);
  const uint32_t lo = (uint32_t)_mm_cvtsi128_si32(packed);
  const uint32_t hi = (uint32_t)_mm_cvtsi128_si32(_mm_srli_si128(packed, 4));
  if (lo0) memcpy(r0 + i, &lo, (size_t)bpp);
  if (hi1) memcpy(r1 + i - bpp, &hi, (size_t)bpp);
  (void)up;
  return d;
}

INLINE void paeth_rows2_simd(const uint8_t* in0, const uint8_t* in1, uint8_t* r0,
                                    uint8_t* r1, const uint8_t* up, long long n, const int bpp) {
  __m128i prev = paeth2_step(in0, in1, r0, r1, up, 0, _mm_setzero_si128(), _mm_setzero_si128(),
                             0, ld(up, bpp), 1, 0, bpp);
  __m128i prev2 = _mm_setzero_si128();
  /* both rows, not row 0's last pixel: every move is a 32-bit word, whose
   * fourth byte (of a 3-byte pixel) lies in the row or in the next row's
   * filter byte, and is rewritten by the next step where it is stored */
  long long i = bpp;
  for (; i + bpp < n; i += bpp) {
    const __m128i x = widen2(ld(in0 + i, 4), ld(in1 + i - bpp, 4));
    const __m128i b = _mm_unpacklo_epi64(widen2(ld(up + i, 4), 0), prev);
    const __m128i c = _mm_unpacklo_epi64(widen2(ld(up + i - bpp, 4), 0), prev2);
    const __m128i d = paeth_px(x, prev, b, c);
    const __m128i packed = _mm_packus_epi16(d, d);
    const uint32_t lo = (uint32_t)_mm_cvtsi128_si32(packed);
    const uint32_t hi = (uint32_t)_mm_cvtsi128_si32(_mm_srli_si128(packed, 4));
    memcpy(r0 + i, &lo, 4);
    memcpy(r1 + i - bpp, &hi, 4);
    prev2 = prev;
    prev = d;
  }
  if (i < n) {
    const __m128i d = paeth2_step(in0, in1, r0, r1, up, i, prev, prev2, ld(up + i - bpp, bpp),
                                  ld(up + i, bpp), 1, 1, bpp);
    prev2 = prev;
    prev = d;
  }
  paeth2_step(in0, in1, r0, r1, up, n, prev, prev2, ld(up + n - bpp, bpp), 0, 0, 1, bpp);
}
#endif

/* ftypes: h filter-type bytes. rows: h filtered rows of rowbytes bytes,
 * row r at rows + r * row_stride. out: h * rowbytes bytes, written. bpp:
 * bytes a pixel (1 to 4: gray, RGB, RGBA), which divides rowbytes.
 * Returns 0; r + 1 for the first row r whose filter type is above 4 (out
 * is then partly written); -1 for a bpp out of range or no memory. */
int png_unfilter(const uint8_t* ftypes, const uint8_t* rows, long long row_stride, uint8_t* out,
                 long long h, long long rowbytes, int bpp) {
  if (bpp < 1 || bpp > 4 || rowbytes % bpp) return -1;
  uint8_t* zeros = (uint8_t*)calloc((size_t)rowbytes + 1, 1);
  if (!zeros) return -1;
  int rc = 0;
  for (long long r = 0; r < h && !rc; ++r) {
    const uint8_t* in = rows + r * row_stride;
    uint8_t* cur = out + r * rowbytes;
    const uint8_t* up = r > 0 ? cur - rowbytes : zeros;
    const int f = ftypes[r];
#if defined(__SSE2__)
    if (f == 4 && bpp >= 3 && r + 1 < h && ftypes[r + 1] == 4) {
      const uint8_t* in1 = in + row_stride;
      if (bpp == 3) paeth_rows2_simd(in, in1, cur, cur + rowbytes, up, rowbytes, 3);
      else paeth_rows2_simd(in, in1, cur, cur + rowbytes, up, rowbytes, 4);
      ++r;
      continue;
    }
    if (f == 4 && bpp >= 3) {
      if (bpp == 3) paeth_row_simd(in, cur, up, rowbytes, 3);
      else paeth_row_simd(in, cur, up, rowbytes, 4);
      continue;
    }
#endif
    if (f > 4) {
      rc = (int)(r + 1);
    } else if (bpp == 3) {
      unfilter_row(f, in, cur, up, rowbytes, 3);
    } else if (bpp == 4) {
      unfilter_row(f, in, cur, up, rowbytes, 4);
    } else if (bpp == 1) {
      unfilter_row(f, in, cur, up, rowbytes, 1);
    } else {
      unfilter_row(f, in, cur, up, rowbytes, 2);
    }
  }
  free(zeros);
  return rc;
}
