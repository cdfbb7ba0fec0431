// The host's frame packing in one pass, for rgbid_tpu_torch/tracking/step.py
// (pack_frame, gray_from_rgb): the BT.601 luma in 15-bit fixed point,
// (9798 R + 19235 G + 3735 B + 16384) >> 15 (OpenCV's cvtColor(RGB2GRAY)
// for u8), and, for the "u16" codec, the depth's low and high bytes in the
// same row loop. numpy needs a uint32 copy of the image and six passes over
// it; here each pixel is read once. Single-threaded: the caller's host
// thread does it, and ctypes releases the GIL around the call.
//
// Every array is given by the address of its element (0, 0[, 0]) and its
// strides in bytes, as numpy holds it, so views (a row-reversed or
// sub-sampled frame, a 4-channel frame, a broadcast) are read in place.

#include <cstddef>
#include <cstring>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

namespace {

typedef unsigned char u8;

inline u8 luma(unsigned r, unsigned g, unsigned b) {
  return static_cast<u8>((9798u * r + 19235u * g + 3735u * b + 16384u) >> 15);
}

void luma_row(const u8* __restrict p, std::ptrdiff_t ps, std::ptrdiff_t cs, int w,
              u8* __restrict o) {
  for (int x = 0; x < w; ++x, p += ps) o[x] = luma(p[0], p[cs], p[2 * cs]);
}

#ifdef __SSE2__
// The luma of 4 packed RGB pixels (bytes 0-11 of x) in the 4 dword lanes,
// exactly: each pixel's bytes are moved to its own lane (R, G, B, 0), then
// two pmaddwd form 9798 R + 3735 B and 19235 G + 16384 * 1 on 16-bit pairs.
inline __m128i luma4(__m128i x) {
  const __m128i lane = _mm_setr_epi32(0x00FFFFFF, 0, 0, 0);
  const __m128i rgbx = _mm_or_si128(
      _mm_or_si128(_mm_and_si128(x, lane), _mm_and_si128(_mm_slli_si128(x, 1),
                                                         _mm_slli_si128(lane, 4))),
      _mm_or_si128(_mm_and_si128(_mm_slli_si128(x, 2), _mm_slli_si128(lane, 8)),
                   _mm_and_si128(_mm_slli_si128(x, 3), _mm_slli_si128(lane, 12))));
  const __m128i rb = _mm_and_si128(rgbx, _mm_set1_epi32(0x00FF00FF));
  const __m128i g1 = _mm_or_si128(_mm_srli_epi16(rgbx, 8), _mm_set1_epi32(0x10000));
  const __m128i s = _mm_add_epi32(_mm_madd_epi16(rb, _mm_set1_epi32((3735 << 16) | 9798)),
                                  _mm_madd_epi16(g1, _mm_set1_epi32((16384 << 16) | 19235)));
  return _mm_srli_epi32(s, 15);
}

// Packed RGB, 16 pixels a step (four 16-byte loads 12 bytes apart, read
// only inside the row), the rest one by one.
void luma_row_rgb(const u8* __restrict p, int w, u8* __restrict o) {
  int x = 0;
  for (; 3 * x + 52 <= 3 * w; x += 16) {
    const u8* q = p + 3 * x;
    const __m128i a = luma4(_mm_loadu_si128(reinterpret_cast<const __m128i*>(q)));
    const __m128i b = luma4(_mm_loadu_si128(reinterpret_cast<const __m128i*>(q + 12)));
    const __m128i c = luma4(_mm_loadu_si128(reinterpret_cast<const __m128i*>(q + 24)));
    const __m128i d = luma4(_mm_loadu_si128(reinterpret_cast<const __m128i*>(q + 36)));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(o + x),
                     _mm_packus_epi16(_mm_packs_epi32(a, b), _mm_packs_epi32(c, d)));
  }
  for (; x < w; ++x) o[x] = luma(p[3 * x], p[3 * x + 1], p[3 * x + 2]);
}
#else
void luma_row_rgb(const u8* __restrict p, int w, u8* __restrict o) { luma_row(p, 3, 1, w, o); }
#endif

// One row of the source into one row of gray: channels 1 copies a gray
// source, 3 takes the luma of channels 0, 1, 2.
void gray_row(const u8* __restrict p, std::ptrdiff_t ps, std::ptrdiff_t cs, int channels, int w,
              u8* __restrict o) {
  if (channels == 1) {
    if (ps == 1) {
      std::memcpy(o, p, static_cast<std::size_t>(w));
    } else {
      for (int x = 0; x < w; ++x) o[x] = p[x * ps];
    }
  } else if (ps == 3 && cs == 1) {
    luma_row_rgb(p, w, o);
  } else {
    luma_row(p, ps, cs, w, o);
  }
}

}  // namespace

extern "C" {

// src: the (h, w) gray or (h, w, >= 3) colour frame, strides rs, ps, cs;
// out: h rows of w bytes, rows out_rs bytes apart.
void pack_gray(const u8* src, std::ptrdiff_t rs, std::ptrdiff_t ps, std::ptrdiff_t cs,
               int channels, int h, int w, u8* out, std::ptrdiff_t out_rs) {
  for (int y = 0; y < h; ++y) gray_row(src + y * rs, ps, cs, channels, w, out + y * out_rs);
}

// The "u16" codec's (3, h, w) buffer, contiguous: [gray, depth lo, depth hi].
// depth: 2-byte items, strides drs, dps; its bytes are taken in memory order
// (numpy's view(uint8)).
void pack_u16(const u8* src, std::ptrdiff_t rs, std::ptrdiff_t ps, std::ptrdiff_t cs,
              int channels, const u8* depth, std::ptrdiff_t drs, std::ptrdiff_t dps, int h,
              int w, u8* out) {
  const std::ptrdiff_t plane = static_cast<std::ptrdiff_t>(h) * w;
  for (int y = 0; y < h; ++y) {
    u8* g = out + static_cast<std::ptrdiff_t>(y) * w;
    gray_row(src + y * rs, ps, cs, channels, w, g);
    u8* __restrict lo = g + plane;
    u8* __restrict hi = lo + plane;
    const u8* __restrict d = depth + y * drs;
    if (dps == 2) {
      for (int x = 0; x < w; ++x) {
        lo[x] = d[2 * x];
        hi[x] = d[2 * x + 1];
      }
    } else {
      for (int x = 0; x < w; ++x) {
        lo[x] = d[x * dps];
        hi[x] = d[x * dps + 1];
      }
    }
  }
}

}  // extern "C"
