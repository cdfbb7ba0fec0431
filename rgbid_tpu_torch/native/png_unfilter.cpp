// PNG row unfiltering (the five filter types of the PNG specification,
// section 9), for rgbid_tpu_torch/datasets/png.py. Avg and Paeth depend
// on the pixel to the left, so a row is a sequential loop; numpy has no
// form of it that is not a Python loop over pixels. ctypes releases the
// GIL around the call, so a reader thread decodes while the tracker runs.

#include <cstdlib>

namespace {

inline unsigned char paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);
  const int pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return static_cast<unsigned char>(a);
  if (pb <= pc) return static_cast<unsigned char>(b);
  return static_cast<unsigned char>(c);
}

}  // namespace

extern "C" {

// raw: h rows of 1 + stride bytes (the filter byte, then the filtered
// row); out: h rows of stride bytes. bpp: bytes per complete pixel
// (at least 1). Returns 0, or 1 + the index of the first row whose filter
// byte is not 0-4 (out is then filled up to that row).
int png_unfilter(const unsigned char* raw, int h, int stride, int bpp, unsigned char* out) {
  for (int r = 0; r < h; ++r) {
    const unsigned char* src = raw + static_cast<long>(r) * (stride + 1);
    const unsigned char ft = src[0];
    ++src;
    unsigned char* dst = out + static_cast<long>(r) * stride;
    const unsigned char* up = r > 0 ? dst - stride : nullptr;
    switch (ft) {
      case 0:
        for (int i = 0; i < stride; ++i) dst[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < bpp && i < stride; ++i) dst[i] = src[i];
        for (int i = bpp; i < stride; ++i) dst[i] = static_cast<unsigned char>(src[i] + dst[i - bpp]);
        break;
      case 2:
        if (up == nullptr) {
          for (int i = 0; i < stride; ++i) dst[i] = src[i];
        } else {
          for (int i = 0; i < stride; ++i) dst[i] = static_cast<unsigned char>(src[i] + up[i]);
        }
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up != nullptr ? up[i] : 0;
          dst[i] = static_cast<unsigned char>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = up != nullptr ? up[i] : 0;
          const int c = (up != nullptr && i >= bpp) ? up[i - bpp] : 0;
          dst[i] = static_cast<unsigned char>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
