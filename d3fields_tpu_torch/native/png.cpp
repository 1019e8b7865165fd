// PNG row unfiltering (PNG specification, section 9: filter types 0-4).
//
// Built with g++ on first use by d3fields_tpu_torch/native_build.py and
// called through ctypes from d3fields_tpu_torch/utils/png.py. Sub, Average
// and Paeth are recurrences along the row, which numpy cannot vectorise;
// this loop runs them at memory speed.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// filtered: height rows of (1 + stride) bytes, each a filter-type byte and
// the row's filtered bytes. out: height rows of stride bytes. bpp: bytes
// per complete pixel (at least 1). Returns -1 on success, else the index of
// the first row whose filter type is not 0-4.
int64_t png_unfilter(const uint8_t* filtered, int64_t height, int64_t stride, int64_t bpp,
                     uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = filtered + y * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? row - stride : nullptr;
    switch (type) {
      case 0:
        for (int64_t x = 0; x < stride; ++x) row[x] = src[x];
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (x >= bpp ? row[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          row[x] = static_cast<uint8_t>(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          row[x] = static_cast<uint8_t>(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = up ? up[x] : 0;
          const int c = (up && x >= bpp) ? up[x - bpp] : 0;
          row[x] = static_cast<uint8_t>(src[x] + paeth(a, b, c));
        }
        break;
      default:
        return y;
    }
  }
  return -1;
}

}  // extern "C"
