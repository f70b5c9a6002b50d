// PNG row reconstruction: undoes the five filter types of PNG spec 9.2
// (None, Sub, Up, Average, Paeth) in one pass over the decompressed IDAT
// stream. Average and Paeth are sequential along a row (each byte depends on
// the reconstructed byte bpp to its left), which is why core/png.py hands the
// rows to native code.
//
// Filters work on bytes, so one routine covers 8- and 16-bit samples with 1-4
// channels: bpp is the byte count of one complete pixel (1..8).
//
// C ABI:
//   int png_unfilter(const uint8_t* raw, int height, int stride, int bpp,
//                    uint8_t* out);
// raw holds height rows of (1 filter byte + stride bytes); out receives
// height rows of stride bytes. Returns 0, or -(row + 1) for the first row
// whose filter byte is not 0..4.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

}  // namespace

extern "C" int png_unfilter(const uint8_t* raw, int height, int stride, int bpp,
                            uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* line = raw + long(y) * (stride + 1);
    const int ftype = line[0];
    const uint8_t* f = line + 1;
    uint8_t* cur = out + long(y) * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;  // the row above, reconstructed
    switch (ftype) {
      case 0:
        for (int i = 0; i < stride; ++i) cur[i] = f[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i) cur[i] = uint8_t(f[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) cur[i] = uint8_t(f[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          cur[i] = uint8_t(f[i] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          const int diag = (up && i >= bpp) ? up[i - bpp] : 0;
          cur[i] = uint8_t(f[i] + paeth(left, above, diag));
        }
        break;
      default:
        return -(y + 1);
    }
  }
  return 0;
}
