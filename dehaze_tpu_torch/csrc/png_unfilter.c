/* Undo PNG's per-row filters for a whole image (or one Adam7 pass) in one
 * call, on the host. The port's PNG decoder (dehaze_tpu_torch/data/images.py)
 * inflates the image data with Python's zlib and hands the rows here; a
 * ctypes call releases the interpreter lock, so the data pipeline's threads
 * unfilter in parallel.
 *
 * raw: h rows of 1 + stride bytes (the filter type, then the filtered row);
 * out: h rows of stride bytes. bpp: bytes per complete pixel, rounded up to
 * 1 (1..8), the distance of the "left" byte in Sub, Average and Paeth.
 * Filters (PNG spec, section 9): 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth;
 * the row above the first is zero. Returns 0, or 1 + the index of the first
 * row whose filter type is unknown.
 */

#include <stdint.h>
#include <string.h>

static uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride,
                 int bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = cur - stride;
    int ft = raw[y * (stride + 1)];
    if (ft > 4) return (int)(y + 1);
    /* with zeros above, Up is None and Paeth(a, 0, 0) = a is Sub */
    if (y == 0 && (ft == 2 || ft == 4)) ft = ft == 2 ? 0 : 1;
    const int64_t lead = bpp < stride ? bpp : stride;
    int64_t i;
    switch (ft) {
      case 0:
        memcpy(cur, src, (size_t)stride);
        break;
      case 1:
        memcpy(cur, src, (size_t)lead);
        for (i = lead; i < stride; ++i) {
          cur[i] = (uint8_t)(src[i] + cur[i - bpp]);
        }
        break;
      case 2:
        for (i = 0; i < stride; ++i) cur[i] = (uint8_t)(src[i] + up[i]);
        break;
      case 3:
        if (y == 0) {
          memcpy(cur, src, (size_t)lead);
          for (i = lead; i < stride; ++i) {
            cur[i] = (uint8_t)(src[i] + (cur[i - bpp] >> 1));
          }
          break;
        }
        for (i = 0; i < lead; ++i) cur[i] = (uint8_t)(src[i] + (up[i] >> 1));
        for (; i < stride; ++i) {
          cur[i] = (uint8_t)(src[i] + ((cur[i - bpp] + up[i]) >> 1));
        }
        break;
      default: /* 4, Paeth; paeth(0, b, 0) = b on the leading pixel */
        for (i = 0; i < lead; ++i) cur[i] = (uint8_t)(src[i] + up[i]);
        for (; i < stride; ++i) {
          cur[i] = (uint8_t)(src[i] + paeth(cur[i - bpp], up[i],
                                            up[i - bpp]));
        }
        break;
    }
  }
  return 0;
}
