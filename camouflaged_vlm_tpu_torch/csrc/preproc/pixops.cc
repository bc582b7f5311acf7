// Small pixel kernels shared by the decode/resize pipeline.
//
// Each mirrors the exact numpy/PIL op the pure-Python pipeline uses
// (data/transforms.py, data/loader.py) so the native loader is sample-for-
// sample interchangeable:
//   cvt_rgb2l     — PIL convert("L"): ITU-R 601-2 integer luma, >>16 floor.
//   cvt_rot90ccw  — np.rot90(k=1) on HWC arrays.
//   cvt_fliplr    — PIL Image.FLIP_LEFT_RIGHT.
//   cvt_normalize — the fp32 (x/255 - mean)/std chain in the same op order
//                   (divide, subtract, divide) so float rounding matches.

#include "cvtpre.h"

#include <cstring>

extern "C" {

void cvt_rgb2l(const uint8_t *src, int64_t npix, uint8_t *dst) {
  // Pillow L24(rgb) = r*19595 + g*38470 + b*7471 + 0x8000, output >> 16.
  for (int64_t i = 0; i < npix; i++) {
    const uint32_t r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
    dst[i] = static_cast<uint8_t>(
        (r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
  }
}

void cvt_rot90ccw(const uint8_t *src, int w, int h, int ch, uint8_t *dst) {
  // out[(w-1-x), y, :] = in[y, x, :]; dst is (w x h x ch).
  for (int y = 0; y < h; y++) {
    const uint8_t *line = src + static_cast<size_t>(y) * w * ch;
    for (int x = 0; x < w; x++) {
      uint8_t *o = dst + (static_cast<size_t>(w - 1 - x) * h + y) * ch;
      const uint8_t *p = line + static_cast<size_t>(x) * ch;
      for (int c = 0; c < ch; c++) o[c] = p[c];
    }
  }
}

void cvt_fliplr(uint8_t *buf, int w, int h, int ch) {
  for (int y = 0; y < h; y++) {
    uint8_t *line = buf + static_cast<size_t>(y) * w * ch;
    for (int x = 0; x < w / 2; x++) {
      uint8_t *a = line + static_cast<size_t>(x) * ch;
      uint8_t *b = line + static_cast<size_t>(w - 1 - x) * ch;
      for (int c = 0; c < ch; c++) {
        const uint8_t t = a[c];
        a[c] = b[c];
        b[c] = t;
      }
    }
  }
}

void cvt_normalize(const uint8_t *src, int64_t npix, int ch, const float *mean,
                   const float *stdv, float *dst) {
  // Same fp32 op order as transforms._to_float_array + (arr - mean) / std:
  // u8 -> f32, /255.0f, -mean[c], /std[c].  One pass, no temporaries.
  for (int64_t i = 0; i < npix; i++) {
    for (int c = 0; c < ch; c++) {
      const float v = static_cast<float>(src[i * ch + c]) / 255.0f;
      dst[i * ch + c] = (v - mean[c]) / stdv[c];
    }
  }
}

} // extern "C"
