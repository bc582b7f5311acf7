// PIL-bit-exact 8-bit separable resampling.
//
// Reimplements the algorithm of Pillow's src/libImaging/Resample.c for the
// 8-bits-per-channel path (the only path data/transforms.py uses): per-axis
// convolution with double-precision coefficient precomputation, fixed-point
// (PRECISION_BITS = 22) integer accumulation, round-half-away coefficient
// quantisation, and clip8 output rounding.  Horizontal pass first, then
// vertical, exactly like ImagingResample — so outputs match PIL.Image.resize
// byte-for-byte (asserted by tests/test_torch_native_preproc.py over a grid of
// sizes, aspect ratios and filters).
//
// NEAREST is PIL's affine center-floor sampling:
//   src_x = floor((dst_x + 0.5) * sw / dw)   (Geometry.c nearest transform).

#include "cvtpre.h"

#include <cmath>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2; // Pillow PRECISION_BITS

inline uint8_t clip8(int64_t in) {
  if (in >= (1LL << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

double filter_bilinear(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double filter_bicubic(double x) {
  // Keys cubic, a = -0.5 (Pillow's bicubic_filter).
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct FilterSpec {
  double (*fn)(double);
  double support;
};

// Precompute per-output-pixel bounds + fixed-point coefficients, mirroring
// Pillow's precompute_coeffs + normalize_coeffs_8bpc. Returns ksize.
int precompute_coeffs(int in_size, int out_size, const FilterSpec &f,
                      int **bounds_out, int32_t **kk_out) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = f.support * filterscale;
  const int ksize = static_cast<int>(ceil(support)) * 2 + 1;

  double *prekk =
      static_cast<double *>(malloc(sizeof(double) * out_size * ksize));
  int *bounds = static_cast<int *>(malloc(sizeof(int) * out_size * 2));
  int32_t *kk =
      static_cast<int32_t *>(malloc(sizeof(int32_t) * out_size * ksize));
  if (!prekk || !bounds || !kk) {
    free(prekk);
    free(bounds);
    free(kk);
    return -1;
  }

  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; xx++) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double *k = prekk + static_cast<size_t>(xx) * ksize;
    double wsum = 0.0;
    for (int x = 0; x < xmax; x++) {
      const double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      wsum += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (wsum != 0.0) k[x] /= wsum;
    }
    for (int x = xmax; x < ksize; x++) k[x] = 0.0;
    bounds[xx * 2 + 0] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }

  // Round-half-away-from-zero fixed-point quantisation (normalize_coeffs_8bpc).
  for (int i = 0; i < out_size * ksize; i++) {
    const double v = prekk[i] * (1 << kPrecisionBits);
    kk[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
  }
  free(prekk);
  *bounds_out = bounds;
  *kk_out = kk;
  return ksize;
}

// Horizontal convolution: (h x sw x ch) -> (h x dw x ch).
void resample_horiz(const uint8_t *src, int sw, int h, int ch, uint8_t *dst,
                    int dw, int ksize, const int *bounds, const int32_t *kk) {
  const int64_t init = 1LL << (kPrecisionBits - 1);
  for (int yy = 0; yy < h; yy++) {
    const uint8_t *line = src + static_cast<size_t>(yy) * sw * ch;
    uint8_t *out = dst + static_cast<size_t>(yy) * dw * ch;
    for (int xx = 0; xx < dw; xx++) {
      const int xmin = bounds[xx * 2 + 0];
      const int xmax = bounds[xx * 2 + 1];
      const int32_t *k = kk + static_cast<size_t>(xx) * ksize;
      for (int c = 0; c < ch; c++) {
        int64_t ss = init;
        const uint8_t *p = line + (static_cast<size_t>(xmin)) * ch + c;
        for (int x = 0; x < xmax; x++) {
          ss += static_cast<int64_t>(p[static_cast<size_t>(x) * ch]) * k[x];
        }
        out[static_cast<size_t>(xx) * ch + c] = clip8(ss);
      }
    }
  }
}

// Vertical convolution: (sh x w x ch) -> (dh x w x ch).
void resample_vert(const uint8_t *src, int w, int sh, int ch, uint8_t *dst,
                   int dh, int ksize, const int *bounds, const int32_t *kk) {
  (void)sh;
  const int64_t init = 1LL << (kPrecisionBits - 1);
  const size_t stride = static_cast<size_t>(w) * ch;
  for (int yy = 0; yy < dh; yy++) {
    const int ymin = bounds[yy * 2 + 0];
    const int ymax = bounds[yy * 2 + 1];
    const int32_t *k = kk + static_cast<size_t>(yy) * ksize;
    uint8_t *out = dst + static_cast<size_t>(yy) * stride;
    for (size_t i = 0; i < stride; i++) {
      int64_t ss = init;
      const uint8_t *p = src + static_cast<size_t>(ymin) * stride + i;
      for (int y = 0; y < ymax; y++) {
        ss += static_cast<int64_t>(p[static_cast<size_t>(y) * stride]) * k[y];
      }
      out[i] = clip8(ss);
    }
  }
}

int resize_nearest(const uint8_t *src, int sw, int sh, int ch, uint8_t *dst,
                   int dw, int dh) {
  // PIL routes NEAREST resize through ImagingScaleAffine, which walks the
  // source coordinate by REPEATED double addition (xo = 0.5*scale; xo +=
  // scale per pixel) and truncates — so at exact integer boundaries the
  // accumulated value sits one ulp low and PIL picks the LEFT pixel (e.g.
  // 640->336 at dst 52: exact center 100.0, PIL takes 99).  Mirror the
  // accumulation exactly; a closed-form floor((x+0.5)*scale) differs on
  // those boundary pixels.
  int *xs = static_cast<int *>(malloc(sizeof(int) * dw));
  if (!xs) return CVT_ERR_ALLOC;
  const double xscale = static_cast<double>(sw) / dw;
  const double yscale = static_cast<double>(sh) / dh;
  double xo = xscale * 0.5;
  for (int x = 0; x < dw; x++, xo += xscale) {
    int v = static_cast<int>(xo);
    xs[x] = v >= sw ? sw - 1 : v;
  }
  double yo = yscale * 0.5;
  for (int y = 0; y < dh; y++, yo += yscale) {
    int sy = static_cast<int>(yo);
    if (sy >= sh) sy = sh - 1;
    const uint8_t *line = src + static_cast<size_t>(sy) * sw * ch;
    uint8_t *out = dst + static_cast<size_t>(y) * dw * ch;
    if (ch == 1) {
      for (int x = 0; x < dw; x++) out[x] = line[xs[x]];
    } else {
      for (int x = 0; x < dw; x++) {
        memcpy(out + static_cast<size_t>(x) * ch,
               line + static_cast<size_t>(xs[x]) * ch, ch);
      }
    }
  }
  free(xs);
  return CVT_OK;
}

} // namespace

extern "C" int cvt_resize(const uint8_t *src, int sw, int sh, int ch,
                          uint8_t *dst, int dw, int dh, int filter) {
  if (!src || !dst || sw <= 0 || sh <= 0 || dw <= 0 || dh <= 0 ||
      (ch != 1 && ch != 3)) {
    return CVT_ERR_ARG;
  }
  if (filter == CVT_NEAREST) {
    return resize_nearest(src, sw, sh, ch, dst, dw, dh);
  }
  FilterSpec spec;
  switch (filter) {
    case CVT_BILINEAR:
      spec = {filter_bilinear, 1.0};
      break;
    case CVT_BICUBIC:
      spec = {filter_bicubic, 2.0};
      break;
    default:
      return CVT_ERR_ARG;
  }

  const bool need_h = dw != sw;
  const bool need_v = dh != sh;

  const uint8_t *cur = src;
  uint8_t *tmp = nullptr;
  if (need_h) {
    int *bounds;
    int32_t *kk;
    const int ksize = precompute_coeffs(sw, dw, spec, &bounds, &kk);
    if (ksize < 0) return CVT_ERR_ALLOC;
    uint8_t *target =
        need_v ? (tmp = static_cast<uint8_t *>(
                      malloc(static_cast<size_t>(dw) * sh * ch)))
               : dst;
    if (!target) {
      free(bounds);
      free(kk);
      return CVT_ERR_ALLOC;
    }
    resample_horiz(cur, sw, sh, ch, target, dw, ksize, bounds, kk);
    free(bounds);
    free(kk);
    cur = target;
  }
  if (need_v) {
    int *bounds;
    int32_t *kk;
    const int ksize = precompute_coeffs(sh, dh, spec, &bounds, &kk);
    if (ksize < 0) {
      free(tmp);
      return CVT_ERR_ALLOC;
    }
    resample_vert(cur, dw, sh, ch, dst, dh, ksize, bounds, kk);
    free(bounds);
    free(kk);
  }
  if (!need_h && !need_v) {
    memcpy(dst, src, static_cast<size_t>(sw) * sh * ch);
  }
  free(tmp);
  return CVT_OK;
}
