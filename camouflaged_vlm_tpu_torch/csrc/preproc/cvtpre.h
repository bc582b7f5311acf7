/* cvtpre — native host-side image preprocessing for camouflaged_vlm_tpu_torch.
 *
 * The runtime half of the data pipeline in plain C: JPEG/PNG decode, the
 * three resample filters and the fused normalisation, each bit-exact with
 * the Pillow 8-bit code paths the PIL pipeline uses (data/transforms.py;
 * verified by tests/test_torch_native_preproc.py), so the native and PIL
 * loaders are interchangeable sample for sample. The port's own copy of the
 * JAX package's csrc/preproc, with the same semantics; data/native.py builds
 * it at first use.
 *
 * All entry points are plain C, thread-safe (no global state), and do not
 * touch the Python API — ctypes calls release the GIL, so the loader's
 * thread pool gets true multicore decode+resample.
 */
#ifndef CVTPRE_H
#define CVTPRE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Resample filters (same semantics as PIL.Image.{NEAREST,BILINEAR,BICUBIC}). */
enum cvt_filter {
  CVT_NEAREST = 0,
  CVT_BILINEAR = 1,
  CVT_BICUBIC = 2,
};

/* Error codes. Negative values are hard errors; CVT_UNSUPPORTED means the
 * input is valid but outside the native fast path (caller should fall back
 * to PIL — e.g. 16-bit PNG, CMYK JPEG). */
enum cvt_status {
  CVT_OK = 0,
  CVT_UNSUPPORTED = 1,
  CVT_ERR_DECODE = -1,
  CVT_ERR_ARG = -2,
  CVT_ERR_ALLOC = -3,
};

typedef struct {
  int32_t width;
  int32_t height;
  int32_t channels; /* 1 (L) or 3 (RGB) */
  uint8_t *data;    /* HWC, tightly packed; cvt_free() when done */
} cvt_image;

/* Decode a JPEG or PNG byte buffer (format sniffed from magic bytes) into
 * 8-bit HWC pixels.  want_ch selects the output mode: 1 = L (PIL
 * convert("L") semantics, ITU-R 601-2 integer luma), 3 = RGB (PIL
 * convert("RGB"): palette expansion, alpha dropped — NOT blended).
 * Returns CVT_OK and fills *out (caller must cvt_free(out->data)), or
 * CVT_UNSUPPORTED / CVT_ERR_*. */
int cvt_decode(const uint8_t *buf, size_t len, int want_ch, cvt_image *out);

void cvt_free(void *p);

/* Resize src (sh x sw x ch, uint8 HWC) into dst (dh x dw x ch).
 * Bit-exact with PIL Image.resize for the 8-bit path:
 *   NEAREST  — center-floor sampling: src_x = floor((x+0.5)*sw/dw)
 *   BILINEAR/BICUBIC — Pillow's two-pass separable convolution with
 *   fixed-point (PRECISION_BITS=22) coefficients and clip8 rounding
 *   (Pillow src/libImaging/Resample.c semantics, reimplemented).
 * Returns CVT_OK or CVT_ERR_*. */
int cvt_resize(const uint8_t *src, int sw, int sh, int ch, uint8_t *dst,
               int dw, int dh, int filter);

/* PIL convert("L") on packed RGB: L = (R*19595 + G*38470 + B*7471) >> 16. */
void cvt_rgb2l(const uint8_t *src, int64_t npix, uint8_t *dst);

/* numpy rot90(k=1) — counter-clockwise: out[(w-1-x), y] = in[y, x].
 * dst is (w x h x ch) when src is (h x w x ch). */
void cvt_rot90ccw(const uint8_t *src, int w, int h, int ch, uint8_t *dst);

/* In-place horizontal flip (PIL FLIP_LEFT_RIGHT). */
void cvt_fliplr(uint8_t *buf, int w, int h, int ch);

/* Fused u8 -> f32 normalise: dst = (src/255.0f - mean[c]) / std[c], per
 * channel, matching the numpy float32 op order in data/transforms.py
 * (divide, subtract, divide — all fp32). npix = H*W. */
void cvt_normalize(const uint8_t *src, int64_t npix, int ch, const float *mean,
                   const float *stdv, float *dst);

#ifdef __cplusplus
}
#endif

#endif /* CVTPRE_H */
