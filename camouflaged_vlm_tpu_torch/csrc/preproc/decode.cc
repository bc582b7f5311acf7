// JPEG/PNG in-memory decoders with PIL-equivalent output semantics.
//
// JPEG: libjpeg(-turbo) with Pillow's decoder settings — JDCT_ISLOW,
// fancy upsampling on (both are the library defaults Pillow keeps;
// Pillow src/libImaging/JpegDecode.c).  Grayscale JPEGs are decoded as
// L and converted with the same integer luma PIL uses; CMYK/YCCK are
// reported CVT_UNSUPPORTED so the Python side falls back to PIL.
//
// PNG: libpng with transforms chosen to mirror PIL convert("RGB") /
// convert("L") exactly: palette expanded, <8-bit gray expanded, alpha
// STRIPPED (convert("RGB") drops alpha without blending), 16-bit left to
// the PIL fallback (PIL maps those to mode I;16 with different semantics).

#include "cvtpre.h"

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr *err = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_output_nothing(j_common_ptr, int) {}

int decode_jpeg(const uint8_t *buf, size_t len, int want_ch, cvt_image *out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // volatile: assigned between setjmp and a possible longjmp — without the
  // qualifier the error path may free an indeterminate (stale-register) value.
  uint8_t *volatile pixels = nullptr;

  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  jerr.mgr.emit_message = jpeg_output_nothing;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    free(pixels);
    return CVT_ERR_DECODE;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t *>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return CVT_ERR_DECODE;
  }

  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return CVT_UNSUPPORTED;
  }

  // Decode in the file's natural space; channel conversion happens after so
  // it is bit-identical to PIL's convert() (libjpeg's own gray<->RGB paths
  // are equivalent for gray->RGB replication but we keep one code path).
  const bool src_gray = (cinfo.jpeg_color_space == JCS_GRAYSCALE);
  cinfo.out_color_space = src_gray ? JCS_GRAYSCALE : JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW; // Pillow's setting (and the lib default)

  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  const int ch = cinfo.output_components; // 1 or 3
  if (w <= 0 || h <= 0 || (ch != 1 && ch != 3)) {
    jpeg_destroy_decompress(&cinfo);
    return CVT_ERR_DECODE;
  }
  pixels = static_cast<uint8_t *>(
      malloc(static_cast<size_t>(w) * h * ch));
  if (!pixels) {
    jpeg_destroy_decompress(&cinfo);
    return CVT_ERR_ALLOC;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels + static_cast<size_t>(cinfo.output_scanline) * w * ch;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  const int64_t npix = static_cast<int64_t>(w) * h;
  if (want_ch == ch) {
    out->data = pixels;
  } else if (want_ch == 1 && ch == 3) {
    uint8_t *l = static_cast<uint8_t *>(malloc(static_cast<size_t>(npix)));
    if (!l) {
      free(pixels);
      return CVT_ERR_ALLOC;
    }
    cvt_rgb2l(pixels, npix, l);
    free(pixels);
    out->data = l;
  } else if (want_ch == 3 && ch == 1) {
    uint8_t *rgb = static_cast<uint8_t *>(malloc(static_cast<size_t>(npix) * 3));
    if (!rgb) {
      free(pixels);
      return CVT_ERR_ALLOC;
    }
    for (int64_t i = 0; i < npix; i++) {
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = pixels[i];
    }
    free(pixels);
    out->data = rgb;
  } else {
    free(pixels);
    return CVT_ERR_ARG;
  }
  out->width = w;
  out->height = h;
  out->channels = want_ch;
  return CVT_OK;
}

struct PngReadState {
  const uint8_t *buf;
  size_t len;
  size_t pos;
};

void png_read_from_mem(png_structp png, png_bytep out, png_size_t n) {
  PngReadState *st = static_cast<PngReadState *>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "read past end");
  }
  memcpy(out, st->buf + st->pos, n);
  st->pos += n;
}

void png_silent_warning(png_structp, png_const_charp) {}

int decode_png(const uint8_t *buf, size_t len, int want_ch, cvt_image *out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return CVT_ERR_ALLOC;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return CVT_ERR_ALLOC;
  }
  png_set_error_fn(png, png_get_error_ptr(png), nullptr, png_silent_warning);

  // volatile: assigned between setjmp and a possible longjmp (see decode_jpeg)
  uint8_t *volatile pixels = nullptr;
  png_bytep *volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(pixels);
    free(rows);
    return CVT_ERR_DECODE;
  }

  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_from_mem);
  png_read_info(png, info);

  const png_uint_32 w = png_get_image_width(png, info);
  const png_uint_32 h = png_get_image_height(png, info);
  const int bit_depth = png_get_bit_depth(png, info);
  const int color_type = png_get_color_type(png, info);

  if (bit_depth > 8) {
    // PIL opens 16-bit PNG as mode I;16 — conversion semantics differ, so
    // the Python wrapper falls back to PIL for exactness.
    png_destroy_read_struct(&png, &info, nullptr);
    return CVT_UNSUPPORTED;
  }

  // Normalise everything to 8-bit RGB or GRAY with PIL convert() semantics.
  if (color_type == PNG_COLOR_TYPE_PALETTE) {
    png_set_palette_to_rgb(png);
  }
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) {
    png_set_expand_gray_1_2_4_to_8(png);
  }
  if (png_get_valid(png, info, PNG_INFO_tRNS)) {
    png_set_tRNS_to_alpha(png);
  }
  // convert("RGB")/convert("L") DROP alpha (no blending) — strip it.
  png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const int ch = png_get_channels(png, info); // 1 or 3 after transforms
  if ((ch != 1 && ch != 3) || w == 0 || h == 0) {
    png_destroy_read_struct(&png, &info, nullptr);
    return CVT_UNSUPPORTED;
  }
  const size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != static_cast<size_t>(w) * ch) {
    png_destroy_read_struct(&png, &info, nullptr);
    return CVT_UNSUPPORTED;
  }

  pixels = static_cast<uint8_t *>(malloc(static_cast<size_t>(w) * h * ch));
  rows = static_cast<png_bytep *>(malloc(sizeof(png_bytep) * h));
  if (!pixels || !rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(pixels);
    free(rows);
    return CVT_ERR_ALLOC;
  }
  for (png_uint_32 y = 0; y < h; y++) {
    rows[y] = pixels + static_cast<size_t>(y) * rowbytes;
  }
  png_read_image(png, rows);
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);

  const int64_t npix = static_cast<int64_t>(w) * h;
  if (want_ch == ch) {
    out->data = pixels;
  } else if (want_ch == 1 && ch == 3) {
    uint8_t *l = static_cast<uint8_t *>(malloc(static_cast<size_t>(npix)));
    if (!l) {
      free(pixels);
      return CVT_ERR_ALLOC;
    }
    cvt_rgb2l(pixels, npix, l);
    free(pixels);
    out->data = l;
  } else if (want_ch == 3 && ch == 1) {
    uint8_t *rgb = static_cast<uint8_t *>(malloc(static_cast<size_t>(npix) * 3));
    if (!rgb) {
      free(pixels);
      return CVT_ERR_ALLOC;
    }
    for (int64_t i = 0; i < npix; i++) {
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = pixels[i];
    }
    free(pixels);
    out->data = rgb;
  } else {
    free(pixels);
    return CVT_ERR_ARG;
  }
  out->width = static_cast<int32_t>(w);
  out->height = static_cast<int32_t>(h);
  out->channels = want_ch;
  return CVT_OK;
}

} // namespace

extern "C" {

int cvt_decode(const uint8_t *buf, size_t len, int want_ch, cvt_image *out) {
  if (!buf || !out || len < 8 || (want_ch != 1 && want_ch != 3)) {
    return CVT_ERR_ARG;
  }
  out->data = nullptr;
  static const uint8_t kPngMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                       '\n'};
  if (memcmp(buf, kPngMagic, 8) == 0) {
    return decode_png(buf, len, want_ch, out);
  }
  if (buf[0] == 0xFF && buf[1] == 0xD8) {
    return decode_jpeg(buf, len, want_ch, out);
  }
  return CVT_UNSUPPORTED;
}

void cvt_free(void *p) { free(p); }

} // extern "C"
