// Native image-decode + staging pipeline for the PyTorch port: its own copy
// of image_segmentation_tpu/native/imagecodec.cpp, with the same C ABI and
// the same semantics.
//
// The reference feeds training through torch DataLoader worker PROCESSES
// that decode and resize every image each epoch (reference
// utils/dataset.py:6-51 + utils/training.py:40-43). This design
// materialises once (data/loader.py), and this library makes that
// materialisation native: one C call per item performs
//   file read -> libjpeg/libpng decode -> uint8->float staging ->
//   aspect-preserving resize (resample.cpp kernels) -> centred pad
// with the GIL released, so a Python thread pool scales it across cores
// (data/native_pipeline.py). Geometry semantics are IDENTICAL to
// ops/geometry.py resize_with_padding_np (scale = min(T/h, T/w),
// new = max(1, round-half-even(dim*scale)), centred zero pad); tests pin
// the native and PIL/numpy paths together.
//
// Build (done at first use by ops/native_codec.py, into build/torch_native/):
//   g++ -O3 -march=native -fopenmp -shared -fPIC \
//       imagecodec.cpp resample.cpp -lpng -ljpeg -o libistpu_imagecodec-<host>.so
//
// Exposed C ABI (ctypes) — all return 0 on success, negative error codes
// (CODEC_ERR_*) otherwise:
//   codec_probe_file(path, &h, &w, &c)
//   codec_probe_mem(buf, len, &h, &w, &c)
//   codec_decode_mem_u8(buf, len, out, h, w, c)   // dims from probe
//   codec_load_image_f32(path, target, antialias, out[T,T,3], meta6)
//   codec_load_label_i32(path, target, out[T,T], meta6, orig, orig_cap)
//   codec_load_heatmap_f32(path, target, antialias, out[T,T,1], meta6)
//
// meta6 = {orig_h, orig_w, new_h, new_w, pad_top, pad_left}.

#include <algorithm>
#include <cfenv>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

// resample.cpp entry points (compiled into the same shared object).
extern "C" void resample_linear(const float* in, int ih, int iw, int c,
                                int y0, int x0, int ch, int cw, float* out,
                                int oh, int ow, int antialias);

namespace {

enum {
  CODEC_OK = 0,
  CODEC_ERR_IO = -1,          // file unreadable
  CODEC_ERR_FORMAT = -2,      // not a PNG/JPEG, or unsupported variant
  CODEC_ERR_DECODE = -3,      // decoder reported corruption
  CODEC_ERR_SIZE = -4,        // caller buffer too small / dim mismatch
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) { std::fclose(f); return false; }
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

// ---------------------------------------------------------------- PNG --

struct PngMemReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t want) {
  PngMemReader* r = static_cast<PngMemReader*>(png_get_io_ptr(png));
  if (r->pos + want > r->len) {
    png_error(png, "read past end");
    return;
  }
  std::memcpy(out, r->data + r->pos, want);
  r->pos += want;
}

void png_silent_warn(png_structp, png_const_charp) {}

int decode_png(const uint8_t* buf, size_t len, std::vector<uint8_t>* px,
               int* h, int* w, int* c, bool header_only) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, png_silent_warn);
  if (!png) return CODEC_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return CODEC_ERR_DECODE;
  }
  std::vector<png_bytep> rows;  // declared before setjmp (longjmp safety)
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return CODEC_ERR_DECODE;
  }
  PngMemReader reader{buf, len, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  // 16-bit PNGs decode to uint16 under PIL but would be silently
  // truncated to the high byte here — decline so the PIL fallback
  // (the parity oracle) handles them.
  if (png_get_bit_depth(png, info) == 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    return CODEC_ERR_FORMAT;
  }

  // Normalise to 8-bit gray/rgb/rgba — the same shapes PIL's asarray
  // yields for L/P/RGB/RGBA inputs (data/dataset.py _decode_image).
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  *c = static_cast<int>(png_get_channels(png, info));
  if (header_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    return CODEC_OK;
  }
  px->resize(static_cast<size_t>(*h) * *w * *c);
  rows.resize(*h);
  const size_t stride = static_cast<size_t>(*w) * *c;
  for (int y = 0; y < *h; ++y) rows[y] = px->data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return CODEC_OK;
}

// --------------------------------------------------------------- JPEG --

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jmp, 1);
}

// Silence stderr output but keep counting corruption warnings (the
// default emit_message increments num_warnings for msg_level < 0, which
// decode_jpeg checks to reject truncated streams).
void jpeg_silent(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0) cinfo->err->num_warnings++;
}

int decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* px,
                int* h, int* w, int* c, bool header_only) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_silent;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return CODEC_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  // Grayscale stays 1-channel (PIL 'L'); everything else decodes to RGB.
  // CMYK/YCCK can't be converted by libjpeg — report unsupported and let
  // the Python caller fall back to PIL for that item.
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return CODEC_ERR_FORMAT;
  }
  cinfo.out_color_space =
      cinfo.jpeg_color_space == JCS_GRAYSCALE ? JCS_GRAYSCALE : JCS_RGB;
  if (header_only) {
    jpeg_calc_output_dimensions(&cinfo);
    *h = static_cast<int>(cinfo.output_height);
    *w = static_cast<int>(cinfo.output_width);
    *c = cinfo.out_color_space == JCS_GRAYSCALE ? 1 : 3;
    jpeg_destroy_decompress(&cinfo);
    return CODEC_OK;
  }
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  *c = static_cast<int>(cinfo.output_components);
  px->resize(static_cast<size_t>(*h) * *w * *c);
  const size_t stride = static_cast<size_t>(*w) * *c;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = px->data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  // Truncated streams are WARNINGS to libjpeg (it gray-fills the rest);
  // PIL raises on them. Treat any corruption warning as a decode error
  // so the caller's fallback/error path engages instead of silently
  // materialising half-gray images.
  const long warnings = cinfo.err->num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings > 0 ? CODEC_ERR_DECODE : CODEC_OK;
}

// ------------------------------------------------------------ dispatch --

bool is_png(const uint8_t* buf, size_t len) {
  return len >= 8 && png_sig_cmp(buf, 0, 8) == 0;
}

bool is_jpeg(const uint8_t* buf, size_t len) {
  return len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF;
}

int decode_any(const uint8_t* buf, size_t len, std::vector<uint8_t>* px,
               int* h, int* w, int* c, bool header_only) {
  if (is_png(buf, len)) return decode_png(buf, len, px, h, w, c, header_only);
  if (is_jpeg(buf, len)) return decode_jpeg(buf, len, px, h, w, c, header_only);
  return CODEC_ERR_FORMAT;
}

// ------------------------------------------------------------ geometry --

// Python's round() is round-half-to-even; std::nearbyint matches it under
// the default FE_TONEAREST mode (ops/geometry.py resize_with_padding_np).
void forward_meta(int h, int w, int target, int* nh, int* nw, int* pt,
                  int* pl, double* scale) {
  *scale = std::min(static_cast<double>(target) / h,
                    static_cast<double>(target) / w);
  *nh = std::max(1, static_cast<int>(std::nearbyint(h * *scale)));
  *nw = std::max(1, static_cast<int>(std::nearbyint(w * *scale)));
  *pt = (target - *nh) / 2;
  *pl = (target - *nw) / 2;
}

void fill_meta(int* meta6, int h, int w, int nh, int nw, int pt, int pl) {
  meta6[0] = h; meta6[1] = w; meta6[2] = nh;
  meta6[3] = nw; meta6[4] = pt; meta6[5] = pl;
}

}  // namespace

extern "C" {

int codec_probe_file(const char* path, int* h, int* w, int* c) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return CODEC_ERR_IO;
  return decode_any(buf.data(), buf.size(), nullptr, h, w, c, true);
}

int codec_probe_mem(const uint8_t* buf, long len, int* h, int* w, int* c) {
  return decode_any(buf, static_cast<size_t>(len), nullptr, h, w, c, true);
}

int codec_decode_mem_u8(const uint8_t* buf, long len, uint8_t* out, int h,
                        int w, int c) {
  std::vector<uint8_t> px;
  int dh, dw, dc;
  int rc = decode_any(buf, static_cast<size_t>(len), &px, &dh, &dw, &dc,
                      false);
  if (rc != CODEC_OK) return rc;
  if (dh != h || dw != w || dc != c) return CODEC_ERR_SIZE;
  std::memcpy(out, px.data(), px.size());
  return CODEC_OK;
}

// Decode {path} -> float [0,1] RGB -> resize_with_padding(target, linear)
// -> out (target, target, 3). Alpha dropped, grayscale replicated to RGB
// (reference utils/utils.py:92-93; data/dataset.py:72-75).
int codec_load_image_f32(const char* path, int target, int antialias,
                         float* out, int* meta6) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return CODEC_ERR_IO;
  std::vector<uint8_t> px;
  int h, w, c;
  int rc = decode_any(buf.data(), buf.size(), &px, &h, &w, &c, false);
  if (rc != CODEC_OK) return rc;
  if (c != 1 && c != 3 && c != 4) return CODEC_ERR_FORMAT;

  std::vector<float> rgb(static_cast<size_t>(h) * w * 3);
  const float inv = 1.0f / 255.0f;
  const size_t n = static_cast<size_t>(h) * w;
  if (c == 3) {
    for (size_t i = 0; i < n * 3; ++i) rgb[i] = px[i] * inv;
  } else if (c == 4) {  // drop alpha
    for (size_t i = 0; i < n; ++i) {
      rgb[i * 3 + 0] = px[i * 4 + 0] * inv;
      rgb[i * 3 + 1] = px[i * 4 + 1] * inv;
      rgb[i * 3 + 2] = px[i * 4 + 2] * inv;
    }
  } else {  // replicate gray
    for (size_t i = 0; i < n; ++i) {
      const float v = px[i] * inv;
      rgb[i * 3 + 0] = v; rgb[i * 3 + 1] = v; rgb[i * 3 + 2] = v;
    }
  }

  int nh, nw, pt, pl;
  double scale;
  forward_meta(h, w, target, &nh, &nw, &pt, &pl, &scale);
  std::vector<float> resized(static_cast<size_t>(nh) * nw * 3);
  resample_linear(rgb.data(), h, w, 3, 0, 0, h, w, resized.data(), nh, nw,
                  antialias);
  std::memset(out, 0, sizeof(float) * target * target * 3);
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out + (static_cast<size_t>(pt + y) * target + pl) * 3,
                resized.data() + static_cast<size_t>(y) * nw * 3,
                sizeof(float) * nw * 3);
  }
  fill_meta(meta6, h, w, nh, nw, pt, pl);
  return CODEC_OK;
}

// Decode a class-id PNG label -> channel 0 -> nearest (legacy floor map,
// the reference's torchvision NEAREST) resize -> centred pad -> int32
// (target, target). If orig != nullptr the native-resolution label plane
// (row-major, h*w values) is also written when orig_cap allows; when it
// doesn't, returns CODEC_ERR_SIZE with meta6 VALID so the caller can
// re-call with an exact buffer — no separate probe (and file re-read)
// needed for the common case of a generous default capacity.
int codec_load_label_i32(const char* path, int target, int32_t* out,
                         int* meta6, int32_t* orig, long orig_cap) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return CODEC_ERR_IO;
  std::vector<uint8_t> px;
  int h, w, c;
  int rc = decode_any(buf.data(), buf.size(), &px, &h, &w, &c, false);
  if (rc != CODEC_OK) return rc;

  int nh, nw, pt, pl;
  double scale;
  forward_meta(h, w, target, &nh, &nw, &pt, &pl, &scale);
  fill_meta(meta6, h, w, nh, nw, pt, pl);

  if (orig != nullptr) {
    if (static_cast<long>(h) * w > orig_cap) return CODEC_ERR_SIZE;
    for (size_t i = 0; i < static_cast<size_t>(h) * w; ++i)
      orig[i] = px[i * c];
  }
  // legacy floor(dst*in/out) index map — ops/geometry.py
  // resize_nearest_np(exact=False)
  std::vector<int> yi(nh), xi(nw);
  for (int y = 0; y < nh; ++y)
    yi[y] = std::min(h - 1, static_cast<int>(
        static_cast<int64_t>(y) * h / nh));
  for (int x = 0; x < nw; ++x)
    xi[x] = std::min(w - 1, static_cast<int>(
        static_cast<int64_t>(x) * w / nw));
  std::memset(out, 0, sizeof(int32_t) * target * target);
  for (int y = 0; y < nh; ++y) {
    const uint8_t* src = px.data() + static_cast<size_t>(yi[y]) * w * c;
    int32_t* dst = out + static_cast<size_t>(pt + y) * target + pl;
    for (int x = 0; x < nw; ++x) dst[x] = src[static_cast<size_t>(xi[x]) * c];
  }
  return CODEC_OK;  // meta6 already filled above
}

// Decode a 0-255 L-mode heatmap PNG -> float [0,1] -> linear resize ->
// centred pad -> (target, target, 1).
int codec_load_heatmap_f32(const char* path, int target, int antialias,
                           float* out, int* meta6) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return CODEC_ERR_IO;
  std::vector<uint8_t> px;
  int h, w, c;
  int rc = decode_any(buf.data(), buf.size(), &px, &h, &w, &c, false);
  if (rc != CODEC_OK) return rc;

  std::vector<float> plane(static_cast<size_t>(h) * w);
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < plane.size(); ++i) plane[i] = px[i * c] * inv;

  int nh, nw, pt, pl;
  double scale;
  forward_meta(h, w, target, &nh, &nw, &pt, &pl, &scale);
  std::vector<float> resized(static_cast<size_t>(nh) * nw);
  resample_linear(plane.data(), h, w, 1, 0, 0, h, w, resized.data(), nh, nw,
                  antialias);
  std::memset(out, 0, sizeof(float) * target * target);
  for (int y = 0; y < nh; ++y) {
    std::memcpy(out + static_cast<size_t>(pt + y) * target + pl,
                resized.data() + static_cast<size_t>(y) * nw,
                sizeof(float) * nw);
  }
  fill_meta(meta6, h, w, nh, nw, pt, pl);
  return CODEC_OK;
}

}  // extern "C"
