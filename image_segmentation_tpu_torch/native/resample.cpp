// Native host-side image resampling for the PyTorch port: its own copy of
// image_segmentation_tpu/native/resample.cpp, with the same C ABI and the
// same arithmetic.
//
// The hot host operations (dataset materialisation, serving-side staging,
// and the original-resolution eval inverse — reference utils/utils.py
// resize/interpolate calls) are separable triangle-kernel resamples. The
// numpy implementation does two general matmuls per image; this library
// specialises the kernel structure instead: each output pixel touches at
// most ceil(2·kernel_scale)+1 taps, so we precompute per-axis (offset,
// weights) tables once and stream the image through them with OpenMP
// across rows. Semantics are IDENTICAL to ops/geometry.py
// (_triangle_weight_matrix_np): half-pixel centres, kernel scaled by
// max(in/out, 1) when antialiasing, edge weights renormalised — unit
// tests pin the two paths together.
//
// Build (done at first use by ops/native.py, into build/torch_native/):
//   g++ -O3 -march=native -fopenmp -shared -fPIC resample.cpp \
//       -o libistpu_resample-<host>.so
//
// Exposed C ABI (ctypes):
//   resample_linear(in, ih, iw, c, y0, x0, ch, cw, out, oh, ow, antialias)
//     — resize the [y0:y0+ch, x0:x0+cw] crop of a (ih, iw, c) float32
//       image to (oh, ow, c). Full-image resize = crop of everything.
//   resample_nearest(...same..., exact)
//   resample_batch_linear(in, n, ih, iw, c, out, oh, ow, antialias)
//     — n same-sized images in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AxisTable {
  int taps;                 // max taps per output pixel
  std::vector<int> start;   // first input index per output pixel
  std::vector<float> weight;  // (out, taps) row-major, renormalised
};

AxisTable build_table(int in_size, int out_size, bool antialias) {
  AxisTable t;
  const double scale = static_cast<double>(out_size) / in_size;
  const double kernel_scale = antialias ? std::max(1.0 / scale, 1.0) : 1.0;
  const double support = kernel_scale;  // triangle kernel radius
  t.taps = static_cast<int>(std::ceil(2.0 * support)) + 1;
  t.start.resize(out_size);
  t.weight.assign(static_cast<size_t>(out_size) * t.taps, 0.0f);
  for (int o = 0; o < out_size; ++o) {
    const double sample = (o + 0.5) / scale - 0.5;
    int first = static_cast<int>(std::ceil(sample - support));
    double total = 0.0;
    std::vector<double> w(t.taps, 0.0);
    for (int k = 0; k < t.taps; ++k) {
      const int i = first + k;
      if (i < 0 || i >= in_size) continue;
      const double x = std::abs(sample - i) / kernel_scale;
      const double v = std::max(0.0, 1.0 - x);
      w[k] = v;
      total += v;
    }
    t.start[o] = first;
    if (total > 1e-7) {
      for (int k = 0; k < t.taps; ++k)
        t.weight[static_cast<size_t>(o) * t.taps + k] =
            static_cast<float>(w[k] / total);
    }
  }
  return t;
}

// Resize rows then columns for one (ch, cw, c) crop view with row stride
// `row_stride` floats, into out (oh, ow, c).
void resample_one(const float* in, int row_stride, int ch, int cw, int c,
                  float* out, int oh, int ow, const AxisTable& ty,
                  const AxisTable& tx, float* tmp /* oh*cw*c scratch */) {
  // rows: (ch, cw*c) -> (oh, cw*c)
  const int wline = cw * c;
  for (int o = 0; o < oh; ++o) {
    float* dst = tmp + static_cast<size_t>(o) * wline;
    std::memset(dst, 0, sizeof(float) * wline);
    const int first = ty.start[o];
    for (int k = 0; k < ty.taps; ++k) {
      const int i = first + k;
      if (i < 0 || i >= ch) continue;
      const float w = ty.weight[static_cast<size_t>(o) * ty.taps + k];
      if (w == 0.0f) continue;
      const float* src = in + static_cast<size_t>(i) * row_stride;
      for (int x = 0; x < wline; ++x) dst[x] += w * src[x];
    }
  }
  // cols: (oh, cw, c) -> (oh, ow, c)
  for (int y = 0; y < oh; ++y) {
    const float* src_row = tmp + static_cast<size_t>(y) * wline;
    float* out_row = out + static_cast<size_t>(y) * ow * c;
    for (int o = 0; o < ow; ++o) {
      const int first = tx.start[o];
      float* dst = out_row + static_cast<size_t>(o) * c;
      for (int ch_i = 0; ch_i < c; ++ch_i) dst[ch_i] = 0.0f;
      for (int k = 0; k < tx.taps; ++k) {
        const int i = first + k;
        if (i < 0 || i >= cw) continue;
        const float w = tx.weight[static_cast<size_t>(o) * tx.taps + k];
        if (w == 0.0f) continue;
        const float* src = src_row + static_cast<size_t>(i) * c;
        for (int ch_i = 0; ch_i < c; ++ch_i) dst[ch_i] += w * src[ch_i];
      }
    }
  }
}

}  // namespace

extern "C" {

void resample_linear(const float* in, int ih, int iw, int c, int y0, int x0,
                     int ch, int cw, float* out, int oh, int ow,
                     int antialias) {
  AxisTable ty = build_table(ch, oh, antialias != 0);
  AxisTable tx = build_table(cw, ow, antialias != 0);
  std::vector<float> tmp(static_cast<size_t>(oh) * cw * c);
  const float* crop = in + (static_cast<size_t>(y0) * iw + x0) * c;
  resample_one(crop, iw * c, ch, cw, c, out, oh, ow, ty, tx, tmp.data());
}

void resample_nearest(const float* in, int ih, int iw, int c, int y0, int x0,
                      int ch, int cw, float* out, int oh, int ow, int exact) {
  for (int y = 0; y < oh; ++y) {
    const double fy = exact ? (y + 0.5) * ch / static_cast<double>(oh)
                            : y * ch / static_cast<double>(oh);
    int yi = std::min(ch - 1, std::max(0, static_cast<int>(std::floor(fy))));
    const float* src_row = in + (static_cast<size_t>(y0 + yi) * iw + x0) * c;
    float* out_row = out + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      const double fx = exact ? (x + 0.5) * cw / static_cast<double>(ow)
                              : x * cw / static_cast<double>(ow);
      int xi = std::min(cw - 1, std::max(0, static_cast<int>(std::floor(fx))));
      std::memcpy(out_row + static_cast<size_t>(x) * c,
                  src_row + static_cast<size_t>(xi) * c, sizeof(float) * c);
    }
  }
}

void resample_batch_linear(const float* in, int n, int ih, int iw, int c,
                           float* out, int oh, int ow, int antialias) {
  AxisTable ty = build_table(ih, oh, antialias != 0);
  AxisTable tx = build_table(iw, ow, antialias != 0);
#pragma omp parallel
  {
    std::vector<float> tmp(static_cast<size_t>(oh) * iw * c);
#pragma omp for
    for (int i = 0; i < n; ++i) {
      resample_one(in + static_cast<size_t>(i) * ih * iw * c, iw * c, ih, iw,
                   c, out + static_cast<size_t>(i) * oh * ow * c, oh, ow, ty,
                   tx, tmp.data());
    }
  }
}

}  // extern "C"
