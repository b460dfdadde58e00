// Host-side image preprocessing for the port's loaders, server and renders.
//
// Plain C entry points, called through ctypes (native/__init__.py), which
// releases the GIL for the length of the call, so the loader's prefetch
// threads and the HTTP server's request threads resize in parallel on real
// cores. Each function computes exactly what a numpy or library version
// computes (the tests hold them bit for bit):
//
//   * resize_u8_to_f32 / resize_u16_to_f32 / resize_f32: NEAREST_EXACT
//     resizes with a fused uint -> float scale, as torch computes the
//     source index: clamp(floor((dst + 0.5) * in/out), 0, in-1) in float32;
//   * gather_rows_cols: a nearest resize whose source rows and columns were
//     computed by the caller (PIL's NEAREST indices, any pixel size);
//   * resize_bilinear_u8 / resize_bilinear_f32: PIL's BILINEAR
//     `Image.resize` (its convolution resampler: a triangle filter widened
//     by the scale when downsizing, 22-bit fixed-point coefficients for
//     8-bit images and double ones for "F" images, horizontal pass first);
//   * resize_bicubic_u8 / resize_bicubic_u16: PIL's BICUBIC `Image.resize`
//     (the same resampler with the cubic filter, a = -0.5, support 2) of an
//     8-bit image and of an "I;16" image (double coefficients, each pass
//     rounded half away from zero, then the low byte and the high byte
//     each clipped to 0..255 on their own, as Pillow stores a 16-bit
//     sample);
//   * contours_find / draw_contours: OpenCV's findContours(RETR_TREE,
//     CHAIN_APPROX_SIMPLE) (Suzuki-Abe border following on a zero-padded
//     copy of the mask, the chain compressed to its corners) and
//     drawContours(..., thickness) with 8-connected lines (each segment a
//     filled quadrilateral in 16.16 fixed point plus a filled disc at its
//     end point).
//
// Build (native/_build.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -fopenmp preprocess.cpp -o libpreprocess.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

void nearest_indices(int in_size, int out_size, int32_t* idx) {
  const float scale =
      static_cast<float>(in_size) / static_cast<float>(out_size);
  for (int i = 0; i < out_size; ++i) {
    float src = (static_cast<float>(i) + 0.5f) * scale;
    int v = static_cast<int>(std::floor(src));
    idx[i] = std::min(std::max(v, 0), in_size - 1);
  }
}

// ------------------------------------------------------- PIL bilinear

constexpr int kPrecisionBits = 32 - 8 - 2;

// PIL's filters (Resample.c): the triangle (support 1) and the cubic
// convolution with a = -0.5 (support 2)
double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};
const Filter kBilinear = {bilinear_filter, 1.0};
const Filter kBicubic = {bicubic_filter, 2.0};

// PIL's precompute_coeffs: per output pixel the first source pixel, the
// tap count and `ksize` normalised weights.
int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<double>* kk,
                      const Filter& filter = kBilinear) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = filter.support * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds->assign(2 * static_cast<size_t>(out_size), 0);
  kk->assign(static_cast<size_t>(out_size) * ksize, 0.0);
  const double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = kk->data() + static_cast<size_t>(xx) * ksize;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = filter.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    (*bounds)[2 * xx] = xmin;
    (*bounds)[2 * xx + 1] = xmax;
  }
  return ksize;
}

std::vector<int32_t> fixed_coeffs(const std::vector<double>& kk) {
  std::vector<int32_t> out(kk.size());
  for (size_t i = 0; i < kk.size(); ++i) {
    const double v = kk[i] * (1 << kPrecisionBits);
    out[i] = static_cast<int32_t>(kk[i] < 0 ? v - 0.5 : v + 0.5);
  }
  return out;
}

inline uint8_t clip8(int32_t ss) {
  int32_t v = ss >> kPrecisionBits;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One pass over `n_lines` lines of `in_len` pixels, `ch` channels each:
// `src_tap` elements between a line's pixels, `src_line` between lines
// (`dst_px` and `dst_line` in the output).
template <const Filter& F>
void pass_u8(const uint8_t* src, uint8_t* dst, int n_lines, int in_len,
             int out_len, int ch, int64_t src_line, int64_t src_tap,
             int64_t dst_line, int64_t dst_px) {
  std::vector<int> bounds;
  std::vector<double> kk;
  const int ksize = precompute_coeffs(in_len, out_len, &bounds, &kk, F);
  const std::vector<int32_t> k = fixed_coeffs(kk);
#pragma omp parallel for schedule(static) if (static_cast<int64_t>(n_lines) * out_len > 65536)
  for (int line = 0; line < n_lines; ++line) {
    const uint8_t* s = src + line * src_line;
    uint8_t* d = dst + line * dst_line;
    for (int xx = 0; xx < out_len; ++xx) {
      const int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const int32_t* kx = k.data() + static_cast<size_t>(xx) * ksize;
      for (int c = 0; c < ch; ++c) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x) {
          ss += static_cast<int32_t>(s[(x + xmin) * src_tap + c]) * kx[x];
        }
        d[xx * dst_px + c] = clip8(ss);
      }
    }
  }
}

void pass_f32(const float* src, float* dst, int n_lines, int in_len,
              int out_len, int ch, int64_t src_line, int64_t src_tap,
              int64_t dst_line, int64_t dst_px) {
  std::vector<int> bounds;
  std::vector<double> kk;
  const int ksize = precompute_coeffs(in_len, out_len, &bounds, &kk);
#pragma omp parallel for schedule(static) if (static_cast<int64_t>(n_lines) * out_len > 65536)
  for (int line = 0; line < n_lines; ++line) {
    const float* s = src + line * src_line;
    float* d = dst + line * dst_line;
    for (int xx = 0; xx < out_len; ++xx) {
      const int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const double* kx = kk.data() + static_cast<size_t>(xx) * ksize;
      for (int c = 0; c < ch; ++c) {
        double ss = 0.0;
        for (int x = 0; x < xmax; ++x) {
          ss += static_cast<double>(s[(x + xmin) * src_tap + c]) * kx[x];
        }
        d[xx * dst_px + c] = static_cast<float>(ss);
      }
    }
  }
}

// Pillow's ROUND_UP (half away from zero) and its store of a 16-bit
// sample: the low byte (C remainder) and the high byte (arithmetic shift)
// each clipped to 0..255 on their own
inline uint16_t store_u16(double ss) {
  const int v = static_cast<int>(ss >= 0.0 ? std::floor(ss + 0.5)
                                           : -std::floor(std::fabs(ss) + 0.5));
  const int lo = v % 256, hi = v >> 8;
  const int l = lo <= 0 ? 0 : (lo < 256 ? lo : 255);
  const int h = hi <= 0 ? 0 : (hi < 256 ? hi : 255);
  return static_cast<uint16_t>(l | (h << 8));
}

void pass_u16(const uint16_t* src, uint16_t* dst, int n_lines, int in_len,
              int out_len, int ch, int64_t src_line, int64_t src_tap,
              int64_t dst_line, int64_t dst_px) {
  std::vector<int> bounds;
  std::vector<double> kk;
  const int ksize = precompute_coeffs(in_len, out_len, &bounds, &kk,
                                      kBicubic);
#pragma omp parallel for schedule(static) if (static_cast<int64_t>(n_lines) * out_len > 65536)
  for (int line = 0; line < n_lines; ++line) {
    const uint16_t* s = src + line * src_line;
    uint16_t* d = dst + line * dst_line;
    for (int xx = 0; xx < out_len; ++xx) {
      const int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const double* kx = kk.data() + static_cast<size_t>(xx) * ksize;
      for (int c = 0; c < ch; ++c) {
        double ss = 0.0;
        for (int x = 0; x < xmax; ++x) {
          ss += static_cast<double>(s[(x + xmin) * src_tap + c]) * kx[x];
        }
        d[xx * dst_px + c] = store_u16(ss);
      }
    }
  }
}

// the two passes of a PIL resize: horizontal (if the width changes) then
// vertical
template <typename T, typename Pass>
void resample(const T* src, int in_h, int in_w, int ch, T* dst,
                     int out_h, int out_w, Pass pass) {
  // horizontal pass (if the width changes) into `mid`, then vertical
  const T* cur = src;
  std::vector<T> mid;
  int cur_w = in_w;
  if (out_w != in_w) {
    T* out = dst;
    if (out_h != in_h) {
      mid.resize(static_cast<size_t>(in_h) * out_w * ch);
      out = mid.data();
    }
    pass(cur, out, in_h, in_w, out_w, ch,
         static_cast<int64_t>(in_w) * ch, ch,
         static_cast<int64_t>(out_w) * ch, ch);
    cur = out;
    cur_w = out_w;
  }
  if (out_h != in_h) {
    // columns as lines: taps one row apart
    pass(cur, dst, cur_w * ch, in_h, out_h, 1, 1,
         static_cast<int64_t>(cur_w) * ch, 1,
         static_cast<int64_t>(cur_w) * ch);
  } else if (out_w == in_w) {
    std::memcpy(dst, src, sizeof(T) * static_cast<size_t>(in_h) * in_w * ch);
  }
}

// --------------------------------------------------- contours (Suzuki-Abe)

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct Contours {
  std::vector<int32_t> xy;     // (x, y) pairs, contour after contour
  std::vector<int32_t> lens;   // points per contour
};

// OpenCV's icvFetchContour with CHAIN_APPROX_SIMPLE on a padded int8 image
// (0 background, 1 unvisited object, 2 visited, -126 right bound): follows
// the border from `i0` and appends the chain's corners.
void fetch_contour(int8_t* img, int64_t step, int64_t i0, int x, int y,
                   bool hole, Contours* out) {
  const int8_t nbd = 2;
  int64_t deltas[16];
  const int64_t base[8] = {1, -step + 1, -step, -step - 1,
                           -1, step - 1, step, step + 1};
  for (int i = 0; i < 16; ++i) deltas[i] = base[i & 7];
  int s_end, s;
  s_end = s = hole ? 0 : 4;
  int64_t i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (img[i1] == 0 && s != s_end);
  size_t n0 = out->xy.size();
  if (s == s_end) {            // a single-pixel domain
    img[i0] = static_cast<int8_t>(nbd | -128);
    out->xy.push_back(x);
    out->xy.push_back(y);
  } else {
    int64_t i3 = i0, i4 = 0;
    int prev_s = s ^ 4;
    for (;;) {
      s_end = s;
      while (s < 15) {
        i4 = i3 + deltas[++s];
        if (img[i4] != 0) break;
      }
      s &= 7;
      if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
        img[i3] = static_cast<int8_t>(nbd | -128);
      } else if (img[i3] == 1) {
        img[i3] = nbd;
      }
      if (s != prev_s) {
        out->xy.push_back(x);
        out->xy.push_back(y);
        prev_s = s;
      }
      x += kDx[s];
      y += kDy[s];
      if (i4 == i0 && i3 == i1) break;
      i3 = i4;
      s = (s + 4) & 7;
    }
  }
  out->lens.push_back(static_cast<int32_t>((out->xy.size() - n0) / 2));
}

void find_contours(const uint8_t* mask, int h, int w, Contours* out) {
  const int64_t step = w + 2;
  std::vector<int8_t> img(static_cast<size_t>(h + 2) * step, 0);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      img[(y + 1) * step + x + 1] = mask[static_cast<int64_t>(y) * w + x] != 0;
    }
  }
  // raster scan of the padded image; a border starts where a run changes
  for (int y = 1; y <= h; ++y) {
    int8_t prev = 0;
    int8_t* row = img.data() + y * step;
    for (int x = 1; x < w + 2; ++x) {
      const int8_t p = row[x];
      if (p == prev) continue;
      bool hole = false;
      bool start = prev == 0 && p == 1;     // an outer border
      if (!start && p == 0 && prev >= 1) {  // a hole border
        start = hole = true;
      }
      if (start) {
        const int sx = x - (hole ? 1 : 0);
        fetch_contour(img.data(), step, y * step + sx, sx - 1, y - 1, hole,
                      out);
        prev = row[x];   // as relabelled by the trace (OpenCV re-reads it)
      } else {
        prev = p;
      }
    }
  }
}

// ------------------------------------------------------- OpenCV drawing

constexpr int kXYShift = 16;
constexpr int64_t kXYOne = int64_t(1) << kXYShift;

struct Canvas {
  uint8_t* ptr;
  int w, h, ch;
  const uint8_t* color;
  void put(int x, int y) const {
    if (0 <= x && x < w && 0 <= y && y < h) {
      std::memcpy(ptr + (static_cast<int64_t>(y) * w + x) * ch, color, ch);
    }
  }
  void hline(int y, int x1, int x2) const {   // inclusive; row in range
    for (int x = x1; x <= x2; ++x) {
      std::memcpy(ptr + (static_cast<int64_t>(y) * w + x) * ch, color, ch);
    }
  }
};

// cv::clipLine on a size in 16.16 fixed point
bool clip_line(int64_t width, int64_t height, int64_t* x1, int64_t* y1,
               int64_t* x2, int64_t* y2) {
  const int64_t right = width - 1, bottom = height - 1;
  if (width <= 0 || height <= 0) return false;
  int c1 = (*x1 < 0) + (*x1 > right) * 2 + (*y1 < 0) * 4 + (*y1 > bottom) * 8;
  int c2 = (*x2 < 0) + (*x2 > right) * 2 + (*y2 < 0) * 4 + (*y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      *x1 += static_cast<int64_t>(static_cast<double>(a - *y1) *
                                  (*x2 - *x1) / (*y2 - *y1));
      *y1 = a;
      c1 = (*x1 < 0) + (*x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      *x2 += static_cast<int64_t>(static_cast<double>(a - *y2) *
                                  (*x2 - *x1) / (*y2 - *y1));
      *y2 = a;
      c2 = (*x2 < 0) + (*x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        *y1 += static_cast<int64_t>(static_cast<double>(a - *x1) *
                                    (*y2 - *y1) / (*x2 - *x1));
        *x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        *y2 += static_cast<int64_t>(static_cast<double>(a - *x2) *
                                    (*y2 - *y1) / (*x2 - *x1));
        *x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// OpenCV's Line2: an 8-connected line between 16.16 fixed-point ends
void line2(const Canvas& cv, int64_t x1, int64_t y1, int64_t x2, int64_t y2) {
  if (!clip_line(int64_t(cv.w) << kXYShift, int64_t(cv.h) << kXYShift, &x1,
                 &y1, &x2, &y2)) {
    return;
  }
  int64_t dx = x2 - x1, dy = y2 - y1;
  const int64_t j = dx < 0 ? -1 : 0;
  const int64_t ax = (dx ^ j) - j;
  const int64_t i = dy < 0 ? -1 : 0;
  const int64_t ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    x1 ^= x2 & j; x2 ^= x1 & j; x1 ^= x2 & j;
    y1 ^= y2 & j; y2 ^= y1 & j; y1 ^= y2 & j;
    x_step = kXYOne;
    y_step = (dy * kXYOne) / (ax | 1);
    ecount = static_cast<int>((x2 - x1) >> kXYShift);
  } else {
    dx = (dx ^ i) - i;
    x1 ^= x2 & i; x2 ^= x1 & i; x1 ^= x2 & i;
    y1 ^= y2 & i; y2 ^= y1 & i; y1 ^= y2 & i;
    x_step = (dx * kXYOne) / (ay | 1);
    y_step = kXYOne;
    ecount = static_cast<int>((y2 - y1) >> kXYShift);
  }
  x1 += kXYOne >> 1;
  y1 += kXYOne >> 1;
  cv.put(static_cast<int>((x2 + (kXYOne >> 1)) >> kXYShift),
         static_cast<int>((y2 + (kXYOne >> 1)) >> kXYShift));
  if (ax > ay) {
    x1 >>= kXYShift;
    while (ecount >= 0) {
      cv.put(static_cast<int>(x1), static_cast<int>(y1 >> kXYShift));
      x1++;
      y1 += y_step;
      ecount--;
    }
  } else {
    y1 >>= kXYShift;
    while (ecount >= 0) {
      cv.put(static_cast<int>(x1 >> kXYShift), static_cast<int>(y1));
      x1 += x_step;
      y1++;
      ecount--;
    }
  }
  (void)x_step;
  (void)y_step;
}

// OpenCV's FillConvexPoly for 8-connected lines, vertices in 16.16
void fill_convex_poly(const Canvas& cv, const int64_t* vx, const int64_t* vy,
                      int npts) {
  struct Edge {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  const int64_t delta = kXYOne >> 1;
  const int64_t delta1 = kXYOne >> 1, delta2 = kXYOne >> 1;
  int imin = 0, edges = npts;
  int64_t xmin = vx[0], xmax = vx[0], ymin = vy[0], ymax = vy[0];
  int64_t px = vx[npts - 1], py = vy[npts - 1];
  for (int i = 0; i < npts; ++i) {
    if (vy[i] < ymin) {
      ymin = vy[i];
      imin = i;
    }
    ymax = std::max(ymax, vy[i]);
    xmax = std::max(xmax, vx[i]);
    xmin = std::min(xmin, vx[i]);
    line2(cv, px, py, vx[i], vy[i]);
    px = vx[i];
    py = vy[i];
  }
  xmin = (xmin + delta) >> kXYShift;
  xmax = (xmax + delta) >> kXYShift;
  ymin = (ymin + delta) >> kXYShift;
  ymax = (ymax + delta) >> kXYShift;
  if (npts < 3 || static_cast<int>(xmax) < 0 || static_cast<int>(ymax) < 0 ||
      static_cast<int>(xmin) >= cv.w || static_cast<int>(ymin) >= cv.h) {
    return;
  }
  ymax = std::min<int64_t>(ymax, cv.h - 1);
  edge[0].idx = edge[1].idx = imin;
  int y = static_cast<int>(ymin);
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -kXYOne;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        int ty = 0;
        for (; edges-- > 0;) {
          ty = static_cast<int>((vy[idx] + delta) >> kXYShift);
          if (ty > y) {
            const int64_t xs = vx[idx0], xe = vx[idx];
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (static_cast<int64_t>(ty) - y)) /
                         (2 * (static_cast<int64_t>(ty) - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) {
        left = 1;
        right = 0;
      }
      int xx1 = static_cast<int>((edge[left].x + delta1) >> kXYShift);
      int xx2 = static_cast<int>((edge[right].x + delta2) >> kXYShift);
      if (xx2 >= 0 && xx1 < cv.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= cv.w) xx2 = cv.w - 1;
        cv.hline(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= static_cast<int>(ymax));
}

// OpenCV's Circle with fill
void filled_circle(const Canvas& cv, int cx, int cy, int radius) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  while (dx >= dy) {
    const int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (x11 < cv.w && x12 >= 0 && y21 < cv.h && y22 >= 0) {
      x11 = std::max(x11, 0);
      x12 = std::min(x12, cv.w - 1);
      if (static_cast<unsigned>(y11) < static_cast<unsigned>(cv.h)) {
        cv.hline(y11, x11, x12);
      }
      if (static_cast<unsigned>(y12) < static_cast<unsigned>(cv.h)) {
        cv.hline(y12, x11, x12);
      }
      if (x21 < cv.w && x22 >= 0) {
        x21 = std::max(x21, 0);
        x22 = std::min(x22, cv.w - 1);
        if (static_cast<unsigned>(y21) < static_cast<unsigned>(cv.h)) {
          cv.hline(y21, x21, x22);
        }
        if (static_cast<unsigned>(y22) < static_cast<unsigned>(cv.h)) {
          cv.hline(y22, x21, x22);
        }
      }
    }
    dy++;
    err += plus;
    plus += 2;
    const int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// OpenCV's ThickLine for thickness > 1, 8-connected, flags 2 (a disc at
// the end point only), integer end points
void thick_line(const Canvas& cv, int x0, int y0, int x1, int y1,
                int thickness) {
  const int64_t p0x = int64_t(x0) << kXYShift, p0y = int64_t(y0) << kXYShift;
  const int64_t p1x = int64_t(x1) << kXYShift, p1y = int64_t(y1) << kXYShift;
  const double inv = 1.0 / kXYOne;
  const double dx = (p0x - p1x) * inv, dy = (p1y - p0y) * inv;
  double r = dx * dx + dy * dy;
  const int odd = thickness & 1;
  const int64_t th = int64_t(thickness) << (kXYShift - 1);
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (th + odd * kXYOne * 0.5) / std::sqrt(r);
    const int64_t dpx = std::lrint(dy * r), dpy = std::lrint(dx * r);
    const int64_t vx[4] = {p0x + dpx, p0x - dpx, p1x - dpx, p1x + dpx};
    const int64_t vy[4] = {p0y + dpy, p0y - dpy, p1y - dpy, p1y + dpy};
    fill_convex_poly(cv, vx, vy, 4);
  }
  const int cx = static_cast<int>((p1x + (kXYOne >> 1)) >> kXYShift);
  const int cy = static_cast<int>((p1y + (kXYOne >> 1)) >> kXYShift);
  filled_circle(cv, cx, cy, static_cast<int>((th + (kXYOne >> 1)) >> kXYShift));
}

}  // namespace

extern "C" {

// uint8 HWC image -> float32 HWC, resized NEAREST_EXACT, value*scale+shift.
void resize_u8_to_f32(const uint8_t* src, int in_h, int in_w, int ch,
                      float* dst, int out_h, int out_w, float scale,
                      float shift) {
  std::vector<int32_t> rows(out_h), cols(out_w);
  nearest_indices(in_h, out_h, rows.data());
  nearest_indices(in_w, out_w, cols.data());
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const uint8_t* src_row = src + static_cast<int64_t>(rows[y]) * in_w * ch;
    float* dst_row = dst + static_cast<int64_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const uint8_t* p = src_row + static_cast<int64_t>(cols[x]) * ch;
      float* q = dst_row + static_cast<int64_t>(x) * ch;
      for (int c = 0; c < ch; ++c) {
        q[c] = static_cast<float>(p[c]) * scale + shift;
      }
    }
  }
}

// uint16 single-channel raster -> float32, value*scale.
void resize_u16_to_f32(const uint16_t* src, int in_h, int in_w, float* dst,
                       int out_h, int out_w, float scale) {
  std::vector<int32_t> rows(out_h), cols(out_w);
  nearest_indices(in_h, out_h, rows.data());
  nearest_indices(in_w, out_w, cols.data());
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const uint16_t* src_row = src + static_cast<int64_t>(rows[y]) * in_w;
    float* dst_row = dst + static_cast<int64_t>(y) * out_w;
    for (int x = 0; x < out_w; ++x) {
      dst_row[x] = static_cast<float>(src_row[cols[x]]) * scale;
    }
  }
}

// float32 HWC -> float32 HWC NEAREST_EXACT.
void resize_f32(const float* src, int in_h, int in_w, int ch, float* dst,
                int out_h, int out_w) {
  std::vector<int32_t> rows(out_h), cols(out_w);
  nearest_indices(in_h, out_h, rows.data());
  nearest_indices(in_w, out_w, cols.data());
#pragma omp parallel for schedule(static)
  for (int y = 0; y < out_h; ++y) {
    const float* src_row = src + static_cast<int64_t>(rows[y]) * in_w * ch;
    float* dst_row = dst + static_cast<int64_t>(y) * out_w * ch;
    for (int x = 0; x < out_w; ++x) {
      const float* p = src_row + static_cast<int64_t>(cols[x]) * ch;
      float* q = dst_row + static_cast<int64_t>(x) * ch;
      for (int c = 0; c < ch; ++c) q[c] = p[c];
    }
  }
}

// dst[y, x] = src[rows[y], cols[x]] for pixels of `px_bytes` bytes.
void gather_rows_cols(const uint8_t* src, int in_w, int px_bytes,
                      const int64_t* rows, int out_h, const int64_t* cols,
                      int out_w, uint8_t* dst) {
  const int64_t in_row = static_cast<int64_t>(in_w) * px_bytes;
  const int64_t out_row = static_cast<int64_t>(out_w) * px_bytes;
#pragma omp parallel for schedule(static) if (static_cast<int64_t>(out_h) * out_w > 65536)
  for (int y = 0; y < out_h; ++y) {
    const uint8_t* s = src + rows[y] * in_row;
    uint8_t* d = dst + y * out_row;
    for (int x = 0; x < out_w; ++x) {
      std::memcpy(d + static_cast<int64_t>(x) * px_bytes,
                  s + cols[x] * px_bytes, px_bytes);
    }
  }
}

// PIL BILINEAR Image.resize of a uint8 image with `ch` interleaved channels.
void resize_bilinear_u8(const uint8_t* src, int in_h, int in_w, int ch,
                        uint8_t* dst, int out_h, int out_w) {
  resample<uint8_t>(src, in_h, in_w, ch, dst, out_h, out_w,
                           pass_u8<kBilinear>);
}

// PIL BICUBIC Image.resize of a uint8 image with `ch` interleaved channels.
void resize_bicubic_u8(const uint8_t* src, int in_h, int in_w, int ch,
                       uint8_t* dst, int out_h, int out_w) {
  resample<uint8_t>(src, in_h, in_w, ch, dst, out_h, out_w,
                           pass_u8<kBicubic>);
}

// PIL BICUBIC Image.resize of an "I;16" image (one uint16 channel).
void resize_bicubic_u16(const uint16_t* src, int in_h, int in_w,
                        uint16_t* dst, int out_h, int out_w) {
  resample<uint16_t>(src, in_h, in_w, 1, dst, out_h, out_w, pass_u16);
}

// PIL BILINEAR Image.resize of a float32 ("F") image.
void resize_bilinear_f32(const float* src, int in_h, int in_w, int ch,
                         float* dst, int out_h, int out_w) {
  resample<float>(src, in_h, in_w, ch, dst, out_h, out_w, pass_f32);
}

// findContours(RETR_TREE, CHAIN_APPROX_SIMPLE) of a mask (nonzero =
// object). Returns a handle; contours_size / contours_copy read it out,
// contours_free releases it.
void* contours_find(const uint8_t* mask, int h, int w) {
  Contours* c = new Contours();
  find_contours(mask, h, w, c);
  return c;
}

void contours_size(void* handle, int64_t* n_contours, int64_t* n_points) {
  const Contours* c = static_cast<Contours*>(handle);
  *n_contours = static_cast<int64_t>(c->lens.size());
  *n_points = static_cast<int64_t>(c->xy.size() / 2);
}

void contours_copy(void* handle, int32_t* lens, int32_t* xy) {
  const Contours* c = static_cast<Contours*>(handle);
  std::copy(c->lens.begin(), c->lens.end(), lens);
  std::copy(c->xy.begin(), c->xy.end(), xy);
}

void contours_free(void* handle) { delete static_cast<Contours*>(handle); }

// drawContours(img, contours, -1, color, thickness) with LINE_8 on a uint8
// HWC image; thickness > 1.
void draw_contours(uint8_t* img, int h, int w, int ch, const int32_t* lens,
                   int n_contours, const int32_t* xy, const uint8_t* color,
                   int thickness) {
  const Canvas cv{img, w, h, ch, color};
  int64_t off = 0;
  for (int c = 0; c < n_contours; ++c) {
    const int n = lens[c];
    const int32_t* p = xy + 2 * off;
    for (int j = 0; j < n; ++j) {
      const int k = j == n - 1 ? 0 : j + 1;
      thick_line(cv, p[2 * j], p[2 * j + 1], p[2 * k], p[2 * k + 1],
                 thickness);
    }
    off += n;
  }
}

// The two together on a mask: the contours of `mask` drawn on `img`.
void draw_mask_contours(uint8_t* img, int h, int w, int ch,
                        const uint8_t* mask, const uint8_t* color,
                        int thickness) {
  Contours c;
  find_contours(mask, h, w, &c);
  draw_contours(img, h, w, ch, c.lens.data(),
                static_cast<int>(c.lens.size()), c.xy.data(), color,
                thickness);
}

}  // extern "C"
