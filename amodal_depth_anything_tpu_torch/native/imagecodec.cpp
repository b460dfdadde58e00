// Host image codec for the port's loaders, server and CLIs: PNG decode and
// the PNG encoder's row filters, written here; JPEG decode through libjpeg
// where its header is found.
//
// Plain C entry points called through ctypes (native/imagecodec.py), which
// releases the GIL for the length of the call, so request and prefetch
// threads decode in parallel on real cores. Decodes are raw, as
// `np.asarray(PIL.Image.open(...))` reads an 8-bit image and as the JAX
// package's codec reads a 16-bit one: no gamma, 16-bit samples byte-swapped
// to host order. Palette, sub-8-bit and tRNS PNGs are rejected (return 4),
// because PIL's arrays for those differ from the expanded samples; the
// caller then takes another route. Interlaced (Adam7) PNGs are decoded.
//
// The PNG stream is inflated with zlib where zlib.h is found
// (ADAT_HAVE_ZLIB, -lz); otherwise the caller inflates the IDAT payload
// (png_idat) itself and hands the raw rows to png_unfilter.
//
// Build (native/_build.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC imagecodec.cpp [-DADAT_HAVE_ZLIB -lz]
//       [-DADAT_HAVE_JPEG -ljpeg] -o libimagecodec.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef ADAT_HAVE_ZLIB
#include <zlib.h>
#endif
#ifdef ADAT_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngInfo {
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0, channels = 0;
  bool trns = false;
  size_t idat_len = 0;
};

const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};   // by colour type

// Walks the chunks: IHDR, tRNS, the IDAT total. 0 on success, 1 not a PNG,
// 3 malformed.
int png_parse(const uint8_t* buf, size_t n, PngInfo* info) {
  if (n < 8 || std::memcmp(buf, kSig, 8) != 0) return 1;
  size_t pos = 8;
  bool ihdr = false;
  while (pos + 8 <= n) {
    const uint32_t len = be32(buf + pos);
    const uint8_t* kind = buf + pos + 4;
    if (pos + 12 + size_t(len) > n) return 3;
    const uint8_t* body = buf + pos + 8;
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (len < 13) return 3;
      info->w = int(be32(body));
      info->h = int(be32(body + 4));
      info->depth = body[8];
      info->color = body[9];
      info->interlace = body[12];
      ihdr = true;
    } else if (std::memcmp(kind, "tRNS", 4) == 0) {
      info->trns = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      info->idat_len += len;
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + size_t(len);
  }
  if (!ihdr || info->w <= 0 || info->h <= 0) return 3;
  if (info->color > 6 || kChannels[info->color] == 0) return 3;
  info->channels = kChannels[info->color];
  return 0;
}

// 4 where PIL's array differs from the expanded samples
int png_supported(const PngInfo& info) {
  if (info.color == 3 || info.depth < 8 || info.trns) return 4;
  if (info.depth != 8 && info.depth != 16) return 3;
  if (info.interlace > 1) return 3;
  return 0;
}

struct Pass {
  int x0, y0, dx, dy;
};
const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                        {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                        {0, 1, 1, 2}};
const Pass kWhole = {0, 0, 1, 1};

inline int pass_size(int full, int start, int step) {
  return full > start ? (full - start + step - 1) / step : 0;
}

// bytes of filtered rows (each with its filter-type byte) the image holds
size_t raw_size(const PngInfo& info) {
  const int bytes = info.channels * info.depth / 8;
  size_t total = 0;
  const int n = info.interlace ? 7 : 1;
  for (int p = 0; p < n; ++p) {
    const Pass& ps = info.interlace ? kAdam7[p] : kWhole;
    const int pw = pass_size(info.w, ps.x0, ps.dx);
    const int ph = pass_size(info.h, ps.y0, ps.dy);
    if (pw == 0 || ph == 0) continue;
    total += size_t(ph) * (size_t(pw) * bytes + 1);
  }
  return total;
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

// Undoes the row filters of one (sub-)image in place: `rows` holds `h`
// rows of 1 + stride bytes. 0 on success, 3 on an unknown filter type.
int unfilter_rows(uint8_t* rows, int h, size_t stride, int bpp) {
  const uint8_t* prior = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* line = rows + size_t(y) * (stride + 1);
    const int kind = line[0];
    uint8_t* cur = line + 1;
    switch (kind) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < stride; ++i) cur[i] += cur[i - bpp];
        break;
      case 2:
        if (prior) {
          for (size_t i = 0; i < stride; ++i) cur[i] += prior[i];
        }
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          cur[i] += uint8_t((a + b) >> 1);
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= size_t(bpp)) ? prior[i - bpp] : 0;
          cur[i] += paeth(a, b, c);
        }
        break;
      default:
        return 3;
    }
    prior = cur;
  }
  return 0;
}

// raw (inflated) rows -> the image in `out` ([h, w, channels] samples,
// 16-bit ones in host order)
int unfilter_image(uint8_t* raw, size_t raw_len, const PngInfo& info,
                   uint8_t* out) {
  if (raw_len != raw_size(info)) return 3;
  const int bytes = info.channels * info.depth / 8;
  const int bpp = bytes < 1 ? 1 : bytes;
  const size_t out_stride = size_t(info.w) * bytes;
  const int n = info.interlace ? 7 : 1;
  size_t off = 0;
  for (int p = 0; p < n; ++p) {
    const Pass& ps = info.interlace ? kAdam7[p] : kWhole;
    const int pw = pass_size(info.w, ps.x0, ps.dx);
    const int ph = pass_size(info.h, ps.y0, ps.dy);
    if (pw == 0 || ph == 0) continue;
    const size_t stride = size_t(pw) * bytes;
    uint8_t* rows = raw + off;
    if (int rc = unfilter_rows(rows, ph, stride, bpp)) return rc;
    for (int y = 0; y < ph; ++y) {
      const uint8_t* src = rows + size_t(y) * (stride + 1) + 1;
      uint8_t* dst = out + size_t(ps.y0 + y * ps.dy) * out_stride;
      if (ps.dx == 1) {
        std::memcpy(dst, src, stride);
      } else {
        for (int x = 0; x < pw; ++x) {
          std::memcpy(dst + size_t(ps.x0 + x * ps.dx) * bytes,
                      src + size_t(x) * bytes, bytes);
        }
      }
    }
    off += size_t(ph) * (stride + 1);
  }
  if (info.depth == 16) {   // PNG is big-endian
    const size_t count = size_t(info.h) * info.w * info.channels;
    for (size_t i = 0; i < count; ++i) {
      std::swap(out[2 * i], out[2 * i + 1]);
    }
  }
  return 0;
}

void gather_idat(const uint8_t* buf, size_t n, uint8_t* out) {
  size_t pos = 8;
  while (pos + 8 <= n) {
    const uint32_t len = be32(buf + pos);
    const uint8_t* kind = buf + pos + 4;
    if (pos + 12 + size_t(len) > n) break;
    if (std::memcmp(kind, "IDAT", 4) == 0) {
      std::memcpy(out, buf + pos + 8, len);
      out += len;
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + size_t(len);
  }
}

#ifdef ADAT_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}
#endif

}  // namespace

extern "C" {

// bit 0: zlib inflates the PNG stream here; bit 1: JPEG through libjpeg
int codec_routes() {
  int routes = 0;
#ifdef ADAT_HAVE_ZLIB
  routes |= 1;
#endif
#ifdef ADAT_HAVE_JPEG
  routes |= 2;
#endif
  return routes;
}

// The header. 0 on success; 1 not a PNG, 3 malformed, 4 a format whose
// PIL array differs (palette, sub-8-bit, tRNS). `idat_len`: bytes of the
// compressed stream; `raw_len`: bytes it inflates to.
int png_probe(const uint8_t* buf, size_t n, int* h, int* w, int* channels,
              int* bit_depth, int* interlace, size_t* idat_len,
              size_t* raw_len) {
  PngInfo info;
  if (int rc = png_parse(buf, n, &info)) return rc;
  if (int rc = png_supported(info)) return rc;
  *h = info.h;
  *w = info.w;
  *channels = info.channels;
  *bit_depth = info.depth;
  *interlace = info.interlace;
  *idat_len = info.idat_len;
  *raw_len = raw_size(info);
  return 0;
}

// The IDAT payload, concatenated, into `out` (idat_len bytes).
int png_idat(const uint8_t* buf, size_t n, uint8_t* out) {
  PngInfo info;
  if (int rc = png_parse(buf, n, &info)) return rc;
  gather_idat(buf, n, out);
  return 0;
}

// Unfilters inflated rows (`raw`, modified in place) into `out`.
int png_unfilter(uint8_t* raw, size_t raw_len, const uint8_t* buf, size_t n,
                 uint8_t* out) {
  PngInfo info;
  if (int rc = png_parse(buf, n, &info)) return rc;
  if (int rc = png_supported(info)) return rc;
  return unfilter_image(raw, raw_len, info, out);
}

// The whole decode (zlib route only; 5 without it). `out`: h * w *
// channels * bit_depth / 8 bytes.
int png_decode(const uint8_t* buf, size_t n, uint8_t* out) {
#ifdef ADAT_HAVE_ZLIB
  PngInfo info;
  if (int rc = png_parse(buf, n, &info)) return rc;
  if (int rc = png_supported(info)) return rc;
  std::vector<uint8_t> z(info.idat_len);
  gather_idat(buf, n, z.data());
  const size_t want = raw_size(info);
  std::vector<uint8_t> raw(want);
  uLongf got = uLongf(want);
  if (uncompress(raw.data(), &got, z.data(), uLong(z.size())) != Z_OK ||
      got != want) {
    return 3;
  }
  return unfilter_image(raw.data(), want, info, out);
#else
  (void)buf;
  (void)n;
  (void)out;
  return 5;
#endif
}

// PNG-filters `h` rows of `stride` bytes as PIL's encoder chooses: of
// None, Up, Sub and Paeth, tried in that order, the first whose bytes,
// read as signed, sum smallest in magnitude. `out`: h * (stride + 1) bytes,
// each row led by its filter type.
void png_filter_rows(const uint8_t* rows, int h, size_t stride, int bpp,
                     uint8_t* out) {
  const int kinds[4] = {0, 2, 1, 4};
  std::vector<uint8_t> cand(4 * stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* x = rows + size_t(y) * stride;
    const uint8_t* up = y > 0 ? x - stride : nullptr;
    uint64_t best_sum = 0;
    int best = -1;
    for (int k = 0; k < 4; ++k) {
      uint8_t* f = cand.data() + size_t(k) * stride;
      uint64_t sum = 0;
      for (size_t i = 0; i < stride; ++i) {
        const int a = i >= size_t(bpp) ? x[i - bpp] : 0;
        const int b = up ? up[i] : 0;
        const int c = (up && i >= size_t(bpp)) ? up[i - bpp] : 0;
        int pred = 0;
        switch (kinds[k]) {
          case 2: pred = b; break;
          case 1: pred = a; break;
          case 4: pred = paeth(a, b, c); break;
          default: break;
        }
        const uint8_t v = uint8_t(x[i] - pred);
        f[i] = v;
        sum += v < 128 ? v : 256 - v;
      }
      if (best < 0 || sum < best_sum) {
        best = k;
        best_sum = sum;
      }
    }
    uint8_t* o = out + size_t(y) * (stride + 1);
    o[0] = uint8_t(kinds[best]);
    std::memcpy(o + 1, cand.data() + size_t(best) * stride, stride);
  }
}

// JPEG header: 0 on success, 1 not a JPEG, 3 malformed, 4 CMYK / YCCK,
// 5 no libjpeg here.
int jpeg_probe(const uint8_t* buf, size_t n, int* h, int* w, int* channels) {
  if (n < 2 || buf[0] != 0xFF || buf[1] != 0xD8) return 1;
#ifdef ADAT_HAVE_JPEG
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), n);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  *channels = cinfo.output_components;
  jpeg_destroy_decompress(&cinfo);
  return *channels > 3 ? 4 : 0;
#else
  (void)h;
  (void)w;
  (void)channels;
  return 5;
#endif
}

int jpeg_decode(const uint8_t* buf, size_t n, uint8_t* out) {
#ifdef ADAT_HAVE_JPEG
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), n);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  const size_t stride =
      static_cast<size_t>(cinfo.output_width) * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
#else
  (void)buf;
  (void)n;
  (void)out;
  return 5;
#endif
}

}  // extern "C"
