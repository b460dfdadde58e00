// Host image codec for the port's loaders, server and CLIs: PNG decode and
// the PNG encoder's row filters, written here; JPEG decode through libjpeg
// where its header is found, else through the baseline decoder written
// here (libjpeg's integer IDCT, fancy upsampling and colour tables: the
// same pixels).
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

// ------------------------------------------------------- baseline JPEG
// A baseline (sequential, Huffman, 8-bit) JPEG decoder that gives the
// pixels libjpeg(-turbo) gives under PIL's defaults, bit for bit: its
// Huffman decoding and restart handling, its integer "islow" IDCT (with
// its range-limit table), its "fancy" h2v1 / h2v2 chroma upsampling (box
// where a component is at most 2 samples wide), and its YCbCr -> RGB
// tables. Used where libjpeg is not linked. Progressive, arithmetic-coded,
// lossless and hierarchical files, 12-bit samples, CMYK and other
// subsamplings are refused by code (see jpeg_baseline_probe).

const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // past the end: libjpeg's guard entries for corrupt run lengths
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum {
  kJpegOk = 0, kJpegNotJpeg = 1, kJpegMalformed = 3, kJpegComponents = 4,
  kJpegProgressive = 6, kJpegArithmetic = 7, kJpegLossless = 8,
  kJpegPrecision = 9, kJpegSampling = 10
};

struct Huff {
  bool defined = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
};

void build_huff(const uint8_t* bits, const uint8_t* vals, int nvals, Huff* t) {
  std::memcpy(t->vals, vals, nvals);
  int32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t->valoffset[l] = p - code;
      p += bits[l - 1];
      code += bits[l - 1];
      t->maxcode[l] = code - 1;
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;   // sentinel
  t->valoffset[17] = 0;
  t->defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;      // blocks in the plane (padded to whole MCUs)
  int dsw = 0, dsh = 0;    // libjpeg's downsampled_width / _height
  std::vector<uint8_t> plane;
  int dc = 0;
};

struct Jpeg {
  int w = 0, h = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  Component comp[4];
  int32_t qt[4][64];
  Huff dc[4], ac[4];
  int mcux = 0, mcuy = 0;
};

struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int cnt = 0;
  bool marker = false;   // reached a marker: zeros from here, as libjpeg

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;   // fill bytes
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            marker = true;
            pos = q - 1;       // at the marker's 0xFF
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    const int v = int(acc >> (64 - k));
    acc <<= k;
    cnt -= k;
    return v;
  }
  // libjpeg's process_restart: drop the buffered bits, skip to and past
  // the next RSTn marker
  void restart() {
    acc = 0;
    cnt = 0;
    marker = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
        pos += 2;
        return;
      }
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF) return;
      ++pos;
    }
  }
};

inline int huff_decode(Bits& br, const Huff& t) {
  int32_t code = br.get(1);
  int l = 1;
  while (code > t.maxcode[l]) {
    code = (code << 1) | br.get(1);
    if (++l > 16) return 0;   // bad code: libjpeg's zero
  }
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x + int((~0u << s) + 1) : x;
}

// libjpeg's jpeg_idct_islow (jidctint.c), 8-bit samples
constexpr int kConstBits = 13, kPass1Bits = 2;
inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}
inline uint8_t idct_limit(int64_t v) {
  const int y = int(v) & 1023;       // RANGE_MASK
  const int s = y < 512 ? y : y - 1024;
  return uint8_t(s + 128 < 0 ? 0 : s + 128 > 255 ? 255 : s + 128);
}

void idct_islow(const int16_t* coef, const int32_t* q, uint8_t* out,
                int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int32_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int dc = (int(in[0]) * qq[0]) * (1 << kPass1Bits);
      for (int k = 0; k < 8; ++k) w[8 * k] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qq[16], z3 = int64_t(in[48]) * qq[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = int64_t(in[0]) * qq[0];
    z3 = int64_t(in[32]) * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qq[56];
    tmp1 = int64_t(in[40]) * qq[40];
    tmp2 = int64_t(in[24]) * qq[24];
    tmp3 = int64_t(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, sh));
    w[56] = int(descale(tmp10 - tmp3, sh));
    w[8] = int(descale(tmp11 + tmp2, sh));
    w[48] = int(descale(tmp11 - tmp2, sh));
    w[16] = int(descale(tmp12 + tmp1, sh));
    w[40] = int(descale(tmp12 - tmp1, sh));
    w[24] = int(descale(tmp13 + tmp0, sh));
    w[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + size_t(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int k = 0; k < 8; ++k) o[k] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

inline uint16_t be16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }

int decode_block(Bits& br, Jpeg& J, Component& c, int bx, int by) {
  int16_t blk[64] = {0};
  const int s = huff_decode(br, J.dc[c.td]);
  int diff = 0;
  if (s) diff = extend(br.get(s), s);
  c.dc += diff;
  blk[0] = int16_t(c.dc);
  const Huff& act = J.ac[c.ta];
  for (int k = 1; k < 64; ++k) {
    int rs = huff_decode(br, act);
    const int r = rs >> 4;
    rs &= 15;
    if (rs) {
      k += r;
      blk[kZigzag[k]] = int16_t(extend(br.get(rs), rs));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  if (bx < c.bw && by < c.bh) {
    const int stride = c.bw * 8;
    idct_islow(blk, J.qt[c.tq], c.plane.data() + size_t(by) * 8 * stride +
               size_t(bx) * 8, stride);
  }
  return 0;
}

int decode_scan(const uint8_t* buf, size_t n, size_t& pos, Jpeg& J,
                const int* members, int ns) {
  for (int i = 0; i < ns; ++i) {
    Component& c = J.comp[members[i]];
    if (!J.dc[c.td].defined || !J.ac[c.ta].defined) return kJpegMalformed;
    c.dc = 0;
  }
  Bits br{buf, n, pos};
  int mx, my;
  if (ns == 1) {
    const Component& c = J.comp[members[0]];
    mx = (c.dsw + 7) / 8;
    my = (c.dsh + 7) / 8;
  } else {
    mx = J.mcux;
    my = J.mcuy;
  }
  int todo = J.restart;
  for (int y = 0; y < my; ++y) {
    for (int x = 0; x < mx; ++x) {
      if (J.restart) {
        if (todo == 0) {
          br.restart();
          for (int i = 0; i < ns; ++i) J.comp[members[i]].dc = 0;
          todo = J.restart;
        }
        --todo;
      }
      if (ns == 1) {
        decode_block(br, J, J.comp[members[0]], x, y);
        continue;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = J.comp[members[i]];
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h)
            decode_block(br, J, c, x * c.h + h, y * c.v + v);
      }
    }
  }
  // on to the next marker
  pos = br.pos;
  while (pos + 1 < n && !(buf[pos] == 0xFF && buf[pos + 1] != 0x00 &&
                          buf[pos + 1] != 0xFF &&
                          !(buf[pos + 1] >= 0xD0 && buf[pos + 1] <= 0xD7)))
    ++pos;
  return kJpegOk;
}

// The markers up to the first SOS (`decode` false) or the whole file.
int jpeg_read(const uint8_t* buf, size_t n, Jpeg& J, bool decode) {
  if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kJpegNotJpeg;
  size_t pos = 2;
  int scans = 0;
  while (pos + 4 <= n) {
    if (buf[pos] != 0xFF) { ++pos; continue; }
    const int m = buf[pos + 1];
    if (m == 0xFF) { ++pos; continue; }
    pos += 2;
    if (m == 0xD9) break;                           // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (pos + 2 > n) return kJpegMalformed;
    const size_t len = be16(buf + pos);
    if (len < 2 || pos + len > n) return kJpegMalformed;
    const uint8_t* p = buf + pos + 2;
    const size_t L = len - 2;
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
      return kJpegProgressive;
    if (m == 0xC9 || m == 0xCC || m == 0xCD) return kJpegArithmetic;
    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
      return kJpegLossless;
    if (m == 0xC5 || m == 0xDE || m == 0xDF) return kJpegLossless;
    if (m == 0xC0 || m == 0xC1) {
      if (L < 6) return kJpegMalformed;
      if (p[0] != 8) return kJpegPrecision;
      J.h = be16(p + 1);
      J.w = be16(p + 3);
      J.ncomp = p[5];
      if (J.ncomp != 1 && J.ncomp != 3) return kJpegComponents;
      if (J.w <= 0 || J.h <= 0 || L < size_t(6 + 3 * J.ncomp))
        return kJpegMalformed;
      J.hmax = J.vmax = 1;
      for (int i = 0; i < J.ncomp; ++i) {
        Component& c = J.comp[i];
        c.id = p[6 + 3 * i];
        c.h = p[7 + 3 * i] >> 4;
        c.v = p[7 + 3 * i] & 15;
        c.tq = p[8 + 3 * i] & 3;
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kJpegMalformed;
        J.hmax = c.h > J.hmax ? c.h : J.hmax;
        J.vmax = c.v > J.vmax ? c.v : J.vmax;
      }
      J.mcux = (J.w + 8 * J.hmax - 1) / (8 * J.hmax);
      J.mcuy = (J.h + 8 * J.vmax - 1) / (8 * J.vmax);
      for (int i = 0; i < J.ncomp; ++i) {
        Component& c = J.comp[i];
        const int rh = J.hmax / c.h, rv = J.vmax / c.v;
        if (J.hmax % c.h || J.vmax % c.v || !((rh == 1 && rv == 1) ||
            (rh == 2 && rv == 1) || (rh == 2 && rv == 2)))
          return kJpegSampling;
        c.dsw = int((int64_t(J.w) * c.h + J.hmax - 1) / J.hmax);
        c.dsh = int((int64_t(J.h) * c.v + J.vmax - 1) / J.vmax);
        c.bw = J.mcux * c.h;
        c.bh = J.mcuy * c.v;
      }
      J.frame = true;
      if (!decode) return kJpegOk;
      for (int i = 0; i < J.ncomp; ++i) {
        Component& c = J.comp[i];
        c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
      }
    } else if (m == 0xDB) {                          // DQT
      size_t k = 0;
      while (k < L) {
        const int pq = p[k] >> 4, tq = p[k] & 3;
        ++k;
        if (k + (pq ? 128 : 64) > L) return kJpegMalformed;
        for (int i = 0; i < 64; ++i) {
          J.qt[tq][kZigzag[i]] = pq ? be16(p + k + 2 * i) : p[k + i];
        }
        k += pq ? 128 : 64;
      }
    } else if (m == 0xC4) {                          // DHT
      size_t k = 0;
      while (k + 17 <= L) {
        const int tc = p[k] >> 4, th = p[k] & 3;
        const uint8_t* bits = p + k + 1;
        int total = 0;
        for (int i = 0; i < 16; ++i) total += bits[i];
        if (total > 256 || k + 17 + total > L) return kJpegMalformed;
        build_huff(bits, p + k + 17, total, tc ? &J.ac[th] : &J.dc[th]);
        k += 17 + total;
      }
    } else if (m == 0xDD) {                          // DRI
      if (L < 2) return kJpegMalformed;
      J.restart = be16(p);
    } else if (m == 0xE0) {
      if (L >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) J.jfif = true;
    } else if (m == 0xEE) {
      if (L >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
        J.adobe = true;
        J.adobe_transform = p[11];
      }
    } else if (m == 0xDA) {                          // SOS
      if (!J.frame) return kJpegMalformed;
      if (!decode) return kJpegOk;
      const int ns = p[0];
      if (ns < 1 || ns > J.ncomp || L < size_t(1 + 2 * ns + 3))
        return kJpegMalformed;
      int members[4];
      for (int i = 0; i < ns; ++i) {
        const int cid = p[1 + 2 * i];
        int idx = -1;
        for (int j = 0; j < J.ncomp; ++j)
          if (J.comp[j].id == cid) idx = j;
        if (idx < 0) return kJpegMalformed;
        members[i] = idx;
        J.comp[idx].td = p[2 + 2 * i] >> 4 & 3;
        J.comp[idx].ta = p[2 + 2 * i] & 3;
      }
      pos += len;
      const int rc = decode_scan(buf, n, pos, J, members, ns);
      if (rc) return rc;
      ++scans;
      continue;
    }
    pos += len;
  }
  if (!J.frame) return kJpegMalformed;
  if (decode && !scans) return kJpegMalformed;
  return kJpegOk;
}

// one component's full-size samples for output row y (libjpeg's upsampler)
void upsample_row(const Jpeg& J, const Component& c, int y, uint8_t* out) {
  const int rh = J.hmax / c.h, rv = J.vmax / c.v;
  const int stride = c.bw * 8;
  const uint8_t* base = c.plane.data();
  if (rh == 1) {
    std::memcpy(out, base + size_t(y) * stride, J.w);
    return;
  }
  const int W = c.dsw;
  const bool fancy = W > 2;
  if (rv == 1) {                                    // h2v1
    const uint8_t* in = base + size_t(y) * stride;
    for (int x = 0; x < J.w; ++x) {
      const int i = x >> 1;
      if (!fancy) { out[x] = in[i]; continue; }
      const int v3 = in[i] * 3;
      if (!(x & 1))
        out[x] = uint8_t(i == 0 ? in[0] : (v3 + in[i - 1] + 1) >> 2);
      else
        out[x] = uint8_t(i == W - 1 ? in[i] : (v3 + in[i + 1] + 2) >> 2);
    }
    return;
  }
  const int r = y >> 1;                              // h2v2
  if (!fancy) {
    const uint8_t* in = base + size_t(r) * stride;
    for (int x = 0; x < J.w; ++x) out[x] = in[x >> 1];
    return;
  }
  int nb = (y & 1) ? r + 1 : r - 1;
  nb = nb < 0 ? 0 : nb > c.dsh - 1 ? c.dsh - 1 : nb;
  const uint8_t* in0 = base + size_t(r) * stride;
  const uint8_t* in1 = base + size_t(nb) * stride;
  auto colsum = [&](int i) { return in0[i] * 3 + in1[i]; };
  for (int x = 0; x < J.w; ++x) {
    const int i = x >> 1;
    const int t = colsum(i);
    if (!(x & 1))
      out[x] = uint8_t(i == 0 ? (t * 4 + 8) >> 4
                              : (t * 3 + colsum(i - 1) + 8) >> 4);
    else
      out[x] = uint8_t(i == W - 1 ? (t * 4 + 7) >> 4
                                  : (t * 3 + colsum(i + 1) + 7) >> 4);
  }
}

bool jpeg_is_rgb(const Jpeg& J) {
  if (J.ncomp != 3) return false;
  if (J.jfif) return false;
  if (J.adobe) return J.adobe_transform == 0;
  return J.comp[0].id == 82 && J.comp[1].id == 71 && J.comp[2].id == 66;
}

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

void ycc_to_rgb(const uint8_t* yy, const uint8_t* cb, const uint8_t* cr,
                int w, uint8_t* out) {
  // libjpeg's build_ycc_rgb_table (jdcolor.c), SCALEBITS 16
  static int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  static bool built = false;
  if (!built) {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int32_t((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int32_t((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = int32_t(-fix(0.71414) * x);
      cb_g[i] = int32_t(-fix(0.34414) * x + one_half);
    }
    built = true;
  }
  for (int x = 0; x < w; ++x) {
    const int Y = yy[x], b = cb[x], r = cr[x];
    out[3 * x] = clamp255(Y + cr_r[r]);
    out[3 * x + 1] = clamp255(Y + int((int64_t(cb_g[b]) + cr_g[r]) >> 16));
    out[3 * x + 2] = clamp255(Y + cb_b[b]);
  }
}

int jpeg_baseline_decode_into(const uint8_t* buf, size_t n, uint8_t* out) {
  Jpeg J;
  int rc = jpeg_read(buf, n, J, true);
  if (rc) return rc;
  if (J.ncomp == 1) {
    for (int y = 0; y < J.h; ++y)
      upsample_row(J, J.comp[0], y, out + size_t(y) * J.w);
    return kJpegOk;
  }
  std::vector<uint8_t> rows(size_t(3) * J.w);
  const bool rgb = jpeg_is_rgb(J);
  for (int y = 0; y < J.h; ++y) {
    for (int c = 0; c < 3; ++c)
      upsample_row(J, J.comp[c], y, rows.data() + size_t(c) * J.w);
    uint8_t* o = out + size_t(y) * J.w * 3;
    if (rgb) {
      for (int x = 0; x < J.w; ++x)
        for (int c = 0; c < 3; ++c) o[3 * x + c] = rows[size_t(c) * J.w + x];
    } else {
      ycc_to_rgb(rows.data(), rows.data() + J.w, rows.data() + 2 * J.w, J.w,
                 o);
    }
  }
  return kJpegOk;
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

// The baseline decoder's header: 0 on success, 1 not a JPEG, 3 malformed,
// 4 not 1 or 3 components, 6 progressive, 7 arithmetic-coded, 8 lossless
// or hierarchical, 9 not 8-bit, 10 a subsampling other than 4:4:4, 4:2:2
// and 4:2:0.
int jpeg_baseline_probe(const uint8_t* buf, size_t n, int* h, int* w,
                        int* channels) {
  Jpeg J;
  const int rc = jpeg_read(buf, n, J, false);
  if (rc) return rc;
  *h = J.h;
  *w = J.w;
  *channels = J.ncomp;
  return 0;
}

// Decode into `out` ([h, w, channels] uint8, the probe's sizes); the
// probe's codes.
int jpeg_baseline_decode(const uint8_t* buf, size_t n, uint8_t* out) {
  return jpeg_baseline_decode_into(buf, n, out);
}

}  // extern "C"
