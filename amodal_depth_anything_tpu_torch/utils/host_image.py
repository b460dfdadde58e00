"""Host-side PNG codec and resizes for the HTTP server, in numpy.

The JAX package's `cli/serve.py` decodes, encodes and resizes with PIL. The
card's machine has no PIL, and the port's server must run there, so these
are numpy versions of exactly what that code asks PIL for:

  * `decode_png`: a PNG as `np.asarray(Image.open(...))` gives it (8-bit
    gray, gray + alpha, RGB, RGBA and palette indices, 16-bit gray as
    uint16, 16-bit colour cut to its high byte, 1-bit gray as bool;
    non-interlaced);
  * `encode_png`: uint8 gray / RGB / RGBA or uint16 gray, each row
    filtered as PIL's encoder chooses, so its bytes are what a Python
    client sends (Paeth rows for textured images, Up and Sub for smooth
    ones; libpng's clients add Average rows, which `decode_png` takes too);
  * `resize_bilinear`: `Image.resize(size, BILINEAR)` of a uint8 L / RGB
    image (PIL's convolution resampler: a triangle filter widened by the
    scale when downsizing, 22-bit fixed-point coefficients, horizontal pass
    then vertical) or of a float32 "F" image (double coefficients, each
    pass rounded to float32);
  * `resize_bicubic`: `Image.resize(size, BICUBIC)`, PIL's default filter,
    of a uint8 L / RGB image (the same resampler with the cubic filter,
    a = -0.5, support 2; 22-bit fixed point) or of a uint16 "I;16" image
    (double coefficients, each pass rounded half away from zero and stored
    as Pillow stores a 16-bit sample: the low and the high byte each
    clipped to 0..255 on their own, so an overshoot past 65535 keeps its
    low byte under a high byte of 255, and any negative value is 0);
  * `resize_nearest`: `Image.resize(size, NEAREST)` (source pixel
    floor((x + 0.5) * scale), the scale summed step by step as PIL does).

Each takes the native route where the host library is built (`native`:
the C++ codec `native.imagecodec` for the decode and the encoder's row
filters, `native.resize_bilinear`, `native.resize_bicubic` and
`native.gather` for the resizes; ctypes releases the GIL, so request
threads work in parallel) and its numpy plain version otherwise
(`decode_png_plain`, `_filter_rows`, `resize_bilinear_plain`,
`resize_bicubic_plain`, `resize_nearest_plain`; `native.plain_route()`
forces them). Both routes give the same bits. tests/test_torch_server.py
holds each against PIL, bit for bit, and tests/test_torch_native.py the
two routes against each other.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib

import numpy as np

from .. import native
from ..native import imagecodec

__all__ = ["PNG_SIGNATURE", "decode_png", "decode_png_plain", "encode_png",
           "resize_bilinear", "resize_bilinear_plain", "resize_bicubic",
           "resize_bicubic_plain", "resize_nearest",
           "resize_nearest_plain"]

PNG_SIGNATURE = _SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples
_PRECISION_BITS = 32 - 8 - 2                 # PIL's fixed-point coefficients


# ----------------------------------------------------------------- PNG

def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left `a`, up `b` and up-left `c` (int16)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth).

    Rows of None, Sub and Up only are undone row after row, each row at
    once. Average and Paeth make every byte depend on the byte `bpp` to its
    left, so an image with such rows is undone along anti-diagonals: pixel
    (y, x) needs (y, x-1), (y-1, x) and (y-1, x-1), which all lie on earlier
    diagonals, so each of the w + h - 1 steps takes one diagonal of every
    row at once."""
    rows = raw.reshape(h, stride + 1)
    kinds = rows[:, 0].astype(np.int16)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {kinds.max()}")
    if kinds.max(initial=0) <= 2:
        out = np.zeros((h, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for y in range(h):
            line = rows[y, 1:]
            if kinds[y] == 1:     # Sub: a running sum along each byte lane
                line = np.cumsum(line.reshape(-1, bpp), axis=0,
                                 dtype=np.uint8).reshape(-1)
            elif kinds[y] == 2:
                line = line + prior
            out[y] = line
            prior = out[y]
        return out
    n = stride // bpp
    y = np.arange(h)[:, None]
    diag = np.arange(n)[None, :] + y          # pixel (y, x) -> diagonal x + y
    lines = np.zeros((n + h - 1, h, bpp), np.int16)
    lines[diag, y] = rows[:, 1:].reshape(h, n, bpp)
    # done[2 + t, 1 + y]: row y's pixel on diagonal t (diagonal-major, so
    # each step reads and writes contiguous slices); zeros above row 0 and
    # left of pixel 0, as the filters read them
    done = np.zeros((n + h + 1, h + 1, bpp), np.int16)
    # Sub/Up/Average as (wa * a + wb * b) >> sh; Paeth chosen per row
    wa = np.isin(kinds, (1, 3)).astype(np.int16)[:, None]
    wb = np.isin(kinds, (2, 3)).astype(np.int16)[:, None]
    sh = (kinds == 3).astype(np.int16)[:, None]
    paeth = (kinds == 4)[:, None]
    paeth_upto = np.concatenate([[0], np.cumsum(kinds == 4)])
    for t in range(n + h - 1):
        y0, y1 = max(0, t - n + 1), min(h, t + 1)
        a = done[t + 1, y0 + 1:y1 + 1]
        b = done[t + 1, y0:y1]
        pred = (wa[y0:y1] * a + wb[y0:y1] * b) >> sh[y0:y1]
        if paeth_upto[y1] > paeth_upto[y0]:
            pred = np.where(paeth[y0:y1], _paeth(a, b, done[t, y0:y1]), pred)
        pred += lines[t, y0:y1]
        pred &= 0xFF
        done[t + 2, y0 + 1:y1 + 1] = pred
    return done[2 + diag, 1 + y].astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the array `np.asarray(PIL.Image.open(...))` gives: the
    native codec where it takes the PNG (it rejects palette, sub-8-bit and
    tRNS files), else `decode_png_plain`."""
    if imagecodec.available():
        px = imagecodec.decode_png(data)
        if px is not None:
            # PIL keeps 16-bit gray and cuts 16-bit colour to its high byte
            if px.dtype == np.uint16 and px.ndim == 3:
                px = (px >> 8).astype(np.uint8)
            return px
    return decode_png_plain(data)


def decode_png_plain(data: bytes) -> np.ndarray:
    """`decode_png` in numpy (non-interlaced PNGs)."""
    if not data.startswith(_SIG):
        raise ValueError("not a PNG")
    pos, idat, ihdr = len(_SIG), [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if color not in _CHANNELS or not (
            depth in (8, 16) and not (color == 3 and depth == 16)
            or depth == 1 and color == 0):
        raise ValueError(f"unsupported PNG: colour type {color}, "
                         f"{depth}-bit")
    ch = _CHANNELS[color]
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = _unfilter(raw, h, stride, bpp)
    if depth == 1:
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if depth == 16:
        px = rows.view(">u2").reshape(h, w, ch)
        # PIL keeps 16-bit gray and cuts 16-bit colour to its high byte
        px = px.astype(np.uint16) if ch == 1 else (px >> 8).astype(np.uint8)
    else:
        px = rows.reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter each row as PIL's encoder does: of None, Up, Sub and
    Paeth, tried in that order, the first whose bytes, read as signed, sum
    smallest in magnitude (PIL tries Average too only under `optimize`).
    Returns the rows with their filter-type byte in front."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up_left = np.zeros_like(x)
    up_left[:, bpp:] = up[:, :-bpp]
    kinds = np.array([0, 2, 1, 4])
    filtered = np.stack([x, x - up, x - left,
                         x - _paeth(left, up, up_left)]) & 0xFF
    best = np.minimum(filtered, 256 - filtered).sum(axis=2).argmin(axis=0)
    return np.concatenate([kinds[best][:, None],
                           filtered[best, np.arange(len(x))]],
                          axis=1).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 [H,W] / [H,W,3] / [H,W,4] or uint16 [H,W] -> PNG bytes, rows
    filtered as `_filter_rows` chooses."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        depth, rows = 16, arr.astype(">u2").view(np.uint8)
        ch = 1
    elif arr.dtype == np.uint8 and arr.ndim in (2, 3):
        ch = 1 if arr.ndim == 2 else arr.shape[2]
        depth, rows = 8, arr.reshape(arr.shape[0], -1)
    else:
        raise ValueError(f"cannot encode {arr.dtype} {arr.shape} as PNG")
    color = {1: 0, 3: 2, 4: 6}[ch]
    h, w = arr.shape[:2]
    rows, bpp = rows.reshape(h, -1), ch * depth // 8
    lines = (imagecodec.filter_rows(rows, bpp) if imagecodec.available()
             else _filter_rows(rows, bpp))
    return (_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 6))
            + _chunk(b"IEND", b""))


# -------------------------------------------------------------- resizes

def _triangle(t: float) -> float:
    t = abs(t)
    return 1.0 - t if t < 1.0 else 0.0


def _cubic(x: float) -> float:
    """PIL's bicubic_filter (a = -0.5)."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"bilinear": (_triangle, 1.0), "bicubic": (_cubic, 2.0)}


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int, kind: str = "bilinear"):
    """PIL's `precompute_coeffs` for the `kind` filter: per output pixel
    the first source pixel and the normalised weights, padded with zeros to
    one width. Returns (first [out], weights [out, k]), kept per size pair
    (read only)."""
    fn, filter_support = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww, ss = 0.0, 1.0 / filterscale
        for x in range(xmax):
            wt = fn((x + xmin - center + 0.5) * ss)
            weights[xx, x] = wt
            ww += wt
        if ww != 0.0:
            weights[xx, :xmax] /= ww
        first[xx] = xmin
    first.flags.writeable = weights.flags.writeable = False
    return first, weights


def _pass(img: np.ndarray, out_size: int, axis: int,
          kind: str = "bilinear") -> np.ndarray:
    """One PIL resampling pass along `axis` (0 rows, 1 columns), tap after
    tap over every output pixel at once."""
    first, weights = _coefficients(img.shape[axis], out_size, kind)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]),
                     img.shape[axis] - 1)
    shape = [1] * img.ndim
    shape[axis] = out_size
    if img.dtype == np.uint8:
        # 22-bit fixed-point weights; the sums stay below 2^31 as in PIL
        scaled = weights * (1 << _PRECISION_BITS)
        fixed = np.trunc(np.where(weights < 0, scaled - 0.5,
                                  scaled + 0.5)).astype(np.int32)
        ss = np.full(1, 1 << (_PRECISION_BITS - 1), np.int32)
        for j in range(weights.shape[1]):
            tap = np.take(img, idx[:, j], axis=axis).astype(np.int32)
            ss = ss + tap * fixed[:, j].reshape(shape)
        return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    # "F" and "I;16" images: double accumulation tap after tap
    ss = 0.0
    for j in range(weights.shape[1]):
        tap = np.take(img, idx[:, j], axis=axis).astype(np.float64)
        ss = ss + tap * weights[:, j].reshape(shape)
    if img.dtype == np.uint16:
        # ROUND_UP, then the low and the high byte clipped on their own
        v = np.where(ss >= 0, np.floor(ss + 0.5),
                     -np.floor(np.abs(ss) + 0.5)).astype(np.int64)
        lo = np.clip(np.fmod(v, 256), 0, 255)
        hi = np.clip(v >> 8, 0, 255)
        return (lo | (hi << 8)).astype(np.uint16)
    return np.asarray(ss, np.float32)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size, BILINEAR)` as an array: `img`
    uint8 [H,W] or [H,W,3], or float32 [H,W]; `size` = (width, height).
    The native resampler where it is built, else
    `resize_bilinear_plain`."""
    if native.available() and img.dtype in (np.uint8, np.float32):
        return native.resize_bilinear(img, size)
    return resize_bilinear_plain(img, size)


def resize_bilinear_plain(img: np.ndarray,
                          size: tuple[int, int]) -> np.ndarray:
    """`resize_bilinear` in numpy."""
    return _resample(img, size, "bilinear")


def _resample(img: np.ndarray, size: tuple[int, int],
              kind: str) -> np.ndarray:
    w, h = size
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, axis=1, kind=kind)
    if h != img.shape[0]:
        out = _pass(out, h, axis=0, kind=kind)
    return out if out is not img else img.copy()


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size)` (BICUBIC, PIL's default
    filter) as an array: `img` uint8 [H,W] or [H,W,3], or uint16 [H,W]
    (mode "I;16"); `size` = (width, height). The native resampler where it
    is built, else `resize_bicubic_plain`."""
    if native.available():
        return native.resize_bicubic(img, size)
    return resize_bicubic_plain(img, size)


def resize_bicubic_plain(img: np.ndarray,
                         size: tuple[int, int]) -> np.ndarray:
    """`resize_bicubic` in numpy."""
    if not (img.dtype == np.uint8 or (img.dtype == np.uint16
                                      and img.ndim == 2)):
        raise ValueError(f"resize_bicubic takes uint8 or 2-D uint16, got "
                         f"{img.dtype} {img.shape}")
    return _resample(img, size, "bicubic")


def _nearest_source(in_size: int, out_size: int, *,
                    direct: bool = False) -> np.ndarray:
    """PIL's affine nearest scaling: x0 = scale / 2, then += scale per
    pixel, summed in double precision step by step, truncated. PIL's
    16-bit ("I;16") images take another path, which computes each source
    directly, (x + 0.5) * scale in double, truncated (`direct`); the two
    part where the running sum's rounding crosses an integer."""
    scale = in_size / out_size
    if direct:
        src = ((np.arange(out_size) + 0.5) * scale).astype(np.int64)
    else:
        steps = np.full(out_size, scale)
        steps[0] = scale * 0.5
        src = np.add.accumulate(steps).astype(np.int64)
    return np.minimum(src, in_size - 1)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size, NEAREST)` as an array; `size`
    = (width, height). The gather runs natively where the library is
    built, else in numpy (`resize_nearest_plain`); the indices are the
    same."""
    return _resize_nearest(img, size, native.available())


def resize_nearest_plain(img: np.ndarray,
                         size: tuple[int, int]) -> np.ndarray:
    """`resize_nearest` in numpy."""
    return _resize_nearest(img, size, False)


def _resize_nearest(img, size, use_native: bool) -> np.ndarray:
    w, h = size
    if (h, w) == img.shape[:2]:
        return img.copy()
    direct = img.dtype == np.uint16 and img.ndim == 2   # PIL mode "I;16"
    rows = _nearest_source(img.shape[0], h, direct=direct)
    cols = _nearest_source(img.shape[1], w, direct=direct)
    if use_native:
        return native.gather(img, rows, cols)
    return img[rows][:, cols]
