"""The host image codec in C++ (`imagecodec.cpp`), bound through ctypes.

The port's counterpart of the JAX package's `native/imagecodec.py`: `decode`
gives a PNG or JPEG as the JAX codec does (the array `np.asarray(PIL.Image.
open(...))` gives for 8-bit images; 16-bit samples raw, in host order), and
`filter_rows` filters PNG rows as PIL's encoder does
(`utils.host_image.encode_png`). Palette, sub-8-bit and tRNS PNGs are
rejected (None), as the JAX codec rejects them, and the caller takes its
other route. Interlaced PNGs decode.

The JAX codec links libpng and libjpeg. This one needs g++ alone for PNG:
the chunks, the row filters and Adam7 are written here, and the stream is
inflated by zlib where `zlib.h` is found, else by Python's `zlib.decompress`
between two calls (it releases the GIL too). JPEG goes through libjpeg where
`jpeglib.h` is found, else through the baseline decoder written in
`imagecodec.cpp` (`decode_jpeg_baseline`: the same pixels as PIL's
libjpeg-turbo; progressive and arithmetic-coded files are refused by name);
`routes()` says which routes were built. The library is built at first use
into `build/torch_native/` (`native/_build.py`); ctypes releases the GIL for
each call, so request and loader threads decode in parallel. `available()`
is false where it does not build and under `native.plain_route()`;
`require()` raises the build's error.
"""

from __future__ import annotations

import ctypes
import logging
import threading
import zlib

import numpy as np

from . import _build
from . import enabled as _native_enabled

__all__ = ["available", "require", "routes", "decode", "decode_png",
           "decode_jpeg_baseline", "filter_rows", "PNG_SIGNATURE"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
ROUTE_ZLIB, ROUTE_JPEG = 1, 2
_lib = None
_path = None
_error: str | None = None
_lock = threading.Lock()


def _variants():
    """Build variants, most capable first: zlib and libjpeg where their
    headers are found, then without them."""
    feats = []
    if _build.header_found("zlib.h"):
        feats.append(("-DADAT_HAVE_ZLIB", "-lz"))
    if _build.header_found("jpeglib.h"):
        feats.append(("-DADAT_HAVE_JPEG", "-ljpeg"))
    out = []
    for k in range(len(feats), -1, -1):
        use = feats[:k]
        out.append((tuple(f for f, _ in use), tuple(lb for _, lb in use)))
    return out


def _load():
    global _lib, _path, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib, extra = _build.load("imagecodec", _variants())
        except (_build.BuildError, OSError) as e:
            _error = str(e)
            logging.debug("native imagecodec unavailable: %s", e)
            return None
        bind(lib)
        _path = str(_build.library_path(
            "imagecodec", (*_build.BASE_FLAGS, *extra)))
        _lib = lib
    return _lib


def bind(lib) -> ctypes.CDLL:
    """Declare the entry points' argument and result types on a loaded
    library; returns it."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    sp = ctypes.POINTER(ctypes.c_size_t)
    sz = ctypes.c_size_t
    lib.codec_routes.restype = ctypes.c_int
    lib.png_probe.argtypes = [u8p, sz, ip, ip, ip, ip, ip, sp, sp]
    lib.png_idat.argtypes = [u8p, sz, u8p]
    lib.png_unfilter.argtypes = [u8p, sz, u8p, sz, u8p]
    lib.png_decode.argtypes = [u8p, sz, u8p]
    lib.png_filter_rows.argtypes = [u8p, ctypes.c_int, sz, ctypes.c_int,
                                    u8p]
    lib.png_filter_rows.restype = None
    lib.jpeg_probe.argtypes = [u8p, sz, ip, ip, ip]
    lib.jpeg_decode.argtypes = [u8p, sz, u8p]
    lib.jpeg_baseline_probe.argtypes = [u8p, sz, ip, ip, ip]
    lib.jpeg_baseline_decode.argtypes = [u8p, sz, u8p]
    for name in ("png_probe", "png_idat", "png_unfilter", "png_decode",
                 "jpeg_probe", "jpeg_decode", "jpeg_baseline_probe",
                 "jpeg_baseline_decode"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def available() -> bool:
    """Whether callers should take the native route (built and loaded, no
    `native.plain_route()` in force)."""
    return _native_enabled() and _load() is not None


def require() -> str:
    """Build and load the library or raise its build error; returns its
    path."""
    if _load() is None:
        raise _build.BuildError(_error)
    return _path


def routes() -> dict:
    """Which routes the built library has: {"png": "zlib" or
    "python-zlib", "jpeg": bool}."""
    require()
    flags = _lib.codec_routes()
    return {"png": "zlib" if flags & ROUTE_ZLIB else "python-zlib",
            "jpeg": bool(flags & ROUTE_JPEG)}


def _ptr(buf):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def _out_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_png(buf: bytes) -> np.ndarray | None:
    """PNG bytes -> [H,W] / [H,W,C] uint8 (or uint16 for 16-bit samples),
    or None where the library is missing or the PNG is rejected."""
    lib = _load()
    if lib is None or not buf.startswith(PNG_SIGNATURE):
        return None
    buf = bytes(buf)
    h, w, c, depth, interlace = (ctypes.c_int() for _ in range(5))
    idat_len, raw_len = ctypes.c_size_t(), ctypes.c_size_t()
    src = _ptr(buf)
    if lib.png_probe(src, len(buf), *(ctypes.byref(v) for v in (
            h, w, c, depth, interlace, idat_len, raw_len))):
        return None
    out = np.empty((h.value, w.value, c.value),
                   np.uint16 if depth.value == 16 else np.uint8)
    if lib.codec_routes() & ROUTE_ZLIB:
        if lib.png_decode(src, len(buf), _out_ptr(out)):
            return None
    else:
        stream = np.empty(idat_len.value, np.uint8)
        lib.png_idat(src, len(buf), _out_ptr(stream))
        try:
            raw = zlib.decompress(stream.tobytes())
        except zlib.error:
            return None
        if len(raw) != raw_len.value:
            return None
        rows = np.frombuffer(raw, np.uint8).copy()
        if lib.png_unfilter(_out_ptr(rows), rows.size, src, len(buf),
                            _out_ptr(out)):
            return None
    return out[..., 0] if c.value == 1 else out


def decode(buf: bytes) -> np.ndarray | None:
    """PNG or JPEG bytes -> [H,W] / [H,W,C] uint8 (or uint16 PNG), as the
    JAX package's codec gives them (JPEG through libjpeg where it was
    built, else through the baseline decoder); None where the library is
    missing or the format is rejected or unknown, so that the caller can
    take another route (`decode_jpeg_baseline` names a JPEG's refusal)."""
    lib = _load()
    if lib is None or len(buf) < 8:
        return None
    if buf[:8] == PNG_SIGNATURE:
        return decode_png(buf)
    if buf[:2] == b"\xff\xd8":
        if not lib.codec_routes() & ROUTE_JPEG:
            try:
                return decode_jpeg_baseline(buf)
            except ValueError:
                return None
        buf = bytes(buf)
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        src = _ptr(buf)
        if lib.jpeg_probe(src, len(buf), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c)):
            return None
        out = np.empty((h.value, w.value, c.value), np.uint8)
        if lib.jpeg_decode(src, len(buf), _out_ptr(out)):
            return None
        return out[..., 0] if c.value == 1 else out
    return None


# jpeg_baseline_probe's refusals, by code
_JPEG_REFUSALS = {
    1: "not a JPEG", 3: "malformed JPEG",
    4: "JPEG with other than 1 or 3 components (CMYK / YCCK)",
    6: "progressive JPEG", 7: "arithmetic-coded JPEG",
    8: "lossless or hierarchical JPEG", 9: "JPEG with other than 8-bit "
    "samples", 10: "JPEG subsampling other than 4:4:4, 4:2:2 and 4:2:0"}


def decode_jpeg_baseline(buf: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> [H,W] / [H,W,3] uint8 through the decoder
    written in `imagecodec.cpp` (libjpeg's islow IDCT, fancy upsampling and
    YCbCr tables: PIL's pixels bit for bit), whether or not libjpeg is
    linked. Raises ValueError naming what it refuses (progressive,
    arithmetic-coded, ...): `decode` turns that into None, and a caller
    with no other route (no PIL) calls this to say why."""
    lib = _load()
    if lib is None:
        raise _build.BuildError(_error)
    buf = bytes(buf)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    src = _ptr(buf)
    rc = lib.jpeg_baseline_probe(src, len(buf), ctypes.byref(h),
                                 ctypes.byref(w), ctypes.byref(c))
    if rc == 0:
        out = np.empty((h.value, w.value, c.value), np.uint8)
        rc = lib.jpeg_baseline_decode(src, len(buf), _out_ptr(out))
    if rc:
        raise ValueError(f"unsupported: {_JPEG_REFUSALS.get(rc, rc)}")
    return out[..., 0] if c.value == 1 else out


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, stride] uint8 rows -> [H, stride + 1], each row PNG-filtered as
    PIL's encoder chooses and led by its filter type
    (`utils.host_image._filter_rows` is the numpy version)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape
    out = np.empty((h, stride + 1), np.uint8)
    lib.png_filter_rows(_out_ptr(rows), h, stride, bpp, _out_ptr(out))
    return out
