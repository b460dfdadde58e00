"""Host-side preprocessing in C++ (`preprocess.cpp`), bound through ctypes.

The port's copy of the JAX package's `native/` resizes, with what the
port's host paths ask numpy or a library for in the same library:

  * `resize_u8_to_f32`, `resize_u16_to_f32`, `resize_f32`: NEAREST_EXACT
    resizes (torch's source index, computed in float32) with a fused
    uint -> float scale, as the JAX package's native module gives them;
  * `gather`: a nearest resize whose source rows and columns the caller
    computed (`utils.host_image.resize_nearest`: PIL's NEAREST indices);
  * `resize_bilinear`: PIL's BILINEAR `Image.resize` of a uint8 or float32
    image (`utils.host_image.resize_bilinear_plain` is its numpy version);
  * `resize_bicubic`: PIL's BICUBIC `Image.resize` of a uint8 or an "I;16"
    uint16 image (`utils.host_image.resize_bicubic_plain`);
  * `find_contours`, `draw_contours`, `draw_mask_contours`: OpenCV's
    `findContours(RETR_TREE, CHAIN_APPROX_SIMPLE)` and `drawContours` with
    8-connected lines (`utils.image.highlight_target`).

The library is built by g++ at first use into `build/torch_native/`
(`native/_build.py`: a source hash in the file name, an atomic rename) with
OpenMP where the compiler has it. ctypes releases the GIL for each call,
so loader and request threads run these in parallel. Callers check
`available()` and take their numpy (or library) version otherwise: it is
false where the library does not build, and while `plain_route()` is in
force (a comparison of both routes). `require()` raises the build's error
instead (`chip_smoke.py` on the card).
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import threading

import numpy as np

from . import _build

__all__ = ["available", "require", "plain_route", "enabled",
           "resize_u8_to_f32", "resize_u16_to_f32", "resize_f32", "gather",
           "resize_bilinear", "resize_bicubic", "find_contours",
           "draw_contours", "draw_mask_contours"]

_VARIANTS = [(("-fopenmp",), ()), ((), ())]
_lib = None
_path = None
_error: str | None = None
_lock = threading.Lock()
_plain = [0]   # open plain_route() blocks


def _load():
    global _lib, _path, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib, extra = _build.load("preprocess", _VARIANTS)
        except (_build.BuildError, OSError) as e:
            _error = str(e)
            logging.debug("native preprocess unavailable: %s", e)
            return None
        _bind(lib)
        _path = str(_build.library_path(
            "preprocess", (*_build.BASE_FLAGS, *extra)))
        _lib = lib
    return _lib


def _bind(lib) -> None:
    i32, f32, i64 = ctypes.c_int32, ctypes.c_float, ctypes.c_int64
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.resize_u8_to_f32.argtypes = [u8p, i32, i32, i32, f32p, i32, i32,
                                     f32, f32]
    lib.resize_u16_to_f32.argtypes = [u16p, i32, i32, f32p, i32, i32, f32]
    lib.resize_f32.argtypes = [f32p, i32, i32, i32, f32p, i32, i32]
    lib.gather_rows_cols.argtypes = [u8p, i32, i32, i64p, i32, i64p, i32,
                                     u8p]
    lib.resize_bilinear_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32]
    lib.resize_bilinear_f32.argtypes = [f32p, i32, i32, i32, f32p, i32, i32]
    lib.resize_bicubic_u8.argtypes = [u8p, i32, i32, i32, u8p, i32, i32]
    lib.resize_bicubic_u16.argtypes = [u16p, i32, i32, u16p, i32, i32]
    lib.contours_find.argtypes = [u8p, i32, i32]
    lib.contours_find.restype = ctypes.c_void_p
    lib.contours_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(i64),
                                  ctypes.POINTER(i64)]
    lib.contours_copy.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.contours_free.argtypes = [ctypes.c_void_p]
    lib.draw_contours.argtypes = [u8p, i32, i32, i32, i32p, i32, i32p, u8p,
                                  i32]
    lib.draw_mask_contours.argtypes = [u8p, i32, i32, i32, u8p, u8p, i32]
    for name in ("resize_u8_to_f32", "resize_u16_to_f32", "resize_f32",
                 "gather_rows_cols", "resize_bilinear_u8",
                 "resize_bilinear_f32", "resize_bicubic_u8",
                 "resize_bicubic_u16", "contours_size", "contours_copy",
                 "contours_free", "draw_contours", "draw_mask_contours"):
        getattr(lib, name).restype = None


def enabled() -> bool:
    """False while `plain_route()` is in force."""
    return _plain[0] == 0


@contextlib.contextmanager
def plain_route():
    """Within the block, `available()` is false and every caller, in every
    thread (a server's request threads too), takes its plain version."""
    with _lock:
        _plain[0] += 1
    try:
        yield
    finally:
        with _lock:
            _plain[0] -= 1


def available() -> bool:
    """Whether callers should take the native route: the library built and
    loaded, and no `plain_route()` in force."""
    return enabled() and _load() is not None


def require() -> str:
    """Build and load the library or raise its build error; returns its
    path."""
    if _load() is None:
        raise _build.BuildError(_error)
    return _path


def _hwc(img: np.ndarray):
    h, w = img.shape[:2]
    return h, w, 1 if img.ndim == 2 else img.shape[2]


def resize_u8_to_f32(img: np.ndarray, out_hw, scale: float = 1.0,
                     shift: float = 0.0) -> np.ndarray:
    """[H,W,C] uint8 -> [h,w,C] float32 NEAREST_EXACT, value*scale+shift."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = _hwc(img)
    out = np.empty((out_hw[0], out_hw[1], ch), np.float32)
    lib.resize_u8_to_f32(img.reshape(h, w, ch), h, w, ch, out,
                         out_hw[0], out_hw[1], scale, shift)
    return out


def resize_u16_to_f32(img: np.ndarray, out_hw,
                      scale: float = 1.0 / 65535.0) -> np.ndarray:
    """[H,W] uint16 -> [h,w] float32 NEAREST_EXACT, value*scale."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint16)
    h, w = img.shape[:2]
    out = np.empty((out_hw[0], out_hw[1]), np.float32)
    lib.resize_u16_to_f32(img, h, w, out, out_hw[0], out_hw[1], scale)
    return out


def resize_f32(img: np.ndarray, out_hw) -> np.ndarray:
    """[H,W,C] (or [H,W]) float32 -> [h,w,C] float32 NEAREST_EXACT."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w, ch = _hwc(img)
    out = np.empty((out_hw[0], out_hw[1], ch), np.float32)
    lib.resize_f32(img.reshape(h, w, ch), h, w, ch, out, out_hw[0],
                   out_hw[1])
    return out if img.ndim == 3 else out[..., 0]


def gather(img: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """`img[rows][:, cols]` for any dtype and channel count."""
    lib = _load()
    img = np.ascontiguousarray(img)
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    for idx, n in ((rows, img.shape[0]), (cols, img.shape[1])):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"gather index out of [0, {n})")
    out = np.empty((len(rows), len(cols)) + img.shape[2:], img.dtype)
    px = img.dtype.itemsize * int(np.prod(img.shape[2:], dtype=np.int64))
    lib.gather_rows_cols(img.view(np.uint8).reshape(-1), img.shape[1], px,
                         rows, len(rows), cols, len(cols),
                         out.view(np.uint8).reshape(-1))
    return out


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """PIL's `Image.resize(size, BILINEAR)` of uint8 [H,W] / [H,W,C] or
    float32 [H,W] / [H,W,C]; `size` = (width, height)."""
    lib = _load()
    w, h = int(size[0]), int(size[1])
    img = np.ascontiguousarray(img)
    ih, iw, ch = _hwc(img)
    out = np.empty((h, w) + img.shape[2:], img.dtype)
    if img.dtype == np.uint8:
        lib.resize_bilinear_u8(img.reshape(-1), ih, iw, ch,
                               out.reshape(-1), h, w)
    elif img.dtype == np.float32:
        lib.resize_bilinear_f32(img.reshape(-1), ih, iw, ch,
                                out.reshape(-1), h, w)
    else:
        raise ValueError(f"resize_bilinear takes uint8 or float32, got "
                         f"{img.dtype}")
    return out


def resize_bicubic(img: np.ndarray, size) -> np.ndarray:
    """PIL's `Image.resize(size, BICUBIC)` of uint8 [H,W] / [H,W,C] or of
    uint16 [H,W] (mode "I;16"); `size` = (width, height)."""
    lib = _load()
    w, h = int(size[0]), int(size[1])
    img = np.ascontiguousarray(img)
    ih, iw, ch = _hwc(img)
    out = np.empty((h, w) + img.shape[2:], img.dtype)
    if img.dtype == np.uint8:
        lib.resize_bicubic_u8(img.reshape(-1), ih, iw, ch, out.reshape(-1),
                              h, w)
    elif img.dtype == np.uint16 and img.ndim == 2:
        lib.resize_bicubic_u16(img.reshape(-1), ih, iw, out.reshape(-1), h, w)
    else:
        raise ValueError(f"resize_bicubic takes uint8 or 2-D uint16, got "
                         f"{img.dtype} {img.shape}")
    return out


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """The borders of `mask` (nonzero = object) as `cv2.findContours(mask,
    RETR_TREE, CHAIN_APPROX_SIMPLE)` traces them: a list of [N,1,2] int32
    (x, y) arrays."""
    lib = _load()
    m = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    handle = lib.contours_find(m, m.shape[0], m.shape[1])
    try:
        nc, npts = ctypes.c_int64(), ctypes.c_int64()
        lib.contours_size(handle, ctypes.byref(nc), ctypes.byref(npts))
        lens = np.empty(nc.value, np.int32)
        xy = np.empty((npts.value, 2), np.int32)
        lib.contours_copy(handle, lens, xy)
    finally:
        lib.contours_free(handle)
    return [c.reshape(-1, 1, 2) for c in np.split(xy, np.cumsum(lens)[:-1])
            ] if len(lens) else []


def _color(img: np.ndarray, color) -> np.ndarray:
    ch = 1 if img.ndim == 2 else img.shape[2]
    return np.ascontiguousarray(
        (list(color) + [0] * ch)[:ch], np.uint8)


def draw_contours(img: np.ndarray, contours, color=(0, 0, 0),
                  thickness: int = 2) -> np.ndarray:
    """`cv2.drawContours(img, contours, -1, color, thickness)` (LINE_8) on
    a C-contiguous uint8 [H,W] / [H,W,C] image, in place; thickness >= 2.
    Returns `img`."""
    lib = _load()
    if thickness < 2:
        raise ValueError(f"thickness must be >= 2, got {thickness}")
    if img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError("draw_contours draws on a C-contiguous uint8 image")
    h, w, ch = _hwc(img)
    pts = [np.asarray(c, np.int32).reshape(-1, 2) for c in contours]
    lens = np.asarray([len(p) for p in pts], np.int32)
    xy = np.ascontiguousarray(np.concatenate(pts) if pts else
                              np.zeros((0, 2), np.int32))
    lib.draw_contours(img.reshape(-1), h, w, ch, lens, len(lens),
                      xy.reshape(-1), _color(img, color), thickness)
    return img


def draw_mask_contours(img: np.ndarray, mask: np.ndarray, color=(0, 0, 0),
                       thickness: int = 2) -> np.ndarray:
    """`draw_contours(img, find_contours(mask), color, thickness)` in one
    call. Returns `img`."""
    lib = _load()
    if thickness < 2:
        raise ValueError(f"thickness must be >= 2, got {thickness}")
    if img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError("draw_mask_contours draws on a C-contiguous uint8 "
                         "image")
    h, w, ch = _hwc(img)
    m = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    if m.shape != (h, w):
        raise ValueError(f"mask {m.shape} does not match the image {h, w}")
    lib.draw_mask_contours(img.reshape(-1), h, w, ch, m,
                           _color(img, color), thickness)
    return img
