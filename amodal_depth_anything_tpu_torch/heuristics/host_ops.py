"""The host image operations of the heuristics path, as cv2 computes them.

The JAX package's heuristics call cv2 (`heuristics/mask_heuristics.py`);
the card's machine has no cv2, so these are numpy/scipy versions of exactly
the calls it makes, each equal bit for bit to the cv2 build it was fitted
and tested against (5.0, with Intel IPP; tests/test_torch_host_ops.py):

  * `resize_linear` on uint8 (`cv2.resize`, INTER_LINEAR): OpenCV's
    fixed-point path. Source coordinates (x + 0.5) * scale - 0.5 in float32;
    11-bit weights, each of the pair rounded on its own; the horizontal pass
    clamps the column and zeroes its weight at the borders, the vertical one
    clamps only the row; rows combine as
    (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2. An exact
    2x downscale on both axes is an INTER_AREA one there, as in cv2.
  * `resize_linear` on float32: for sources of at least 2 x 2 pixels the
    path cv2 hands to Intel IPP: coordinates in float64, the fraction
    rounded to float32, x0 + (x1 - x0) * f as a fused multiply-add,
    horizontal pass first; otherwise OpenCV's own float path (float32
    coordinates, x0 * (1 - f) + x1 * f). Known gap: IPP takes another
    kernel for 3-channel images under a large upscale from a narrow source
    (16 px to 800 px); there results can differ from cv2 in the last bit.
  * `resize_area` (INTER_AREA, uint8): at integer factors the block mean
    (2 x 2 rounded half up, others sum * (1 / area) rounded half to even);
    otherwise OpenCV's table of overlap weights, accumulated in float32 in
    its order; an upscale on either axis is the linear path with
    INTER_AREA's weights.
  * `resize_nearest` (INTER_NEAREST): source index floor(x * scale).
  * `connected_components_with_stats` (8-connectivity): labels numbered as
    cv2's block-based scan numbers them (by the first 2 x 2 block of each
    component in raster order of blocks), areas and centroids.

Sizes are (width, height), as cv2 takes them. Nothing here imports cv2.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_linear", "resize_area", "resize_nearest",
           "connected_components_with_stats"]

_F32, _F64 = np.float32, np.float64
_COEF_BITS = 11                      # INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _inverse_scale(src: int, dst: int) -> float:
    """cv2's scale: 1 / (dst / src), in float64."""
    return 1.0 / (dst / src)


def _linear_coords(src: int, dst: int, area_mode: bool = False):
    """OpenCV's float32 source index and fraction per output pixel (linear,
    or the linear path's INTER_AREA weights), before any clamping."""
    scale = _inverse_scale(src, dst)
    d = np.arange(dst, dtype=_F64)
    if area_mode:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * (dst / src)).astype(_F32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(_F32)
        return s, f
    f = ((d + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(_F32)).astype(_F32)


def _clamp_x(s: np.ndarray, f: np.ndarray, src: int):
    """The horizontal pass's borders: left of pixel 0 and from the last
    pixel on, the column is clamped and its weight zeroed."""
    s, f = s.copy(), f.copy()
    lo, hi = s < 0, s >= src - 1
    s[lo], f[lo] = 0, 0
    s[hi], f[hi] = src - 1, 0
    return s, f


def _along(img: np.ndarray, idx: np.ndarray, axis: int) -> np.ndarray:
    return np.take(img, idx, axis=axis)


def _shape(ndim: int, axis: int) -> tuple:
    shp = [1] * ndim
    shp[axis] = -1
    return tuple(shp)


def _linear_u8(img: np.ndarray, w: int, h: int, area_mode: bool):
    hs, ws = img.shape[:2]
    sx, fx = _clamp_x(*_linear_coords(ws, w, area_mode), ws)
    sy, fy = _linear_coords(hs, h, area_mode)

    def weights(f):
        w0 = np.rint((_F32(1) - f) * _F32(_COEF_SCALE)).astype(np.int64)
        return w0, np.rint(f * _F32(_COEF_SCALE)).astype(np.int64)

    a0, a1 = weights(fx)
    b0, b1 = weights(fy)
    x = img.astype(np.int64)
    shp = _shape(img.ndim, 1)
    rows = (_along(x, sx, 1) * a0.reshape(shp)
            + _along(x, np.minimum(sx + 1, ws - 1), 1) * a1.reshape(shp))
    shp = _shape(img.ndim, 0)
    r0 = _along(rows, np.clip(sy, 0, hs - 1), 0) >> 4
    r1 = _along(rows, np.clip(sy + 1, 0, hs - 1), 0) >> 4
    out = (((b0.reshape(shp) * r0) >> 16) + ((b1.reshape(shp) * r1) >> 16)
           + 2) >> 2
    return out.astype(np.uint8)


def _linear_f32_generic(img: np.ndarray, w: int, h: int):
    """OpenCV's own float path (sources of one row or one column)."""
    hs, ws = img.shape[:2]
    sx, fx = _clamp_x(*_linear_coords(ws, w), ws)
    sy, fy = _linear_coords(hs, h)
    one = _F32(1)
    shp = _shape(img.ndim, 1)
    rows = (_along(img, sx, 1) * (one - fx).reshape(shp)
            + _along(img, np.minimum(sx + 1, ws - 1), 1) * fx.reshape(shp))
    shp = _shape(img.ndim, 0)
    return (_along(rows, np.clip(sy, 0, hs - 1), 0) * (one - fy).reshape(shp)
            + _along(rows, np.clip(sy + 1, 0, hs - 1), 0) * fy.reshape(shp))


def _ipp_pass(img: np.ndarray, dst: int, axis: int) -> np.ndarray:
    src = img.shape[axis]
    pos = (np.arange(dst, dtype=_F64) + 0.5) * _inverse_scale(src, dst) - 0.5
    s = np.floor(pos).astype(np.int64)
    f = (pos - s).astype(_F32)
    whole = f == 1
    s[whole] += 1
    f[whole] = 0
    edge = (s < 0) | (s >= src - 1)
    f[edge] = 0
    x0 = _along(img, np.clip(s, 0, src - 1), axis)
    x1 = _along(img, np.clip(s + 1, 0, src - 1), axis)
    # x0 + (x1 - x0) * f, one rounding: the float32 product is exact in
    # float64, and so is the sum for all but a vanishing share of inputs
    fma = (x0.astype(_F64) + (x1 - x0).astype(_F64)
           * f.reshape(_shape(img.ndim, axis)))
    return fma.astype(_F32)


def _linear_f32(img: np.ndarray, w: int, h: int) -> np.ndarray:
    if min(img.shape[:2]) < 2:
        return _linear_f32_generic(img, w, h)
    return _ipp_pass(_ipp_pass(img, w, 1), h, 0)


def _checked(img) -> np.ndarray:
    img = np.asarray(img)
    if not (img.ndim == 2 or img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"the cv2 resizes here take [H,W] or [H,W,3] "
                         f"images, got {img.shape}")
    return img


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size)` (INTER_LINEAR) of a uint8 or float32 [H,W]
    or [H,W,3] image; `size` = (width, height)."""
    img = _checked(img)
    w, h = int(size[0]), int(size[1])
    hs, ws = img.shape[:2]
    if (hs, ws) == (h, w):
        return img.copy()
    if img.dtype == np.uint8:
        if hs == 2 * h and ws == 2 * w:
            return resize_area(img, size)   # cv2 does the same
        return _linear_u8(img, w, h, False)
    if img.dtype == np.float32:
        return _linear_f32(img, w, h)
    raise ValueError(f"resize_linear takes uint8 or float32, got {img.dtype}")


def _area_table(src: int, dst: int):
    """OpenCV's `computeResizeAreaTab`: (dst index, src index, float32
    weight) per entry, in its order."""
    scale = _inverse_scale(src, dst)
    di, si, alpha = [], [], []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx2 = min(int(np.floor(fsx2)), src - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1)
            alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx)
            alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2)
            alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return (np.asarray(di, np.int64), np.asarray(si, np.int64),
            np.asarray(alpha, _F64).astype(_F32))


def _area_accumulate(x: np.ndarray, table, dst: int, axis: int, *,
                     scale_first: bool) -> np.ndarray:
    """out[d] = sum over d's entries, in table order, in float32:
    out[d] += src[s] * a (the horizontal pass), or first a * src[s] and then
    += a * src[s] (the vertical one)."""
    di, si, alpha = table
    start = np.searchsorted(di, np.arange(dst))
    count = np.bincount(di, minlength=dst)
    shp = _shape(x.ndim, axis)
    out_shape = list(x.shape)
    out_shape[axis] = dst
    out = np.zeros(out_shape, _F32)
    for k in range(int(count.max())):
        live = count > k
        e = np.minimum(start + k, len(di) - 1)
        term = _along(x, si[e], axis) * alpha[e].reshape(shp)
        term = np.where(live.reshape(shp), term, _F32(0))
        out = term if (k == 0 and scale_first) else out + term
    return out


def _area_general(img: np.ndarray, w: int, h: int) -> np.ndarray:
    x = img.astype(_F32)
    rows = _area_accumulate(x, _area_table(img.shape[1], w), w, 1,
                            scale_first=False)
    out = _area_accumulate(rows, _area_table(img.shape[0], h), h, 0,
                           scale_first=True)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _area_fast(img: np.ndarray, w: int, h: int) -> np.ndarray:
    fy, fx = img.shape[0] // h, img.shape[1] // w
    blocks = img.reshape(h, fy, w, fx, *img.shape[2:]).astype(np.int64)
    s = blocks.sum(axis=(1, 3))
    if (fx, fy) == (2, 2):
        return ((s + 2) >> 2).astype(np.uint8)
    v = s.astype(_F32) * _F32(1.0 / (fx * fy))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_AREA)` of a uint8
    [H,W] or [H,W,3] image; `size` = (width, height)."""
    img = _checked(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8, got {img.dtype}")
    w, h = int(size[0]), int(size[1])
    hs, ws = img.shape[:2]
    if (hs, ws) == (h, w):
        return img.copy()
    sx, sy = _inverse_scale(ws, w), _inverse_scale(hs, h)
    if sx >= 1 and sy >= 1:
        if (abs(sx - round(sx)) < np.finfo(_F64).eps
                and abs(sy - round(sy)) < np.finfo(_F64).eps):
            return _area_fast(img, w, h)
        return _area_general(img, w, h)
    return _linear_u8(img, w, h, True)


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`; `size` =
    (width, height)."""
    img = np.asarray(img)
    w, h = int(size[0]), int(size[1])
    hs, ws = img.shape[:2]

    def index(src, dst):
        i = np.floor(np.arange(dst) * _inverse_scale(src, dst))
        return np.minimum(i.astype(np.int64), src - 1)

    return img[index(hs, h)][:, index(ws, w)]


def connected_components_with_stats(mask: np.ndarray):
    """`cv2.connectedComponentsWithStats(mask, connectivity=8)`: returns
    (n_labels, labels int32 [H,W], stats int32 [n, 5] as (left, top, width,
    height, area), centroids float64 [n, 2] as (x, y)); label 0 is the
    background."""
    from scipy import ndimage

    fg = np.asarray(mask) != 0
    h, w = fg.shape
    raw, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    labels = np.zeros((h, w), np.int32)
    stats = np.zeros((n + 1, 5), np.int32)
    centroids = np.zeros((n + 1, 2), np.float64)
    ys, xs = np.nonzero(fg)
    if n == 0:
        stats[0] = (0, 0, w, h, h * w)
        centroids[0] = ((w - 1) / 2.0, (h - 1) / 2.0)
        return 1, labels, stats, centroids
    if len(ys) == h * w:
        # no background pixel: cv2 reports label 0 so
        stats[0] = (-1, np.iinfo(np.int32).max, 0, 0, 0)
        centroids[0] = np.nan
    comp = raw[ys, xs]
    # cv2's block scan meets a component first in its earliest 2 x 2 block
    block = (ys // 2) * ((w + 1) // 2) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, comp, block)
    order = np.argsort(first[1:], kind="stable") + 1
    relabel = np.zeros(n + 1, np.int32)
    relabel[order] = np.arange(1, n + 1, dtype=np.int32)
    labels[ys, xs] = relabel[comp]
    lab = labels.reshape(-1)
    area = np.bincount(lab, minlength=n + 1)
    yy, xx = np.divmod(np.arange(h * w), w)
    left = np.full(n + 1, w)
    top = np.full(n + 1, h)
    right = np.full(n + 1, -1)
    bottom = np.full(n + 1, -1)
    np.minimum.at(left, lab, xx)
    np.minimum.at(top, lab, yy)
    np.maximum.at(right, lab, xx)
    np.maximum.at(bottom, lab, yy)
    live = slice(1, None) if len(ys) == h * w else slice(None)
    stats[live, 0], stats[live, 1] = left[live], top[live]
    stats[live, 2] = (right - left + 1)[live]
    stats[live, 3] = (bottom - top + 1)[live]
    stats[live, 4] = area[live]
    sum_x = np.bincount(lab, weights=xx, minlength=n + 1)
    sum_y = np.bincount(lab, weights=yy, minlength=n + 1)
    centroids[live, 0] = (sum_x / np.maximum(area, 1))[live]
    centroids[live, 1] = (sum_y / np.maximum(area, 1))[live]
    return n + 1, labels, stats, centroids
