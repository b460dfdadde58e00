"""Image helpers: depth colourisation and target highlighting.

The port's own copies of the JAX package's `utils/image.py` helpers
(reference `src/util/image_util.py` colourise and the `highlight_target`
contour overlay, `infer.py:46-57`), bit for bit, without matplotlib or cv2
(the card's machine has neither):

  * `colorize_depth` indexes a copy of matplotlib's "Spectral_r" table
    (`utils.colormap`) as `Colormap.__call__` does: x * 256 in float32,
    256 -> 255, truncated, NaN -> black; another `cmap` imports matplotlib;
  * `highlight_target` draws the mask's contour with the C++ port of
    `cv2.findContours(RETR_TREE, CHAIN_APPROX_SIMPLE)` + `cv2.drawContours(
    ..., (0, 0, 0), 2)` in `native` (cv2 itself where the library does not
    build);
  * `read_image` / `read_image_bgr` read a file as `np.asarray(PIL.Image.
    open(path))` and as `cv2.imread(path)` give it, through the native
    codec (PNG; JPEG through libjpeg where it was built, else its baseline
    decoder) or the numpy PNG decoder, PIL for the rest;
    `write_png` writes an RGB array whose decoded pixels equal those of
    `cv2.imwrite(path, rgb[..., ::-1])`.

tests/test_torch_render.py holds them to matplotlib, PIL and cv2.
"""

from __future__ import annotations

import numpy as np

__all__ = ["colorize_depth", "highlight_target", "read_image",
           "decode_with_pil", "read_image_bgr", "read_rgb", "to_rgb", "resize_default",
           "write_png"]


def _spectral_r(x: np.ndarray) -> np.ndarray:
    """`matplotlib.colormaps["Spectral_r"](x)[..., :3]` of a float32 array
    in [0, 1] (or NaN), as float32."""
    from .colormap import SPECTRAL_R

    n = SPECTRAL_R.shape[0]
    xa = x * np.float32(n)
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    rgb = SPECTRAL_R[np.where(bad, 0, xa).astype(np.int64)]
    rgb[bad] = 0.0
    return rgb


def colorize_depth(depth, min_depth: float = 0.0, max_depth: float = 1.0,
                   cmap: str = "Spectral_r", valid_mask=None) -> np.ndarray:
    """depth [H,W] (or [N,H,W]) -> float RGB [.,H,W,3] in [0,1]."""
    d = np.asarray(depth, np.float32)
    squeeze = d.ndim == 2
    if squeeze:
        d = d[None]
    d = (d - min_depth) / max(max_depth - min_depth, 1e-8)
    if cmap == "Spectral_r":
        rgb = _spectral_r(np.clip(d, 0, 1))
    else:
        import matplotlib
        cm = matplotlib.colormaps[cmap]
        rgb = cm(np.clip(d, 0, 1), bytes=False)[..., :3].astype(np.float32)
    if valid_mask is not None:
        m = np.asarray(valid_mask, bool)
        if m.ndim == 2:
            m = m[None]
        rgb[~m] = 0
    return rgb[0] if squeeze else rgb


def highlight_target(rgb_u8: np.ndarray, mask_u8: np.ndarray,
                     alpha: float = 0.0) -> np.ndarray:
    """Grey out the background by alpha and draw the mask contour in black
    (2 px, 8-connected)."""
    from .. import native

    inside = np.asarray(mask_u8) > 0
    overlay = np.full_like(rgb_u8, 200)
    out = np.where(np.repeat(inside[..., None], 3, axis=-1), rgb_u8,
                   ((1 - alpha) * rgb_u8 + alpha * overlay)).astype(np.uint8)
    out = np.ascontiguousarray(out)
    if native.available():
        return native.draw_mask_contours(out, inside, (0, 0, 0), 2)
    import cv2
    contours, _ = cv2.findContours(inside.astype(np.uint8), cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_SIMPLE)
    return cv2.drawContours(out, contours, -1, (0, 0, 0), 2)


def _decode(data: bytes) -> np.ndarray | None:
    """`data` through the native codec, or None where it does not take it."""
    from ..native import imagecodec
    return imagecodec.decode(data) if imagecodec.available() else None


def read_image(path: str) -> np.ndarray:
    """The file as `np.asarray(PIL.Image.open(path))` gives it: PNGs by
    `host_image.decode_png` (palette and 1-bit included), JPEGs by the
    native codec; PIL for the rest (`decode_with_pil`)."""
    from .host_image import PNG_SIGNATURE, decode_png

    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    px = _decode(data)
    if px is not None:
        return px
    return decode_with_pil(data)


def decode_with_pil(data: bytes) -> np.ndarray:
    """`np.asarray(PIL.Image.open(...))` of what the native codec did not
    take. Where PIL is not installed, a JPEG goes to the baseline decoder
    once more, which raises naming what it refuses (progressive,
    arithmetic-coded, ...)."""
    import io
    try:
        from PIL import Image
    except ImportError:
        from ..native import imagecodec
        if data[:2] == b"\xff\xd8" and imagecodec.available():
            return imagecodec.decode_jpeg_baseline(data)
        raise
    return np.asarray(Image.open(io.BytesIO(data)))


def read_image_bgr(path: str) -> np.ndarray:
    """The file as `cv2.imread(path)` gives it: [H,W,3] uint8 BGR, grey
    repeated, alpha dropped, 16-bit samples cut to their high byte. PNGs
    (the codec's, else the numpy decoder's samples) and JPEGs (the codec's
    libjpeg route); cv2 itself for what neither takes (palette PNGs,
    JPEGs without libjpeg)."""
    from .host_image import PNG_SIGNATURE, decode_png_plain

    with open(path, "rb") as f:
        data = f.read()
    px = _decode(data)
    # IHDR's bit depth and colour type sit at bytes 24 and 25
    if px is None and data.startswith(PNG_SIGNATURE) and len(data) > 25 \
            and data[24] >= 8 and data[25] != 3:
        px = decode_png_plain(data)   # tRNS ignored, as cv2 does
    if px is None:
        import cv2
        img = cv2.imread(path)
        if img is None:
            raise ValueError(f"cannot read {path}")
        return img
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    elif px.dtype != np.uint8:
        px = px.astype(np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[-1] in (1, 2):
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=-1))
    return np.ascontiguousarray(px[..., 2::-1])


def to_rgb(px: np.ndarray) -> np.ndarray:
    """An image array as PIL's `.convert("RGB")` gives it, for the arrays
    `read_image` returns: grey repeated, grey + alpha and RGBA without
    their alpha (8-bit samples)."""
    if px.dtype == bool:
        px = px.astype(np.uint8) * 255
    if px.ndim == 2:
        px = px[..., None]
    if px.shape[-1] in (1, 2):
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=-1))
    return np.ascontiguousarray(px[..., :3])


def read_rgb(path: str) -> np.ndarray:
    """`np.asarray(PIL.Image.open(path).convert("RGB"))`: [H,W,3] uint8."""
    return to_rgb(read_image(path))


def resize_default(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`PIL.Image.fromarray(img).resize(size)` with PIL's default filter:
    BICUBIC for uint8 L / RGB and uint16 "I;16" images, NEAREST for 1-bit
    (bool) ones; `size` = (width, height)."""
    from .host_image import resize_bicubic, resize_nearest
    if img.dtype == bool:
        return resize_nearest(img, size)
    return resize_bicubic(img, size)


def write_png(path: str, rgb: np.ndarray) -> None:
    """uint8 [H,W] / [H,W,3] / [H,W,4] (RGB order) or uint16 [H,W] -> a PNG
    at `path` (`host_image.encode_png`)."""
    from .host_image import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(rgb)))
