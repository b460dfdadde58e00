"""Image helpers: depth colourisation and target highlighting.

The port's own copies of the JAX package's `utils/image.py` helpers
(reference `src/util/image_util.py` colourise and the `highlight_target`
contour overlay, `infer.py:46-57`). matplotlib and cv2 are imported inside
the functions: the card's machine has neither, and the inference path
needs neither.
"""

from __future__ import annotations

import numpy as np

__all__ = ["colorize_depth", "highlight_target"]


def colorize_depth(depth, min_depth: float = 0.0, max_depth: float = 1.0,
                   cmap: str = "Spectral_r", valid_mask=None) -> np.ndarray:
    """depth [H,W] (or [N,H,W]) -> float RGB [.,H,W,3] in [0,1]."""
    import matplotlib

    d = np.asarray(depth, np.float32)
    squeeze = d.ndim == 2
    if squeeze:
        d = d[None]
    d = (d - min_depth) / max(max_depth - min_depth, 1e-8)
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
    """Grey out the background by alpha and draw the mask contour in black."""
    import cv2

    mask3 = np.repeat((np.asarray(mask_u8) > 0)[..., None], 3, axis=-1)
    overlay = np.full_like(rgb_u8, 200)
    out = np.where(mask3, rgb_u8,
                   ((1 - alpha) * rgb_u8 + alpha * overlay)).astype(np.uint8)
    contours, _ = cv2.findContours((np.asarray(mask_u8) > 0).astype(np.uint8),
                                   cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    return cv2.drawContours(out, contours, -1, (0, 0, 0), 2)
