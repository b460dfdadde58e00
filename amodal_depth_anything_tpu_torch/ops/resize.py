"""Image resizing on NHWC (...HWC) tensors over `F.interpolate`.

The JAX package emulates torch's `interpolate` with separable matmuls
(exact source-index formulas, cubic A = -0.75, the `scale_factor`-vs-`size`
choice of scale, clamping of negative linear indices). Here the original is
at hand, so these are thin NHWC wrappers that keep the JAX functions'
signatures: the channel axis moves to the NCHW position as a view and back.
Antialiasing stays off, as in the reference.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize2d", "resize_nearest"]


def _split2(v):
    if v is None:
        return None, None
    if isinstance(v, (tuple, list)):
        return v[0], v[1]
    return v, v


def _out_size(in_size: int, size, scale_factor) -> int:
    if size is not None:
        return int(size)
    return int(math.floor(in_size * scale_factor))  # torch: floor(in * s)


def _interpolate(x: torch.Tensor, size, scale_factor, mode: str,
                 align_corners: bool | None) -> torch.Tensor:
    *lead, h, w, c = x.shape
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    if scale_factor is not None:
        y = F.interpolate(x4, scale_factor=_split2(scale_factor), mode=mode,
                          align_corners=align_corners)
    else:
        y = F.interpolate(x4, size=_split2(size), mode=mode,
                          align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, y.shape[2], y.shape[3], c)


def resize_nearest(x: torch.Tensor, size=None, scale_factor=None, *,
                   exact: bool = False) -> torch.Tensor:
    """Nearest-neighbour resize of the (-3, -2) axes of an ...HWC tensor.

    `exact=False` is torch mode "nearest"; `exact=True` "nearest-exact"."""
    return _interpolate(x, size, scale_factor,
                        "nearest-exact" if exact else "nearest", None)


def resize2d(x: torch.Tensor, size=None, scale_factor=None, *,
             method: str = "bilinear",
             align_corners: bool = False) -> torch.Tensor:
    """Resize the (-3, -2) axes of an ...HWC tensor with torch semantics."""
    if method in ("nearest", "nearest-exact"):
        return resize_nearest(x, size, scale_factor,
                              exact=method == "nearest-exact")
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resize method: {method}")
    sh, sw = _split2(scale_factor)
    oh, ow = _split2(size)
    if (sh is None and sw is None
            and (_out_size(x.shape[-3], oh, sh),
                 _out_size(x.shape[-2], ow, sw)) == tuple(x.shape[-3:-1])):
        return x  # same size, no scale_factor: identity
    return _interpolate(x, size, scale_factor, method, align_corners)


@functools.lru_cache(maxsize=256)
def _nearest_indices(in_size: int, out_size: int, *,
                     exact: bool) -> np.ndarray:
    """Source indices of a nearest resize for host-side numpy rasters (the
    data layer). torch computes them in float32 (aten
    `nearest_neighbor_compute_source_index`); float64 would flip floor() at
    exact-integer boundaries (e.g. 222*35/518 == 15)."""
    scale = np.float32(in_size / out_size)
    d = np.arange(out_size, dtype=np.float32)
    idx = np.floor((d + np.float32(0.5)) * scale if exact else d * scale)
    return np.clip(idx, 0, in_size - 1).astype(np.int32)
