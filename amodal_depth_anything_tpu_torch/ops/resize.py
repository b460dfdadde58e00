"""Image resizing on NHWC (...HWC) tensors over `F.interpolate`.

The JAX package emulates torch's `interpolate` with separable matmuls
(exact source-index formulas, cubic A = -0.75, the `scale_factor`-vs-`size`
choice of scale, clamping of negative linear indices). Here the original is
at hand, so these are thin NHWC wrappers that keep the JAX functions'
signatures: the channel axis moves to the NCHW position as a view and back.
Antialiasing stays off, as in the reference.

On the card the gradient of a bilinear or bicubic resize is taken by two
products with the resize's own weight matrices (read off `F.interpolate`
of an identity, once per geometry; float32 for a float32 gradient, the
gradient's dtype on the tensor cores otherwise) instead of
`F.interpolate`'s backward,
which sums with float atomics in an order that changes from run to run: so
a train step gives the same bits every time, eagerly or replayed from a
CUDA graph. The forward is `F.interpolate` either way; on the CPU both
directions are torch's (its backward adds in a fixed order there).
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


def _resize4(x4, size, scale_factor, mode: str, align_corners):
    if scale_factor is not None:
        return F.interpolate(x4, scale_factor=_split2(scale_factor),
                             mode=mode, align_corners=align_corners)
    return F.interpolate(x4, size=_split2(size), mode=mode,
                         align_corners=align_corners)


@functools.lru_cache(maxsize=64)
def _weights(n: int, out: int, axis: int, scale, mode: str, align_corners,
             device: torch.device) -> torch.Tensor:
    """[out, n] float32: the weights `F.interpolate` gives along one axis
    (`axis` 0 for height, 1 for width) of an n-long input, read off the
    resize of an identity whose other axis keeps its length."""
    eye = torch.eye(n, dtype=torch.float32, device=device)[None, None]
    if axis == 0:
        size, sf = (out, n), None if scale is None else (scale, 1.0)
        w = _resize4(eye, size if sf is None else None, sf, mode,
                     align_corners)[0, 0]
    else:
        size, sf = (n, out), None if scale is None else (1.0, scale)
        w = _resize4(eye, size if sf is None else None, sf, mode,
                     align_corners)[0, 0].T
    return w.contiguous()


class _DeterministicResize(torch.autograd.Function):
    """`F.interpolate` forward; the backward as Wy^T dY Wx: in float32 for a
    float32 gradient, on the tensor cores in the gradient's own dtype (f32
    accumulation) for a bfloat16 one, about as precise as the atomic
    backward's rounding to bfloat16 at every add."""

    @staticmethod
    def forward(ctx, x4, size, scale_factor, mode, align_corners):
        y = _resize4(x4, size, scale_factor, mode, align_corners)
        sh, sw = _split2(scale_factor)
        ctx.wy = _weights(x4.shape[2], y.shape[2], 0, sh, mode,
                          align_corners, x4.device)
        ctx.wx = _weights(x4.shape[3], y.shape[3], 1, sw, mode,
                          align_corners, x4.device)
        ctx.dtype = x4.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        dt = torch.float32 if dy.dtype == torch.float32 else dy.dtype
        g = torch.einsum("ip,ncij->ncpj", ctx.wy.to(dt), dy.to(dt))
        g = torch.einsum("jq,ncpj->ncpq", ctx.wx.to(dt), g)
        return g.to(ctx.dtype), None, None, None, None


def _interpolate(x: torch.Tensor, size, scale_factor, mode: str,
                 align_corners: bool | None) -> torch.Tensor:
    *lead, h, w, c = x.shape
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    if (x.is_cuda and mode in ("bilinear", "bicubic") and x.requires_grad
            and torch.is_grad_enabled()):
        y = _DeterministicResize.apply(x4, size, scale_factor, mode,
                                       align_corners)
    else:
        y = _resize4(x4, size, scale_factor, mode, align_corners)
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
