"""NHWC convolution helpers of the DPT head, the LDM UNet and the SD VAE.

Tensors stay NHWC at these functions, as in the JAX package; the library
convolutions run on the NCHW view of the same memory (channels-last), so no
layout copy is made. Weights keep torch's own layouts, the ones the
reference checkpoints hold, and follow the input's dtype at use, so a head
with float32 master weights computes in bfloat16 on bfloat16 activations.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["conv2d", "conv_transpose_same_stride", "fused_upsample2x_conv",
           "upsample2x_conv", "layer_norm_2d", "Conv2dNHWC", "ConvTranspose2dNHWC",
           "LayerNorm2d"]


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *, stride: int = 1,
           padding=0) -> torch.Tensor:
    """Convolution on NHWC with an OIHW `weight`. `padding`: an int
    (symmetric) or ((top, bottom), (left, right)), which pads with zeros
    first (the SD VAE downsampler pads (0, 1) on both axes and then
    convolves without padding)."""
    y = x.permute(0, 3, 1, 2)
    if not isinstance(padding, int):
        (top, bottom), (left, right) = padding
        y = F.pad(y, (left, right, top, bottom))
        padding = 0
    y = F.conv2d(y, weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def _fold_taps(w: torch.Tensor, dim: int, phase: int) -> torch.Tensor:
    """Fold the 3 taps of `w` along `dim` onto the 2 low-resolution offsets
    an output row (or column) of that phase reads after a nearest 2x
    upsample: phase 0 reads {0} and {1, 2}, phase 1 reads {0, 1} and {2}."""
    a, b, c = w.unbind(dim)
    pair = (a, b + c) if phase == 0 else (a + b, c)
    return torch.stack(pair, dim)


def fused_upsample2x_conv(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest 2x upsample followed by a 3x3 SAME convolution, as one
    convolution at the low resolution (NHWC in and out, `weight` OIHW).

    After a nearest upsample every 3x3 window reads a 2x2 low-resolution
    neighbourhood with repeated taps, so for each output phase (di, dj) in
    {0, 1}^2 the kernel folds into a 2x2 one. The four phase kernels,
    stacked on the output channels, run as one [4*Cout, C, 2, 2]
    convolution on H x W (16 multiply-adds per output against 36, and the
    upsampled [2H, 2W, C] tensor is never made); a depth-to-space
    interleave puts phase (di, dj) at y[2i + di, 2j + dj]. The taps are
    summed in float32 before the cast to x's dtype, so the result matches
    the unfused pair up to one rounding of the folded weight."""
    if weight.shape[2:] != (3, 3):
        raise ValueError(f"fused_upsample2x_conv needs a 3x3 kernel, got "
                         f"{tuple(weight.shape)}")
    w = weight.float()
    c_out = w.shape[0]
    kernel = torch.cat([_fold_taps(_fold_taps(w, 2, di), 3, dj)
                        for di in (0, 1) for dj in (0, 1)])  # [4Co, C, 2, 2]
    b, h, wid, _ = x.shape
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.to(x.dtype), padding=1)
    y = y.permute(0, 2, 3, 1)                       # [B, H+1, W+1, 4*Cout]
    # phase (di, dj) lives at y[:, di:di+H, dj:dj+W, p*Cout:(p+1)*Cout]
    parts = [y[:, di:di + h, dj:dj + wid, i * c_out:(i + 1) * c_out]
             for i, (di, dj) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    out = torch.stack(parts, dim=3).view(b, h, wid, 2, 2, c_out)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * wid, c_out)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def upsample2x_conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """Nearest 2x upsample then `conv` (a 3x3 SAME conv module, float or
    quantised, `ops.quant`). A float or weight-only (w8 / w4) kernel takes
    the fused path, the weight-only one dequantised to float32 before the
    fold; a W8A8 kernel cannot fold and runs the two steps (as the JAX
    package's UNet and VAE do)."""
    from .quant import is_quantized
    if not is_quantized(conv):
        return fused_upsample2x_conv(x, conv.weight, conv.bias)
    if conv.mode == "int8":
        from .resize import resize_nearest
        return conv(resize_nearest(x, scale_factor=2.0))
    return fused_upsample2x_conv(x, conv.dense_weight(torch.float32),
                                 conv._get("bias"))


def conv_transpose_same_stride(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """ConvTranspose2d with kernel_size == stride == k, padding 0, on NHWC.

    `weight`: torch's ConvTranspose2d layout [C_in, C_out, k, k]."""
    k = weight.shape[-1]
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                           None if bias is None else bias.to(x.dtype),
                           stride=k)
    return y.permute(0, 2, 3, 1)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  *, eps: float = 1e-6) -> torch.Tensor:
    """Channel LayerNorm on NHWC (reference dpt.py 'channels_first'
    LayerNorm): (x - u) / sqrt(s + eps) over C, statistics in float32."""
    xf = x.float()
    u = xf.mean(-1, keepdim=True)
    s = (xf - u).square().mean(-1, keepdim=True)
    y = (xf - u) / torch.sqrt(s + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


class Conv2dNHWC(nn.Conv2d):
    """nn.Conv2d (same parameters and state-dict keys) on NHWC tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(x.permute(0, 3, 1, 2),
                               self.weight.to(x.dtype), bias)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2dNHWC(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with kernel_size == stride, on NHWC tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_same_stride(x, self.weight, self.bias)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm with the reference's `weight`/`bias` keys."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias, eps=self.eps)
