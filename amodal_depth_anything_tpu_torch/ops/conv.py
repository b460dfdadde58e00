"""NHWC convolution helpers of the DPT head.

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

__all__ = ["conv_transpose_same_stride", "layer_norm_2d", "Conv2dNHWC",
           "ConvTranspose2dNHWC", "LayerNorm2d"]


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
