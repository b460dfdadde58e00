"""Depth blending: paste the amodal prediction into the base depth under the
mask and smooth the mask border with a box filter (reference
`infer.py:30-44`, JAX `ops/blend.py`).

cv2.blur's default border, BORDER_REFLECT_101, is `F.pad(mode="reflect")`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["box_blur", "median_filter_blend"]


def box_blur(x: torch.Tensor, width: int = 3) -> torch.Tensor:
    """Box filter over the (-3, -2) axes of an ...HWC tensor, REFLECT_101."""
    *lead, h, w, c = x.shape
    pad = width // 2
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    xp = F.pad(x4, (pad, pad, pad, pad), mode="reflect")
    kernel = torch.full((c, 1, width, width), 1.0 / (width * width),
                        dtype=x.dtype, device=x.device)
    y = F.conv2d(xp, kernel, groups=c)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, c)


def median_filter_blend(depth_amodal: torch.Tensor, depth_base: torch.Tensor,
                        mask: torch.Tensor, *,
                        filter_width: int = 3) -> torch.Tensor:
    """Composite amodal depth into base depth with border smoothing.

    All [B, H, W, 1]; mask > 0 is on. blended[mask] = amodal;
    border = 0 < dilate(mask) < w^2; blended[border] = boxblur(blended)."""
    mask = (mask > 0).to(depth_base.dtype)
    blended = torch.where(mask > 0, depth_amodal, depth_base)
    ones = torch.ones((1, 1, filter_width, filter_width),
                      dtype=mask.dtype, device=mask.device)
    dilated = F.conv2d(mask.permute(0, 3, 1, 2), ones,
                       padding=filter_width // 2).permute(0, 2, 3, 1)
    border = (dilated > 0) & (dilated < filter_width ** 2)
    return torch.where(border, box_blur(blended, filter_width), blended)
