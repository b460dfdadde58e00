"""Scale/shift depth alignment.

The reference fits pred -> gt with `np.linalg.lstsq([pred, 1], gt)` on
the host (`src/util/alignment.py:7-54`), round-tripping device tensors to
the CPU inside the train step for the ssi loss strategies. A 1-D
least-squares fit has a closed form: solve the 2x2 normal equations. As in
the JAX package that runs on the device, masked and differentiable.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fit_scale_shift", "align_depth_least_square",
           "align_depth_least_square_np", "depth2disparity"]


def fit_scale_shift(pred, gt, valid_mask=None, *, eps: float = 1e-12):
    """Closed-form masked least squares: returns (scale, shift) minimizing
    ||scale*pred + shift - gt||^2 over valid pixels. Batched over leading
    axes; reduction is over the trailing (-1, -2) axes."""
    p = pred.float()
    g = gt.float()
    m = torch.ones_like(p) if valid_mask is None else valid_mask.float()
    axes = (-1, -2)
    n = m.sum(dim=axes)
    sp = (p * m).sum(dim=axes)
    sg = (g * m).sum(dim=axes)
    spp = (p * p * m).sum(dim=axes)
    spg = (p * g * m).sum(dim=axes)
    det = n * spp - sp * sp
    scale = (n * spg - sp * sg) / (det + eps)
    shift = (sg - scale * sp) / n.clamp_min(1.0)
    return scale, shift


def align_depth_least_square(gt, pred, valid_mask=None, *,
                             return_scale_shift: bool = True):
    """On-device equivalent of the reference API (gt-first argument order,
    `alignment.py:7`): returns pred*scale + shift (and optionally s, t)."""
    scale, shift = fit_scale_shift(pred, gt, valid_mask)
    aligned = pred * scale[..., None, None] + shift[..., None, None] \
        if scale.dim() else pred * scale + shift
    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def align_depth_least_square_np(gt, pred, valid_mask,
                                return_scale_shift: bool = True):
    """Host numpy version (exact lstsq) for eval-protocol parity checks."""
    valid = np.asarray(valid_mask).squeeze().astype(bool)
    gt_m = np.asarray(gt).squeeze()[valid]
    pred_m = np.asarray(pred).squeeze()[valid]
    a = np.stack([pred_m, np.ones_like(pred_m)], axis=-1)
    x, *_ = np.linalg.lstsq(a, gt_m[:, None], rcond=None)
    scale, shift = float(x[0, 0]), float(x[1, 0])
    aligned = np.asarray(pred) * scale + shift
    if return_scale_shift:
        return aligned, scale, shift
    return aligned


def depth2disparity(depth, return_mask: bool = False):
    """Safe reciprocal (reference `alignment.py:58-69`)."""
    mask = depth > 0
    disp = torch.where(mask, 1.0 / torch.where(mask, depth, 1.0), 0.0)
    if return_mask:
        return disp, mask
    return disp
