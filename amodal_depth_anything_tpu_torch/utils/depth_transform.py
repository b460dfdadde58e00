"""Depth normalizers (reference `src/util/depth_transform.py:8-122`).

`scale_shift_depth`: quantile near/far planes mapped linearly to
[norm_min, norm_max] (used by the diffusion trainers); `sam_depth`:
identity -- the SAM pseudo-labels are already in [0, 1]. The data layer
calls them on host-side numpy rasters.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["get_depth_normalizer", "ScaleShiftDepthNormalizer", "SAMNormalizer"]


@dataclasses.dataclass
class ScaleShiftDepthNormalizer:
    norm_min: float = -1.0
    norm_max: float = 1.0
    min_max_quantile: float = 0.02
    clip: bool = True
    is_absolute = False
    far_plane_at_max = True

    def __call__(self, depth, valid_mask=None, clip=None):
        clip = self.clip if clip is None else clip
        depth = np.asarray(depth, np.float32)
        valid = depth > 0 if valid_mask is None else \
            (np.asarray(valid_mask) & (depth > 0))
        # masked quantiles: invalid pixels become NaN for nanquantile
        masked = np.where(valid, depth, np.nan)
        lo = np.nanquantile(masked, self.min_max_quantile)
        hi = np.nanquantile(masked, 1.0 - self.min_max_quantile)
        rng = self.norm_max - self.norm_min
        out = ((depth - lo) / (hi - lo) * rng + self.norm_min).astype(
            np.float32)
        if clip:
            out = np.clip(out, self.norm_min, self.norm_max)
        return out

    def scale_back(self, depth_norm):
        return (depth_norm - self.norm_min) / (self.norm_max - self.norm_min)

    def denormalize(self, depth_norm, **_):
        return self.scale_back(depth_norm)


@dataclasses.dataclass
class SAMNormalizer:
    is_absolute = False
    far_plane_at_max = True

    def __call__(self, depth, valid_mask=None, clip=None):
        return depth

    def denormalize(self, depth_norm, **_):
        return depth_norm


def get_depth_normalizer(cfg):
    if cfg is None:
        return lambda x, **_: x
    kind = cfg["type"] if isinstance(cfg, dict) else cfg.type
    if kind == "scale_shift_depth":
        get = (lambda k, d: cfg.get(k, d)) if isinstance(cfg, dict) \
            else (lambda k, d: getattr(cfg, k, d))
        return ScaleShiftDepthNormalizer(
            norm_min=get("norm_min", -1.0), norm_max=get("norm_max", 1.0),
            min_max_quantile=get("min_max_quantile", 0.02),
            clip=get("clip", True))
    if kind == "sam_depth":
        return SAMNormalizer()
    raise ValueError(f"unknown normalizer type: {kind}")
