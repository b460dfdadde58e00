"""Dataset difficulty census (reference `src/util/stats.py:130-187`).

A copy of the JAX package's `utils/stats.py`: samples are bucketed by
object size (object pixels / image pixels) and visibility ratio (visible
pixels / object pixels), with the eval protocol's thresholds (>0.75 easy /
>0.5 mid / else hard) and the object-size bands the reference reports.
"""

from __future__ import annotations

import numpy as np

__all__ = ["sample_difficulty", "dataset_census"]

SIZE_BANDS = ((0.0, 0.05, "small"), (0.05, 0.15, "medium"),
              (0.15, 1.01, "large"))


def sample_difficulty(guide_mask: np.ndarray, visible_mask: np.ndarray):
    """Returns (visibility_bucket, size_band, visibility_ratio, object_ratio)."""
    g = np.asarray(guide_mask) > 0
    v = np.asarray(visible_mask) > 0
    obj_px = float(g.sum())
    vis_ratio = float(v.sum()) / max(obj_px, 1.0)
    obj_ratio = obj_px / g.size
    bucket = "easy" if vis_ratio > 0.75 else "mid" if vis_ratio > 0.5 \
        else "hard"
    band = next(name for lo, hi, name in SIZE_BANDS if lo <= obj_ratio < hi)
    return bucket, band, vis_ratio, obj_ratio


def dataset_census(dataset, max_samples: int | None = None) -> dict:
    """Census over a SAMAmodalDataset-like dataset: counts per
    (visibility bucket x size band)."""
    counts: dict = {}
    n = len(dataset) if max_samples is None else min(len(dataset),
                                                     max_samples)
    for i in range(n):
        s = dataset[i]
        bucket, band, _, _ = sample_difficulty(s["guide"], s["visible_mask"])
        counts[(bucket, band)] = counts.get((bucket, band), 0) + 1
    return {f"{b}/{s}": c for (b, s), c in sorted(counts.items())}
