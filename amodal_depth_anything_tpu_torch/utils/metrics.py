"""Depth evaluation metric suite + MetricTracker.

The 10-metric protocol of the reference (`src/util/metric.py:37-161`,
selected in `config/train_discriminative_vitl.yaml:74-87`): abs_rel,
sq_rel, rmse_linear, rmse_log, log10, delta1/2/3, i_rmse, silog_rmse.
Mask semantics follow the reference exactly: zero invalid elements,
normalize per-sample by the valid count over (-1,-2), then batch-mean
(log10 is a flat masked mean).

The core metrics are torch functions that run batched on the device; edge
metrics (EdgeAcc/EdgeComp/soft_edge_error) are host-side numpy/scipy --
they need connected hysteresis and euclidean distance transforms, which
are pointer-chasing algorithms.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MetricTracker", "get_metric", "compute_metrics",
           "compute_metrics_per_sample", "METRIC_FNS",
           "edge_acc", "edge_comp", "soft_edge_error"]

_HW = (-1, -2)


def _per_sample_norm(x, valid_mask):
    if valid_mask is not None:
        m = valid_mask.to(x.dtype)
        x = x * m
        n = m.sum(dim=_HW).clamp_min(1.0)
    else:
        n = float(x.shape[-1] * x.shape[-2])
    return x.sum(dim=_HW) / n


def _finite_or_zero(d):
    return torch.where(torch.isfinite(d), d, 0.0)


# Per-sample forms: [..., H, W] -> [...]. Each batch metric below is built
# on one, and `compute_metrics_per_sample` returns them as they are.

def _ps_abs_rel(pred, gt, valid_mask=None):
    return _per_sample_norm((pred - gt).abs() / gt, valid_mask)


def _ps_sq_rel(pred, gt, valid_mask=None):
    return _per_sample_norm((pred - gt).square() / gt, valid_mask)


def _ps_rmse_linear(pred, gt, valid_mask=None):
    return torch.sqrt(_per_sample_norm((pred - gt).square(), valid_mask))


def _ps_rmse_log(pred, gt, valid_mask=None):
    d = _finite_or_zero(torch.log(pred) - torch.log(gt))
    return torch.sqrt(_per_sample_norm(d.square(), valid_mask))


def _ps_log10(pred, gt, valid_mask=None):
    d = (torch.log10(pred) - torch.log10(gt)).abs()
    if valid_mask is None:
        return d.mean(dim=_HW)
    m = valid_mask.to(d.dtype)
    d = torch.where(valid_mask.bool(), d, 0.0)
    return (d * m).sum(dim=_HW) / m.sum(dim=_HW).clamp_min(1.0)


def _ps_threshold(thresh: float):
    def per_sample(pred, gt, valid_mask=None):
        ratio = torch.maximum(pred / gt, gt / pred)
        return _per_sample_norm((ratio < thresh).float(), valid_mask)
    return per_sample


def _ps_i_rmse(pred, gt, valid_mask=None):
    d = _finite_or_zero(1.0 / pred - 1.0 / gt)
    return torch.sqrt(_per_sample_norm(d.square(), valid_mask))


def _silog_terms(pred, gt, valid_mask):
    d = _finite_or_zero(torch.log(pred) - torch.log(gt))
    if valid_mask is not None:
        m = valid_mask.to(d.dtype)
        d = d * m
        n = m.sum(dim=_HW).clamp_min(1.0)
    else:
        n = float(gt.shape[-1] * gt.shape[-2])
    return d.square().sum(dim=_HW) / n - d.sum(dim=_HW).square() / (n * n)


def _ps_silog_rmse(pred, gt, valid_mask=None):
    return torch.sqrt(_silog_terms(pred, gt, valid_mask)) * 100.0


_PER_SAMPLE = {
    "abs_relative_difference": _ps_abs_rel,
    "squared_relative_difference": _ps_sq_rel,
    "rmse_linear": _ps_rmse_linear,
    "rmse_log": _ps_rmse_log,
    "log10": _ps_log10,
    "delta1_acc": _ps_threshold(1.25),
    "delta2_acc": _ps_threshold(1.25 ** 2),
    "delta3_acc": _ps_threshold(1.25 ** 3),
    "i_rmse": _ps_i_rmse,
    "silog_rmse": _ps_silog_rmse,
}


def _batch_mean(name: str):
    per_sample = _PER_SAMPLE[name]

    def metric(pred, gt, valid_mask=None):
        return per_sample(pred, gt, valid_mask).mean()
    metric.__name__ = name
    return metric


def log10(pred, gt, valid_mask=None):
    """A flat masked mean over the whole batch, not a mean of samples."""
    d = (torch.log10(pred) - torch.log10(gt)).abs()
    if valid_mask is None:
        return d.mean()
    m = valid_mask.to(d.dtype)
    d = torch.where(valid_mask.bool(), d, 0.0)
    return (d * m).sum() / m.sum().clamp_min(1.0)


def silog_rmse(pred, gt, valid_mask=None):
    """The root of the batch mean, not the mean of the samples' roots."""
    return torch.sqrt(_silog_terms(pred, gt, valid_mask).mean()) * 100.0


METRIC_FNS = {name: _batch_mean(name) for name in _PER_SAMPLE}
METRIC_FNS["log10"] = log10
METRIC_FNS["silog_rmse"] = silog_rmse


def get_metric(name: str):
    if name in METRIC_FNS:
        return METRIC_FNS[name]
    if name in _HOST_METRICS:
        return _HOST_METRICS[name]
    raise ValueError(f"unknown metric {name!r}")


def compute_metrics(pred, gt, valid_mask=None, names=None) -> dict:
    """Compute the on-device metric suite for one batch."""
    names = names or list(METRIC_FNS)
    return {n: METRIC_FNS[n](pred, gt, valid_mask) for n in names}


def compute_metrics_per_sample(pred, gt, valid_mask=None, names=None):
    """Whole-suite per-SAMPLE metrics of a batch.

    pred/gt [B,H,W] (valid_mask [B,H,W] bool) -> [B, len(names)] f32. Each
    row is what every metric gives on that sample alone (the batch-mean in
    the metric definitions collapses over a batch of one), computed for the
    whole batch at once with no loop over samples."""
    names = names or list(METRIC_FNS)
    return torch.stack([_PER_SAMPLE[n](pred, gt, valid_mask).float()
                        for n in names], dim=-1)


class MetricTracker:
    """Running totals/averages per key (reference `metric.py:13-34`)."""

    def __init__(self, *keys):
        self._keys = list(keys)
        self.reset()

    def reset(self):
        self._total = {k: 0.0 for k in self._keys}
        self._counts = {k: 0 for k in self._keys}

    def update(self, key: str, value: float, n: int = 1):
        if key not in self._total:
            self._keys.append(key)
            self._total[key] = 0.0
            self._counts[key] = 0
        self._total[key] += float(value) * n
        self._counts[key] += n

    def avg(self, key: str) -> float:
        c = self._counts.get(key, 0)
        return self._total.get(key, 0.0) / c if c else float("nan")

    def result(self) -> dict:
        return {k: self.avg(k) for k in self._keys}


# ------------------------------------------------------------- edge metrics
# Host-side: canny + EDT (reference `metric.py:181-328`; skimage.feature.canny
# there — reimplemented here on numpy/scipy since skimage isn't in the image).

def _canny(img: np.ndarray, sigma: float = 1.0,
           low_q: float = 0.1, high_q: float = 0.2) -> np.ndarray:
    """Canny edges on a float image (gaussian -> sobel -> NMS -> hysteresis).

    Thresholds follow skimage defaults: fractions of the gradient-magnitude
    max (low 0.1, high 0.2)."""
    from scipy import ndimage

    img = np.nan_to_num(img.astype(np.float64), neginf=0.0, posinf=0.0)
    sm = ndimage.gaussian_filter(img, sigma)
    gx = ndimage.sobel(sm, axis=1)
    gy = ndimage.sobel(sm, axis=0)
    mag = np.hypot(gx, gy)
    if mag.max() > 0:
        low, high = low_q * mag.max(), high_q * mag.max()
    else:
        return np.zeros_like(img, bool)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180
    nms = np.zeros_like(mag)
    h, w = mag.shape
    # quantize direction to 4 sectors and suppress non-maxima
    sector = ((ang + 22.5) // 45).astype(int) % 4
    offs = {0: (0, 1), 1: (-1, 1), 2: (-1, 0), 3: (-1, -1)}
    padded = np.pad(mag, 1, mode="constant")
    for s, (dy, dx) in offs.items():
        sel = sector == s
        n1 = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        n2 = padded[1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
        keep = (mag >= n1) & (mag >= n2)
        nms[sel & keep] = mag[sel & keep]
    strong = nms >= high
    weak = nms >= low
    # hysteresis: keep weak components connected to strong pixels
    labels, n = ndimage.label(weak, structure=np.ones((3, 3)))
    if n == 0:
        return strong
    keep_ids = np.unique(labels[strong])
    keep_ids = keep_ids[keep_ids > 0]
    return np.isin(labels, keep_ids)


def _extract_edges(depth: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    # 'log' preprocess of the reference (metric.py:199-210)
    d = np.asarray(depth, np.float64).squeeze()
    eps = np.finfo(np.float32).eps
    d = (d > 0) * np.log(np.clip(d, eps, None))
    return _canny(d, sigma=sigma)


def _edge_distances(pred, gt, valid_mask):
    from scipy import ndimage

    pred_edges = _extract_edges(pred)
    gt_edges = _extract_edges(gt)
    d_target = ndimage.distance_transform_edt(~gt_edges)
    d_pred = ndimage.distance_transform_edt(~pred_edges)
    invalid = ~np.asarray(valid_mask, bool).squeeze()
    gt_edges = gt_edges & ~invalid
    pred_edges = pred_edges & ~invalid
    return pred_edges, gt_edges, d_target, d_pred


def edge_acc(pred, gt, valid_mask, th_acc: float = 10.0) -> float:
    pred_edges, _gt_edges, d_target, _d_pred = _edge_distances(pred, gt, valid_mask)
    close = pred_edges & (d_target < th_acc)
    return float(d_target[close].mean()) if close.sum() else float(th_acc)


def edge_comp(pred, gt, valid_mask, th_comp: float = 10.0) -> float:
    pred_edges, gt_edges, d_target, d_pred = _edge_distances(pred, gt, valid_mask)
    close = pred_edges & (d_target < th_comp)
    return float(d_pred[gt_edges].mean()) if close.sum() else float(th_comp)


def soft_edge_error(pred, gt, valid_mask, radius: int = 1) -> float:
    pred = np.asarray(pred, np.float64).squeeze()
    gt = np.asarray(gt, np.float64).squeeze()
    h, w = gt.shape
    best = np.full_like(pred, np.inf)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = np.zeros_like(gt)
            ys = slice(max(dy, 0), h + min(dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            ys_src = slice(max(-dy, 0), h + min(-dy, 0))
            xs_src = slice(max(-dx, 0), w + min(-dx, 0))
            shifted[ys, xs] = gt[ys_src, xs_src]
            best = np.minimum(best, np.abs(shifted - pred))
    m = np.asarray(valid_mask, bool).squeeze()
    return float(best[m].mean())


_HOST_METRICS = {
    "edge_acc": edge_acc,
    "edge_comp": edge_comp,
    "soft_edge_error": soft_edge_error,
}
