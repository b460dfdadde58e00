"""Training losses (mask-aware, differentiable torch functions).

Functional equivalents of the reference loss bank
(`src/util/loss.py:7-139`), ported from the JAX package's `utils/loss.py`:
SILog pixel loss (the configured training loss, beta=0.15 --
`config/train_discriminative_vitl.yaml:48-52`), SILog-MSE / SILog-RMSE,
masked L1, mean-abs-rel, plain MSE/L1.

All losses are functions of (pred, gt[, valid_mask]) returning a scalar;
masking multiplies by the mask (never boolean indexing), as in the JAX
package, so both sum the same terms.

Data parallelism: inside `parallel.comm.data_reduction(group)` every sum
and mean over the batch runs over the global batch (`batch_sum`), so each
data rank computes the loss of the whole batch from its rows, as the JAX
package's one SPMD program does; outside it the expressions are the
single-process ones.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.comm import batch_count, batch_sum, reduction_group

__all__ = ["get_loss", "silog_loss", "silog_mse_loss", "silog_rmse_loss",
           "l1_loss_with_mask", "mean_abs_rel_loss", "mse_loss", "l1_loss",
           "masked_mean"]

_EPS = 1e-7
_HW = (-1, -2)


def masked_mean(x, mask=None, axis=_HW):
    if mask is None:
        return x.mean(dim=axis)
    m = mask.to(x.dtype)
    return (x * m).sum(dim=axis) / m.sum(dim=axis).clamp_min(1.0)


def _batch_mean(x, dim=None):
    """Mean over the batch (`dim=0`) or over every element (None), of the
    global batch under a data reduction."""
    if reduction_group() is None:
        return x.mean() if dim is None else x.mean(dim=dim)
    if dim is None:
        n = batch_count(x, 0) * (x.numel() // max(x.shape[0], 1))
        return batch_sum(x.sum()) / n
    return batch_sum(x.sum(dim=dim)) / batch_count(x, dim)


def silog_loss(pred, gt, valid_mask=None, *, beta: float = 0.15):
    """10*sqrt(var(g) + beta*mean(g)^2), g = log(pred+eps)-log(gt+eps).

    The variance is unbiased (n-1), torch.var's default in the reference.
    With a mask, mean and variance run over the masked elements. sqrt has an
    infinite gradient at 0; the trainer's NaN guard covers that case."""
    g = torch.log(pred + _EPS) - torch.log(gt + _EPS)
    if valid_mask is None and reduction_group() is None:
        mean = g.mean()
        var = g.var(unbiased=True)
    else:
        m = torch.ones_like(g) if valid_mask is None \
            else valid_mask.to(g.dtype)
        n = batch_sum(m.sum()).clamp_min(1.0)
        mean = batch_sum((g * m).sum()) / n
        var = batch_sum(((g - mean).square() * m).sum()) / \
            (n - 1.0).clamp_min(1.0)
    return 10.0 * torch.sqrt(var + beta * mean.square())


def _masked_log_diff_terms(pred, gt, valid_mask, log_pred: bool):
    logp = pred if log_pred else torch.log(pred.clamp_min(1e-8))
    diff = logp - torch.log(gt)
    if valid_mask is not None:
        m = valid_mask.to(diff.dtype)
        diff = diff * m
        n = m.sum(dim=_HW)
    else:
        n = float(gt.shape[-1] * gt.shape[-2])
    first = diff.square().sum(dim=_HW) / n
    second_raw = diff.sum(dim=_HW).square() / (n * n)
    return first, second_raw


def silog_mse_loss(pred, gt, valid_mask=None, *, lamb: float = 0.5,
                   log_pred: bool = True, batch_reduction: bool = True):
    first, second = _masked_log_diff_terms(pred, gt, valid_mask, log_pred)
    loss = first - lamb * second
    return _batch_mean(loss, 0) if batch_reduction else loss


def silog_rmse_loss(pred, gt, valid_mask=None, *, lamb: float = 0.5,
                    alpha: float = 1.0, log_pred: bool = True):
    first, second = _masked_log_diff_terms(pred, gt, valid_mask, log_pred)
    return _batch_mean(torch.sqrt(first - lamb * second), 0) * alpha


def l1_loss_with_mask(pred, gt, valid_mask=None, *,
                      batch_reduction: bool = False):
    diff = pred - gt
    if valid_mask is not None:
        m = valid_mask.to(diff.dtype)
        diff = diff * m
        n = m.sum(dim=_HW)
    else:
        n = float(gt.shape[-1] * gt.shape[-2])
    loss = batch_sum(diff.abs().sum()) / n
    return _batch_mean(loss, 0) if batch_reduction else loss


def mean_abs_rel_loss(pred, gt):
    return _batch_mean(((pred - gt) / gt).abs(), 0)


def mse_loss(pred, gt, valid_mask=None):
    if valid_mask is None:
        return _batch_mean((pred - gt).square())
    return _batch_mean(masked_mean((pred - gt).square(), valid_mask))


def l1_loss(pred, gt, valid_mask=None):
    if valid_mask is None:
        return _batch_mean((pred - gt).abs())
    return _batch_mean(masked_mean((pred - gt).abs(), valid_mask))


_LOSSES = {
    "silog_loss": silog_loss,
    "silog_mse": silog_mse_loss,
    "silog_rmse": silog_rmse_loss,
    "l1_loss_with_mask": l1_loss_with_mask,
    "mean_abs_rel": mean_abs_rel_loss,
    "mse_loss": mse_loss,
    "l1_loss": l1_loss,
}


def get_loss(name: str, **kwargs):
    """Loss registry (reference `loss.py:7-25`). kwargs are bound."""
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(_LOSSES)}")
    fn = _LOSSES[name]
    return functools.partial(fn, **kwargs) if kwargs else fn
