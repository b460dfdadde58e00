"""The port's training utilities vs the JAX package's and optax, on the
same seeded numpy inputs, f32: every loss, the scale/shift fit, the
schedule, the metric suite and one optimizer update. Tolerance 1e-6,
relative to the value where it exceeds 1 (sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.train.state import \
    make_optimizer as jax_make_optimizer
from amodal_depth_anything_tpu.utils import alignment as jalign
from amodal_depth_anything_tpu.utils import loss as jloss
from amodal_depth_anything_tpu.utils import metrics as jmetrics
from amodal_depth_anything_tpu.utils.depth_transform import \
    get_depth_normalizer as jax_get_depth_normalizer
from amodal_depth_anything_tpu.utils.lr_schedule import \
    iter_exponential as jax_iter_exponential
from amodal_depth_anything_tpu_torch.train.state import (
    clip_by_global_norm, make_optimizer)
from amodal_depth_anything_tpu_torch.utils import alignment as talign
from amodal_depth_anything_tpu_torch.utils import loss as tloss
from amodal_depth_anything_tpu_torch.utils import metrics as tmetrics
from amodal_depth_anything_tpu_torch.utils.depth_transform import \
    get_depth_normalizer
from amodal_depth_anything_tpu_torch.utils.lr_schedule import iter_exponential
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-6


def _close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.isfinite(ours).all()
    err = np.abs(ours - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _depths(seed=0, b=3, h=20, w=24):
    rng = np.random.default_rng(seed)
    pred = rng.random((b, h, w), dtype=np.float32) * 0.9 + 0.05
    gt = rng.random((b, h, w), dtype=np.float32) * 0.9 + 0.05
    mask = rng.random((b, h, w)) > 0.4
    return pred, gt, mask


LOSS_CASES = [("silog_loss", {"beta": 0.15}), ("silog_mse", {}),
              ("silog_mse", {"log_pred": False, "batch_reduction": False}),
              ("silog_rmse", {"log_pred": False}), ("l1_loss_with_mask", {}),
              ("mse_loss", {}), ("l1_loss", {})]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name,kwargs", LOSS_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(LOSS_CASES)])
def test_loss_and_its_gradient_match_jax(name, kwargs, masked):
    pred, gt, mask = _depths(seed=1)
    jfn, tfn = jloss.get_loss(name, **kwargs), tloss.get_loss(name, **kwargs)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref, ref_grad = jax.value_and_grad(
        lambda p: jnp.sum(jfn(p, jnp.asarray(gt), jm)))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    ours = tfn(tp, torch.from_numpy(gt), tm)
    _close(ours, jfn(jnp.asarray(pred), jnp.asarray(gt), jm))
    ours.sum().backward()
    _close(tp.grad, ref_grad)


def test_mean_abs_rel_and_unknown_loss():
    pred, gt, _ = _depths(seed=2)
    _close(tloss.get_loss("mean_abs_rel")(torch.from_numpy(pred),
                                          torch.from_numpy(gt)),
           jloss.get_loss("mean_abs_rel")(jnp.asarray(pred), jnp.asarray(gt)))
    with pytest.raises(ValueError, match="unknown loss"):
        tloss.get_loss("nope")
    assert set(tloss._LOSSES) == set(jloss._LOSSES)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_fit_scale_shift_and_alignment_match_jax(masked):
    pred, gt, mask = _depths(seed=3)
    gt = 1.7 * pred + 0.2 + 0.05 * gt
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref = jalign.fit_scale_shift(jnp.asarray(pred), jnp.asarray(gt), jm)
    ours = talign.fit_scale_shift(torch.from_numpy(pred),
                                  torch.from_numpy(gt), tm)
    for a, r in zip(ours, ref):
        _close(a, r, 1e-5)  # the 2x2 solve cancels: n*spp - sp*sp
    ref = jalign.align_depth_least_square(jnp.asarray(gt), jnp.asarray(pred),
                                          jm)
    ours = talign.align_depth_least_square(torch.from_numpy(gt),
                                           torch.from_numpy(pred), tm)
    for a, r in zip(ours, ref):
        _close(a, r, 1e-5)
    # the host lstsq is numpy on both sides: identical
    a = talign.align_depth_least_square_np(gt[0], pred[0], mask[0])
    r = jalign.align_depth_least_square_np(gt[0], pred[0], mask[0])
    np.testing.assert_array_equal(a[0], r[0])
    assert a[1:] == r[1:]


def test_depth2disparity_matches_jax():
    depth = np.array([[0.0, 0.5, 2.0], [-1.0, 4.0, 0.25]], np.float32)
    disp, mask = talign.depth2disparity(torch.from_numpy(depth), True)
    rdisp, rmask = jalign.depth2disparity(jnp.asarray(depth), True)
    _close(disp, rdisp)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))


@pytest.mark.parametrize("total,final,warmup", [(50000, 0.01, 100),
                                                (100, 0.01, 2), (30, 0.1, 0)])
def test_iter_exponential_matches_jax(total, final, warmup):
    ours = iter_exponential(3e-5, total, final, warmup)
    ref = jax_iter_exponential(3e-5, total, final, warmup)
    steps = [0, 1, 2, warmup, warmup + 1, total // 2, total - 1, total,
             total + 10]
    for step in steps:
        r = float(ref(step))
        assert abs(ours(step) - r) <= TOL * max(abs(r), 1e-30), step
    assert ours(0) == (0.0 if warmup else pytest.approx(3e-5))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("name", list(jmetrics.METRIC_FNS))
def test_metric_matches_jax(name, masked):
    pred, gt, mask = _depths(seed=4)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    _close(tmetrics.get_metric(name)(torch.from_numpy(pred),
                                     torch.from_numpy(gt), tm),
           jmetrics.get_metric(name)(jnp.asarray(pred), jnp.asarray(gt), jm))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_metrics_per_sample_match_jax(masked):
    pred, gt, mask = _depths(seed=5)
    pred[1, :3, :3] = 0.0        # log / reciprocal of 0: the finite guards
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    ref = jmetrics.compute_metrics_per_sample(jnp.asarray(pred) + 1e-5,
                                              jnp.asarray(gt) + 1e-5, jm)
    ours = tmetrics.compute_metrics_per_sample(torch.from_numpy(pred) + 1e-5,
                                               torch.from_numpy(gt) + 1e-5, tm)
    assert ours.shape == (3, len(tmetrics.METRIC_FNS))
    _close(ours, ref)
    assert list(tmetrics.METRIC_FNS) == list(jmetrics.METRIC_FNS)


def test_host_edge_metrics_and_tracker_match_jax():
    rng = np.random.default_rng(6)
    gt = np.full((40, 40), 0.3, np.float32)
    gt[10:30, 12:28] = 0.8
    pred = gt + 0.02 * rng.standard_normal(gt.shape).astype(np.float32)
    valid = np.ones_like(gt, bool)
    for name in ("edge_acc", "edge_comp", "soft_edge_error"):
        assert tmetrics.get_metric(name)(pred, gt, valid) == \
            jmetrics.get_metric(name)(pred, gt, valid)
    ours, ref = tmetrics.MetricTracker("a"), jmetrics.MetricTracker("a")
    for tracker in (ours, ref):
        tracker.update("a", 1.0)
        tracker.update("a", 4.0, n=3)
        tracker.update("b", 2.0)
    assert ours.result() == ref.result()
    assert np.isnan(tmetrics.MetricTracker("x").avg("x"))


def test_depth_normalizers_match_jax():
    rng = np.random.default_rng(7)
    depth = rng.random((16, 16, 1), dtype=np.float32) * 5.0
    depth[:2] = 0.0
    valid = depth > 0.1
    cfg = {"type": "scale_shift_depth", "norm_min": -1.0, "norm_max": 1.0,
           "min_max_quantile": 0.02, "clip": True}
    ours, ref = get_depth_normalizer(cfg), jax_get_depth_normalizer(cfg)
    _close(ours(depth, valid), ref(jnp.asarray(depth), jnp.asarray(valid)),
           1e-5)
    assert ours.norm_max == ref.norm_max and ours.far_plane_at_max
    sam = get_depth_normalizer({"type": "sam_depth"})
    assert sam(depth) is depth


def _optimizer_inputs(seed, n_steps):
    rng = np.random.default_rng(seed)
    # keys in sorted order: JAX flattens a dict by sorted key
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal((11,)).astype(np.float32)}
    # the norm is far above the clip's 0.01 except at step 1
    grads = [{k: (rng.standard_normal(v.shape) *
                  (1e-4 if i == 1 else 1.0)).astype(np.float32)
              for k, v in params.items()} for i in range(n_steps)]
    return params, grads


@pytest.mark.parametrize("accumulation", [1, 3])
def test_optimizer_update_matches_optax(accumulation):
    """clip_by_global_norm + Adam under the schedule (and MultiSteps): every
    update against optax's on the same gradients. Adam's update does not read
    the parameters, so the port starts each step from zeros and its
    parameters then ARE the update: held to optax's within 1e-5 of its max
    abs (a few float32 roundings), and added to optax's parameters within
    1e-6."""
    kw = dict(lr=3e-3, total_iter=50, final_ratio=0.01, warmup_steps=2,
              max_grad_norm=0.01, accumulation_steps=accumulation)
    n_steps = 4 * accumulation
    p0, grads = _optimizer_inputs(8, n_steps)
    jtx, ttx = jax_make_optimizer(**kw), make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jtx.init(jparams)
    tparams = [torch.from_numpy(v.copy()) for v in p0.values()]
    tstate = ttx.init(tparams)
    moved = []
    for g in grads:
        before = [np.array(v) for v in jparams.values()]
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate,
                                     jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for t in tparams:
            t.zero_()
        moved.append(ttx.update(
            tparams, [torch.from_numpy(v.copy()) for v in g.values()],
            tstate))
        for t, u, r, b in zip(tparams, updates.values(), jparams.values(),
                              before):
            u = np.asarray(u)
            assert np.abs(t.numpy() - u).max() <= 1e-5 * np.abs(u).max()
            _close(torch.from_numpy(b) + t, r)
    assert moved == [(i + 1) % accumulation == 0 for i in range(n_steps)]
    # lr(0) = 0 under a warmup: the first effective update moves nothing
    assert tstate["count"] == 4


def test_clip_is_optax_formula_not_torch_clip_grad_norm():
    rng = np.random.default_rng(9)
    g = [rng.standard_normal((4, 4)).astype(np.float32) * 1e-2]
    norm = float(np.linalg.norm(g[0]))
    ours = [torch.from_numpy(g[0].copy())]
    clip_by_global_norm(ours, 0.01)
    np.testing.assert_allclose(ours[0].numpy(), g[0] / norm * 0.01,
                               rtol=1e-6)
    # clip_grad_norm_ divides by (norm + 1e-6): off by 1e-6 / norm, far above
    # float32 rounding at this clip
    torch_clip = g[0] * (0.01 / (norm + 1e-6))
    assert np.abs(torch_clip - ours[0].numpy()).max() > \
        10 * np.abs(ours[0].numpy() - g[0] / norm * 0.01).max()
    small = [torch.full((3,), 1e-4)]
    clip_by_global_norm(small, 0.01)
    assert torch.equal(small[0], torch.full((3,), 1e-4))

