"""The port's multi-resolution noise vs the JAX package's: the same draws
(made by jax.random as the JAX function makes them, then handed to the port)
give the same noise, <= 1e-5, for the four strategies, with and without the
DDPM trainer's per-sample annealing; and the result has unit population
std."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.utils.multi_res_noise import \
    multi_res_noise_like as jax_multi_res_noise_like
from amodal_depth_anything_tpu_torch.utils.multi_res_noise import (
    multi_res_noise_like, multi_res_noise_shapes)
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-5
STRATEGIES = ("original", "every_layer", "power_of_two", "random_step")
SHAPE = (2, 24, 20, 4)


def jax_draws(key, shapes):
    """The draws `multi_res_noise_like` makes from `key`: split into 16,
    the full-resolution one from the first key, scale i from key i + 1."""
    keys = jax.random.split(key, 16)
    return [np.array(jax.random.normal(k, s, jnp.float32))
            for k, s in zip(keys, shapes)]


@pytest.mark.parametrize("annealed", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_multi_res_noise_matches_jax(strategy, annealed):
    key = jax.random.PRNGKey(5)
    x = np.zeros(SHAPE, np.float32)
    ann = np.array([0.3, 0.9], np.float32).reshape(2, 1, 1, 1) \
        if annealed else None
    ref = np.asarray(jax_multi_res_noise_like(
        key, jnp.asarray(x), strength=0.8, downscale_strategy=strategy,
        annealed_t=None if ann is None else jnp.asarray(ann)))
    shapes = multi_res_noise_shapes(SHAPE, strategy)
    assert len(shapes) > 1 and shapes[0] == SHAPE
    ours = multi_res_noise_like(
        [torch.from_numpy(d) for d in jax_draws(key, shapes)],
        torch.from_numpy(x), strength=0.8, downscale_strategy=strategy,
        annealed_t=None if ann is None else torch.from_numpy(ann)).numpy()
    assert ours.shape == ref.shape == SHAPE
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_multi_res_noise_has_unit_population_std(strategy):
    x = torch.zeros(SHAPE)
    noise = multi_res_noise_like(torch.Generator().manual_seed(0), x,
                                 downscale_strategy=strategy)
    assert noise.shape == SHAPE and noise.dtype == x.dtype
    assert abs(noise.std(correction=0).item() - 1.0) <= 1e-5
    assert abs(noise.std(correction=1).item() - 1.0) > 1e-5
    with pytest.raises(ValueError, match="shapes"):
        multi_res_noise_like([torch.zeros(SHAPE)], x,
                             downscale_strategy=strategy)


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown strategy"):
        multi_res_noise_like(torch.Generator(), torch.zeros(SHAPE),
                             downscale_strategy="nope")
