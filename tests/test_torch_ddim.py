"""The port's DDPM schedule and DDIM sampler vs the JAX package's.

The schedule, the forward process and the v target at t in {0, 499, 999},
<= 2e-6; `ddim_sample` with the same initial noise (drawn by jax.random and
handed to the port) and the same deterministic eps function, plain, guided,
joint (batch 2B) and under DeepCache, <= 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops import ddim as jddim
from amodal_depth_anything_tpu_torch.ops import ddim as tddim
from tests.test_torch_models import few_torch_threads  # noqa: F401

SCHEDULE_TOL = 2e-6
SAMPLE_TOL = 1e-5
SHAPE = (2, 6, 5, 4)


@pytest.mark.parametrize("betas", [(0.00085, 0.012), (0.0001, 0.02)])
def test_schedule_add_noise_and_velocity_match_jax(betas):
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (3, 4, 4, 2)).astype(np.float32)
    noise = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    t = np.array([0, 499, 999], np.int32)
    ref_ab = jddim.linear_alphas_cumprod(1000, *betas)
    ab = tddim.linear_alphas_cumprod(1000, *betas)
    assert ab.dtype == torch.float32 and ab.shape == (1000,)
    assert np.abs(ab.numpy() - np.asarray(ref_ab)).max() <= SCHEDULE_TOL
    args = (jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
    targs = (torch.from_numpy(x0), torch.from_numpy(noise),
             torch.from_numpy(t))
    for name in ("ddpm_add_noise", "ddpm_velocity"):
        ref = np.asarray(getattr(jddim, name)(ref_ab, *args))
        ours = getattr(tddim, name)(ab, *targs).numpy()
        assert np.abs(ours - ref).max() <= SCHEDULE_TOL, name


def _eps_fns(tanh, as_float, cat):
    """Deterministic stand-ins for the UNet: eps from x and t, with the
    DeepCache contract (a full pass returns (eps, deep); a spliced pass
    takes the kept deep feature). `scale` tells the conditional (1) and the
    unconditional (0.5) prediction apart."""
    def make(scale):
        def eps(x, t, deep_cache_groups=None, cached_deep=None):
            tt = as_float(t)[:, None, None, None] / 1000.0
            deep = tanh(0.7 * x + tt) if cached_deep is None else cached_deep
            y = scale * deep + 0.1 * x * tt
            if deep_cache_groups is not None and cached_deep is None:
                return y, deep
            return y
        return eps

    cond, uncond = make(1.0), make(0.5)

    def joint(x2, t2, **dc):
        b = x2.shape[0] // 2
        return cat([cond(x2[:b], t2[:b]), uncond(x2[b:], t2[b:])])

    return cond, uncond, joint


JAX_FNS = _eps_fns(jnp.tanh, lambda t: t.astype(jnp.float32),
                   jnp.concatenate)
TORCH_FNS = _eps_fns(torch.tanh, lambda t: t.float(), torch.cat)


def _sample(mod, fns, rng, guided=None, **kw):
    cond, uncond, joint = fns
    if guided == "separate":
        kw.update(guidance_scale=3.0, uncond_fn=uncond)
    elif guided == "joint":
        kw.update(guidance_scale=3.0, joint_fn=joint)
    return np.asarray(mod.ddim_sample(cond, rng, SHAPE, num_steps=10, **kw))


@pytest.mark.parametrize("guided,deep_cache", [
    (None, None), ("separate", None), ("joint", None), (None, (1, 2)),
    (None, (2, 2)), ("separate", (5, 1))])
def test_ddim_sample_matches_jax(guided, deep_cache):
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    ref = _sample(jddim, JAX_FNS, key, guided, deep_cache=deep_cache)
    noise = torch.from_numpy(noise)
    ours = _sample(tddim, TORCH_FNS, noise, guided, deep_cache=deep_cache)
    assert ours.shape == ref.shape == SHAPE
    assert np.isfinite(ref).all() and ref.std() > 0.1
    assert np.abs(ours - ref).max() <= SAMPLE_TOL
    if deep_cache == (1, 2):
        # one step per interval: every step is a full pass, as without it
        plain = _sample(tddim, TORCH_FNS, noise, guided)
        np.testing.assert_array_equal(ours, plain)


def test_ddim_sample_draws_from_a_generator_and_checks_its_inputs():
    cond = TORCH_FNS[0]
    a = tddim.ddim_sample(cond, torch.Generator().manual_seed(0), SHAPE,
                          num_steps=4)
    b = tddim.ddim_sample(cond, torch.randn(
        SHAPE, generator=torch.Generator().manual_seed(0)), SHAPE,
        num_steps=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="must divide"):
        tddim.ddim_sample(cond, torch.zeros(SHAPE), SHAPE, num_steps=10,
                          deep_cache=(3, 1))
    with pytest.raises(ValueError, match="shape"):
        tddim.ddim_sample(cond, torch.zeros(1, 2), SHAPE, num_steps=4)
