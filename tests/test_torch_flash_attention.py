"""Port flash-attention (plain version on the CPU) vs the JAX package's
Pallas kernel in interpret mode and its XLA reference.

The same seeded numpy inputs go to both packages; max abs <= 1e-5 (f32
softmax on both sides, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops.flash_attention import mha as jax_mha
from amodal_depth_anything_tpu.ops.flash_attention import \
    mha_reference as jax_mha_reference
from amodal_depth_anything_tpu_torch.ops.attention import multi_head_attention
from amodal_depth_anything_tpu_torch.ops.flash_attention import (
    mha, mha_reference)
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-5

# (batch, heads, n_q, n_k, kv_len, sm_scale)
CASES = [
    (1, 2, 200, 200, None, None),    # ragged N (not a multiple of 64/128)
    (2, 3, 37, 37, None, None),      # tiny ragged N, batch > 1
    (1, 2, 256, 256, 200, None),     # kv_len < N (model-level padding)
    (1, 2, 130, 130, None, 0.3),     # custom sm_scale
    (1, 2, 100, 150, None, None),    # cross attention, Nq != Nk
]


def _qkv(b, h, nq, nk, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale", CASES)
def test_mha_matches_jax_pallas_interpret(b, h, nq, nk, kv_len, scale):
    q, k, v = _qkv(b, h, nq, nk)
    ref = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, kv_len=kv_len, sm_scale=scale))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
               kv_len=kv_len, sm_scale=scale).numpy()
    assert ours.shape == (b, h, nq, 64)
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale", CASES)
def test_mha_reference_matches_jax_reference(b, h, nq, nk, kv_len, scale):
    q, k, v = _qkv(b, h, nq, nk, seed=1)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), kv_len=kv_len,
                                       sm_scale=scale))
    ours = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), kv_len=kv_len,
                         sm_scale=scale).numpy()
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("kv_len,scale", [(None, None), (150, None),
                                          (None, 0.2)])
def test_mha_lse_matches_jax_logsumexp(kv_len, scale):
    b, h, n = 1, 2, 180
    q, k, v = _qkv(b, h, n, n, seed=2)
    sc = 64 ** -0.5 if scale is None else scale
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q) * sc, jnp.asarray(k),
                   precision=jax.lax.Precision.HIGHEST)
    if kv_len is not None:
        s = s[..., :kv_len]
    ref_lse = np.asarray(jax.scipy.special.logsumexp(s, axis=-1))
    o, lse = mha(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), kv_len=kv_len, sm_scale=scale,
                 return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n)
    assert np.abs(lse.numpy() - ref_lse).max() <= TOL
    ref_o = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), kv_len=kv_len,
                                         sm_scale=scale))
    assert np.abs(o.numpy() - ref_o).max() <= TOL


def test_mha_plain_takes_other_head_dims():
    # the kernel takes D = 64 only; the CPU plain version any D
    q, k, v = _qkv(1, 2, 50, 50, d=32, seed=3)
    ref = np.asarray(jax_mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v)))
    ours = mha(torch.from_numpy(q), torch.from_numpy(k),
               torch.from_numpy(v)).numpy()
    assert np.abs(ours - ref).max() <= TOL


def test_cpu_never_counts_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 40, seed=4))
    before = mha.launches
    mha(q, k, v)
    multi_head_attention(q, k, v)
    multi_head_attention(q, k, v, impl="plain")
    assert mha.launches == before


def test_dispatch_defaults_to_plain_on_cpu_and_rejects_unknown():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 40, seed=5))
    torch.testing.assert_close(multi_head_attention(q, k, v),
                               mha_reference(q, k, v), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(q, k, v, impl="pallas")
