"""Port flash-attention backward on the CPU (`mha_bwd_reference`, and the
`autograd.Function` that takes it there) vs `jax.grad` of the JAX package's
Pallas kernels in interpret mode and of its XLA reference.

The same seeded numpy inputs and cotangent go to both packages, f32, JAX at
Precision.HIGHEST; max abs <= 1e-5 (sums in another order). With
`kv_len < N` and Nq == Nk the query rows at or past kv_len are padding and
carry a zero cotangent, as `mha`'s contract demands. Every case runs at the
DINOv2 trunks' head dim 64; the SD-1.5 UNet's head dims 40, 80 and 160 run
at small N, self-attention and cross-attention onto its 77 context keys
(the Pallas kernels lane-pad d; the port's kernels pad it to 16, 32, 48,
64, 80 or 160 columns: both must equal plain attention at the true d)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops.flash_attention import mha as jax_mha
from amodal_depth_anything_tpu.ops.flash_attention import \
    mha_reference as jax_mha_reference
from amodal_depth_anything_tpu_torch.ops import _build
from amodal_depth_anything_tpu_torch.ops import flash_attention as fa
from amodal_depth_anything_tpu_torch.ops.attention import multi_head_attention
from amodal_depth_anything_tpu_torch.ops.flash_attention import (
    mha, mha_bwd_reference, mha_reference)
from tests.test_torch_flash_attention import _OnCard
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-5

# (batch, heads, n_q, n_k, kv_len, sm_scale, head dim)
CASES = [
    (1, 2, 200, 200, None, None, 64),    # ragged N (not a multiple of 64/128)
    (2, 3, 37, 37, None, None, 64),      # tiny ragged N, batch > 1
    (1, 2, 256, 256, 200, None, 64),     # kv_len < N with Nq == Nk
    (1, 2, 130, 130, None, 0.3, 64),     # custom sm_scale
    (1, 2, 100, 150, None, None, 64),    # cross attention, Nq != Nk
    (1, 2, 100, 192, 150, None, 64),     # cross attention with masked keys
    (1, 2, 130, 130, None, None, 40),    # the UNet's head dims, small N
    (1, 2, 70, 70, 50, None, 80),
    (1, 2, 40, 40, None, None, 160),
    (1, 2, 100, 77, None, None, 40),     # cross attention onto 77 keys
]


def _inputs(b, h, nq, nk, kv_len, seed=0, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    do = rng.standard_normal((b, h, nq, d), dtype=np.float32)
    if kv_len is not None and nq == nk:
        do[:, :, kv_len:] = 0.0
    return q, k, v, do


def _jax_grads(fn, q, k, v, do, **kw):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, **kw) * do)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _check(ours, ref):
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        a = a.detach().numpy()
        assert a.shape == r.shape, name
        assert np.abs(a - r).max() <= TOL, (name, np.abs(a - r).max())


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale,d", CASES)
def test_bwd_reference_matches_jax_pallas_grad(b, h, nq, nk, kv_len, scale,
                                               d):
    q, k, v, do = _inputs(b, h, nq, nk, kv_len, d=d)
    ref = _jax_grads(jax_mha, q, k, v, do, interpret=True, kv_len=kv_len,
                     sm_scale=scale)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = mha_reference(tq, tk, tv, kv_len=kv_len, sm_scale=scale,
                           return_lse=True)
    _check(mha_bwd_reference(tq, tk, tv, o, lse, tdo, kv_len=kv_len,
                             sm_scale=scale), ref)
    if kv_len is not None:  # rows of dk, dv at or past kv_len: exactly 0
        _, dk, dv = mha_bwd_reference(tq, tk, tv, o, lse, tdo, kv_len=kv_len,
                                      sm_scale=scale)
        assert not dk[:, :, kv_len:].any() and not dv[:, :, kv_len:].any()


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale,d", CASES)
def test_mha_autograd_matches_jax_reference_grad(b, h, nq, nk, kv_len, scale,
                                                 d):
    q, k, v, do = _inputs(b, h, nq, nk, kv_len, seed=1, d=d)
    ref = _jax_grads(jax_mha_reference, q, k, v, do, kv_len=kv_len,
                     sm_scale=scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = mha(tq, tk, tv, kv_len=kv_len, sm_scale=scale)
    assert o.grad_fn is not None
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    if kv_len is not None:
        # the JAX reference has no mask on dk, dv rows past kv_len; they are
        # zero there because the softmax gives those keys no weight
        assert not grads[1][:, :, kv_len:].any()
    _check(grads, ref)


def test_mha_cpu_gradient_takes_the_plain_backward(monkeypatch):
    """On CPU tensors the registered backward runs the two backward ops'
    CPU implementations, the plain arithmetic (`_bwd_plain`, once for dQ
    and once for dK/dV), no kernel is launched, and without a gradient
    there is no autograd node."""
    q, k, v, do = _inputs(1, 2, 40, 40, None, seed=2)
    calls = []
    plain = fa._bwd_plain
    monkeypatch.setattr(fa, "_bwd_plain",
                        lambda *a, **kw: calls.append(a[-2:])
                        or plain(*a, **kw))
    before = (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    multi_head_attention(tq, tk, tv).backward(torch.from_numpy(do))
    assert calls == [(True, False), (False, True)] and tq.grad is not None
    assert (mha.launches, mha.bwd_dq_launches, mha.bwd_dkv_launches) == before
    with torch.no_grad():
        assert mha(tq, tk, tv).grad_fn is None
    assert mha(tq.detach(), tk.detach(), tv.detach()).grad_fn is None


def test_mha_residuals_skip_the_second_forward(monkeypatch):
    """A filled `residuals` dict stands in for the forward: the recompute
    pass of a rematerialised block reuses the kept output and LSE."""
    q, k, v, do = _inputs(1, 2, 50, 50, None, seed=3)
    forwards = []
    monkeypatch.setattr(fa, "mha_reference",
                        lambda *a, **kw: forwards.append(1)
                        or mha_reference(*a, **kw))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    kept: dict = {}
    o1 = mha(tq, tk, tv, residuals=kept)
    assert set(kept) == {"o", "lse"} and len(forwards) == 1
    o2 = mha(tq, tk, tv, residuals=kept)
    assert len(forwards) == 1 and torch.equal(o1, o2)
    g1 = torch.autograd.grad(o1, (tq, tk, tv), torch.from_numpy(do))
    g2 = torch.autograd.grad(o2, (tq, tk, tv), torch.from_numpy(do))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_plain_impl_differentiates_mha_reference():
    q, k, v, do = _inputs(1, 2, 33, 33, None, seed=4)
    grads = []
    for impl in (None, "plain"):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        o = multi_head_attention(tq, tk, tv, impl=impl)
        grads.append(torch.autograd.grad(o, (tq, tk, tv),
                                         torch.from_numpy(do)))
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= TOL


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.bfloat16, 8, True), (torch.bfloat16, 40, True),
    (torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
    (torch.bfloat16, 160, True), (torch.float32, 12, True),
    (torch.float32, 160, True), (torch.bfloat16, 168, False),
    (torch.bfloat16, 44, False), (torch.float32, 164, False)])
def test_bwd_check_takes_the_forward_head_dim_rule(dtype, d, ok):
    """`_check_bwd` admits every head dim the forward takes (a multiple of
    the 16-byte vector, at most 160) and refuses the rest, before any
    launch, on stand-ins its checks see as CUDA tensors."""
    q = _OnCard((1, 2, 24, d), dtype)
    stat = _OnCard((1, 2, 24), torch.float32)
    if ok:
        fa._check_bwd(q, q, q, q, stat, stat, 24)
    else:
        with pytest.raises(ValueError, match="head dim"):
            fa._check_bwd(q, q, q, q, stat, stat, 24)


@pytest.mark.parametrize("dtype,d,names", [
    (torch.bfloat16, 64, ("flash_attn_bwd_dq_bf16_wgmma<4>",
                          "flash_attn_bwd_dkv_bf16_wgmma<4>")),
    (torch.bfloat16, 40, ("flash_attn_bwd_dq_bf16_wgmma<3>",
                          "flash_attn_bwd_dkv_bf16_wgmma<3>")),
    (torch.bfloat16, 80, ("flash_attn_bwd_dq_bf16<80>",
                          "flash_attn_bwd_dkv_bf16<80>")),
    (torch.bfloat16, 96, ("flash_attn_bwd_dq_bf16<160>",
                          "flash_attn_bwd_dkv_bf16<160>")),
    (torch.float32, 12, ("flash_attn_bwd_dq_f32<16>",
                         "flash_attn_bwd_dkv_f32<16>")),
    (torch.float32, 64, ("flash_attn_bwd_dq_f32<64>",
                         "flash_attn_bwd_dkv_f32<64>"))])
def test_bwd_instantiations_follow_the_source_table(dtype, d, names):
    assert fa.bwd_instantiations(dtype, d) == names
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    for name in names:   # each names a kernel template of the source
        assert f"\n{name.split('<')[0]}(" in src, name
