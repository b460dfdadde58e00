"""The bf16 attention backward onto a short key set (`adat::
flash_attn_bwd_short`: kv_len <= SHORT_KEYS, the SD-1.5 UNet's 77 context
keys and its mid block's 64 tokens) on the CPU, where the op is the plain
version: dq, dk and dv against `jax.vjp` of the JAX package's attention.

The same seeded numpy inputs and cotangent go to both packages, f32 (the
op's arithmetic is the plain backward's in any dtype), JAX at
Precision.HIGHEST; max abs <= 1e-4 (sums in another order), at the UNet's
head dims 40, 80 and 160 onto 1, 16 and 17 keys (the two key tiles of the
kernel), 77, 80 (the cut) and 81 (past it), the mid block's padded
self-attention (kv_len < Nq: query rows past kv_len carry a zero cotangent
and add nothing to dk, dv), keys past kv_len, a ragged Nq and a negative
scale; some of them against the Pallas kernels in interpret mode. Then
`mha`'s route: in bfloat16 onto at most SHORT_KEYS keys its gradient takes
the short op (one plain backward for dq, dk and dv), with the pair's bits;
in float32, and past the cut, the pair."""

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
from amodal_depth_anything_tpu_torch.ops.flash_attention import (
    SHORT_KEYS, flash_attn_bwd_dkv, flash_attn_bwd_dq, flash_attn_bwd_short,
    mha, mha_reference)
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-4

# (batch, heads, n_q, n_k, kv_len, sm_scale, head dim): every UNet head dim
# onto each key count of the cut's edges, under a ragged Nq
KEY_CASES = [(1, 2, 70, nk, None, None, d) for d in (40, 80, 160)
             for nk in (1, 16, 17, 77, 80, 81)]
EDGE_CASES = [
    (2, 2, 64, 64, None, None, 160),   # the mid block's self-attention
    (1, 2, 64, 64, 50, None, 160),     # ... padded: kv_len < Nq
    (1, 2, 70, 70, 61, None, 40),      # padded, a ragged Nq
    (1, 2, 45, 96, 77, None, 80),      # keys past kv_len in the tile
    (1, 2, 70, 80, 9, None, 40),       # ... in the 16-key tile
    (1, 2, 70, 77, None, -0.3, 80),    # a negative scale
    (2, 1, 129, 77, None, None, 40),   # a ragged Nq past two 64-row tiles
]
# the Pallas kernels in interpret mode are slow: four of the cases
PALLAS_CASES = [(1, 2, 70, 77, None, None, 40), (1, 1, 40, 16, None, None, 80),
                (1, 2, 64, 64, 50, None, 160), (1, 1, 70, 1, None, -0.3, 40)]


def _inputs(b, h, nq, nk, kv_len, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, nq, d), dtype=np.float32)
    k = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    v = rng.standard_normal((b, h, nk, d), dtype=np.float32)
    do = rng.standard_normal((b, h, nq, d), dtype=np.float32)
    if kv_len is not None and nq == nk:
        do[:, :, kv_len:] = 0.0   # padded query rows carry no cotangent
    return q, k, v, do


def _jax_vjp(fn, q, k, v, do, **kw):
    _, pull = jax.vjp(lambda q, k, v: fn(q, k, v, **kw), jnp.asarray(q),
                      jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in pull(jnp.asarray(do))]


def _short_op_grads(q, k, v, do, kv_len, scale):
    """dq, dk, dv of `flash_attn_bwd_short` on the forward's O and LSE."""
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = mha_reference(tq, tk, tv, kv_len=kv_len, sm_scale=scale,
                           return_lse=True)
    delta = (tdo * o).sum(-1)
    sc = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_attn_bwd_short(tq, tk, tv, tdo, lse, delta, sm_scale=sc,
                                kv_len=kv_len)


def _check(ours, ref, kv_len=None):
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        a = a.detach().numpy()
        assert a.shape == r.shape, name
        assert np.abs(a - r).max() <= TOL, (name, np.abs(a - r).max())
    if kv_len is not None:   # rows of dk, dv at or past kv_len: exactly 0
        assert not ours[1][:, :, kv_len:].any()
        assert not ours[2][:, :, kv_len:].any()


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale,d", KEY_CASES + EDGE_CASES)
def test_short_backward_matches_jax_vjp(b, h, nq, nk, kv_len, scale, d):
    q, k, v, do = _inputs(b, h, nq, nk, kv_len, d, seed=nk + d)
    ref = _jax_vjp(jax_mha_reference, q, k, v, do, kv_len=kv_len,
                   sm_scale=scale)
    _check(_short_op_grads(q, k, v, do, kv_len, scale), ref, kv_len)


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale,d", KEY_CASES + EDGE_CASES)
def test_mha_short_route_matches_jax_vjp(b, h, nq, nk, kv_len, scale, d,
                                         monkeypatch):
    """`mha`'s gradient through the short op (the route opened to float32,
    which takes the pair otherwise) against `jax.vjp`."""
    short = fa._short_keys
    monkeypatch.setattr(fa, "_short_keys", lambda dtype, kv: short(
        torch.bfloat16, kv))
    calls = []
    plain = fa._bwd_plain
    monkeypatch.setattr(fa, "_bwd_plain", lambda *a, **kw: calls.append(
        a[-2:]) or plain(*a, **kw))
    q, k, v, do = _inputs(b, h, nq, nk, kv_len, d, seed=nk + d + 1)
    ref = _jax_vjp(jax_mha_reference, q, k, v, do, kv_len=kv_len,
                   sm_scale=scale)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = mha(tq, tk, tv, kv_len=kv_len, sm_scale=scale)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    short_route = (kv_len or nk) <= SHORT_KEYS
    assert calls == ([(True, True)] if short_route
                     else [(True, False), (False, True)])
    _check(grads, ref, kv_len)


@pytest.mark.parametrize("b,h,nq,nk,kv_len,scale,d", PALLAS_CASES)
def test_short_backward_matches_jax_pallas_interpret(b, h, nq, nk, kv_len,
                                                     scale, d):
    q, k, v, do = _inputs(b, h, nq, nk, kv_len, d, seed=2 * nk + d)
    ref = _jax_vjp(jax_mha, q, k, v, do, interpret=True, kv_len=kv_len,
                   sm_scale=scale)
    _check(_short_op_grads(q, k, v, do, kv_len, scale), ref, kv_len)


@pytest.mark.parametrize("nk,kv_len,short", [
    (77, None, True), (64, None, True), (1, None, True), (80, None, True),
    (96, 80, True), (81, None, False), (96, None, False)])
def test_bf16_gradient_takes_the_short_op_with_the_pairs_bits(nk, kv_len,
                                                             short,
                                                             monkeypatch):
    """In bfloat16 onto at most SHORT_KEYS live keys `mha`'s gradient runs
    the short op (on the CPU one plain backward for all three gradients),
    with the same bits as the two streaming ops; past the cut the pair."""
    gen = torch.Generator().manual_seed(nk)
    q, do = (torch.randn((2, 2, 64, 40), generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((2, 2, nk, 40), generator=gen).bfloat16()
            for _ in range(2))
    if kv_len is not None and nk == 64:
        do[:, :, kv_len:] = 0
    calls = []
    plain = fa._bwd_plain
    monkeypatch.setattr(fa, "_bwd_plain", lambda *a, **kw: calls.append(
        a[-2:]) or plain(*a, **kw))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = mha(*leaves, kv_len=kv_len)
    grads = torch.autograd.grad(o, leaves, do)
    assert calls == ([(True, True)] if short
                     else [(True, False), (False, True)])
    with torch.no_grad():
        o2, lse = mha(q, k, v, kv_len=kv_len, return_lse=True)
        delta = (do.float() * o2.float()).sum(-1)
        args, kw = (q, k, v, do, lse, delta), {"sm_scale": 40 ** -0.5,
                                               "kv_len": kv_len}
        pair = (flash_attn_bwd_dq(*args, **kw), *flash_attn_bwd_dkv(*args,
                                                                     **kw))
    assert all(torch.equal(g, p) for g, p in zip(grads, pair))


def test_float32_gradient_keeps_the_pair(monkeypatch):
    calls = []
    plain = fa._bwd_plain
    monkeypatch.setattr(fa, "_bwd_plain", lambda *a, **kw: calls.append(
        a[-2:]) or plain(*a, **kw))
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(1, 2, 40, 77, None, 40, seed=5))
    torch.autograd.grad(mha(q, k, v), (q, k, v), do.detach())
    assert calls == [(True, False), (False, True)]


@pytest.mark.parametrize("d,kv_len,names", [
    (40, 77, ("flash_attn_bwd_bf16_short<3, 80>",
              "flash_attn_bwd_short_sum")),
    (160, 64, ("flash_attn_bwd_bf16_short<10, 80>",
               "flash_attn_bwd_short_sum")),
    (80, 80, ("flash_attn_bwd_bf16_short<5, 80>",
              "flash_attn_bwd_short_sum")),
    (80, 17, ("flash_attn_bwd_bf16_short<5, 80>",
              "flash_attn_bwd_short_sum")),
    (80, 16, ("flash_attn_bwd_bf16_short<5, 16>",
              "flash_attn_bwd_short_sum")),
    (64, 1, ("flash_attn_bwd_bf16_short<4, 16>",
             "flash_attn_bwd_short_sum")),
    (8, 50, ("flash_attn_bwd_bf16_short<1, 80>",
             "flash_attn_bwd_short_sum")),
    (136, 9, ("flash_attn_bwd_bf16_short<10, 16>",
              "flash_attn_bwd_short_sum")),
    (40, 81, ("flash_attn_bwd_dq_bf16_wgmma<3>",
              "flash_attn_bwd_dkv_bf16_wgmma<3, 2>")),
    (80, None, ("flash_attn_bwd_dq_bf16_wgmma<5>",
                "flash_attn_bwd_dkv_bf16_wgmma<5, 2>"))])
def test_bwd_instantiations_name_the_short_kernels(d, kv_len, names):
    """`bwd_instantiations(..., kv_len=)` names the short-key kernels of
    `flash_attn_bwd.cu` at and under the cut (the keys a tile as its
    kShortKeys / kShortFewKeys), the pair past it; float32 keeps the pair."""
    assert fa.bwd_instantiations(torch.bfloat16, d, kv_len=kv_len) == names
    assert fa.bwd_instantiations(torch.float32, d, kv_len=kv_len) == \
        fa.bwd_instantiations(torch.float32, d)
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    for name in names:   # each names a kernel of the source
        assert f"\n{name.split('<')[0]}(" in src, name
    assert "constexpr int kShortKeys = 80, kShortFewKeys = 16;" in src
    if "short<" in names[0]:
        steps, keys = names[0][:-1].split("<")[1].split(", ")
        nk = {"80": "kShortKeys", "16": "kShortFewKeys"}[keys]
        assert f"dispatch_short_d<{nk}>(a, s)" in src
        assert f"launch_short<{steps}, NK>(a, s)" in src


def test_short_launcher_refuses_what_its_kernel_does_not_take():
    """On a CUDA tensor the short op launches its kernel or raises: float32
    and more than SHORT_KEYS keys are refused before any launch (stand-ins
    the checks see as CUDA tensors)."""
    from tests.test_torch_flash_attention import _OnCard

    stat = _OnCard((1, 2, 24), torch.float32)
    for dtype, nk in ((torch.float32, 77), (torch.bfloat16, 81)):
        q = _OnCard((1, 2, 24, 40), dtype)
        k = _OnCard((1, 2, nk, 40), dtype)
        with pytest.raises(ValueError, match="short-key backward"):
            fa._launch_bwd_short(q, k, k, q, stat, stat, 0.1, nk)
