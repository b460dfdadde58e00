"""The port's kernels as `torch.library` custom ops (`adat::`), on the CPU.

Each op's CPU implementation is the plain version, bit for bit (the forward
against `mha_reference`, the two backward ops against `mha_bwd_reference`,
the epilogue against `matmul_scale_residual_reference`);
`torch.library.opcheck` passes on every op (schema, fake implementation,
autograd registration); `torch.export` traces `mha` into one
`adat.flash_attn_fwd` node whose program gives the eager bits; and a CUDA
tensor never reaches a plain implementation (each op's CPU kernel is
registered for the CPU alone). The gradient through `mha` against
`jax.grad` of the Pallas kernel stays in
`tests/test_torch_flash_attention_bwd.py`, which now runs through the
registered autograd formula."""

import pytest
import torch

from amodal_depth_anything_tpu_torch.ops import flash_attention as fa
from amodal_depth_anything_tpu_torch.ops.fused_epilogue import (
    matmul_scale_residual, matmul_scale_residual_reference)
from tests.test_torch_models import few_torch_threads  # noqa: F401


def _qkv(b, h, nq, nk, d, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dtype) for shape in
                 ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d)))


@pytest.mark.parametrize("nq,nk,kv_len,need_lse,dtype", [
    (17, 17, 13, True, torch.float32), (9, 1, 1, False, torch.float32),
    (12, 20, 20, True, torch.bfloat16)])
def test_forward_op_is_the_plain_version(nq, nk, kv_len, need_lse, dtype):
    q, k, v = _qkv(2, 3, nq, nk, 16, seed=nq, dtype=dtype)
    o, lse = torch.ops.adat.flash_attn_fwd(q, k, v, 0.3, kv_len, need_lse)
    assert o.shape == (2, nq, 3, 16) and o.is_contiguous()
    ref = fa.mha_reference(q, k, v, sm_scale=0.3, kv_len=kv_len,
                           return_lse=True)
    torch.testing.assert_close(o.transpose(1, 2), ref[0], rtol=0, atol=0)
    if need_lse:
        torch.testing.assert_close(lse, ref[1], rtol=0, atol=0)
    else:
        assert lse.numel() == 0
    # `mha` hands out the [B,H,N,D] view of the op's token-major buffer
    out = fa.mha(q, k, v, sm_scale=0.3, kv_len=kv_len)
    torch.testing.assert_close(out, ref[0], rtol=0, atol=0)
    assert out.transpose(1, 2).is_contiguous()


@pytest.mark.parametrize("nq,nk,kv_len", [(15, 15, 11), (8, 24, 24)])
def test_backward_ops_are_the_plain_version(nq, nk, kv_len):
    q, k, v = _qkv(1, 2, nq, nk, 8, seed=3)
    o, lse = fa.mha_reference(q, k, v, sm_scale=0.4, kv_len=kv_len,
                              return_lse=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(4))
    delta = (do * o).sum(-1)
    dq = torch.ops.adat.flash_attn_bwd_dq(q, k, v, do, lse, delta, 0.4,
                                          kv_len)
    dk, dv = torch.ops.adat.flash_attn_bwd_dkv(q, k, v, do, lse, delta, 0.4,
                                               kv_len)
    want = fa.mha_bwd_reference(q, k, v, o, lse, do, sm_scale=0.4,
                                kv_len=kv_len)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got.transpose(1, 2), ref, rtol=0, atol=0)


def test_epilogue_op_is_the_plain_version():
    gen = torch.Generator().manual_seed(5)
    x, w, r = (torch.randn(s, generator=gen) for s in
               ((20, 16), (16, 24), (20, 24)))
    b, g = torch.randn(24, generator=gen), torch.randn(24, generator=gen)
    torch.testing.assert_close(torch.ops.adat.fused_epilogue(x, w, b, g, r),
                               matmul_scale_residual_reference(x, w, b, g, r),
                               rtol=0, atol=0)
    assert matmul_scale_residual(x, w, b, g, r).shape == (20, 24)


@pytest.mark.parametrize("op", ["flash_attn_fwd", "flash_attn_bwd_dq",
                                "flash_attn_bwd_dkv", "fused_epilogue"])
def test_opcheck(op):
    q, k, v = _qkv(1, 2, 6, 6, 8, seed=6)
    if op == "fused_epilogue":
        gen = torch.Generator().manual_seed(7)
        args = (torch.randn(5, 8, generator=gen),
                torch.randn(8, 16, generator=gen),
                torch.randn(16, generator=gen), torch.randn(16, generator=gen),
                torch.randn(5, 16, generator=gen))
    elif op == "flash_attn_fwd":
        args = (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(),
                0.35, 5, True)
    else:
        o, lse = fa.mha_reference(q, k, v, return_lse=True)
        do = torch.ones_like(o)
        args = (q, k, v, do, lse, (do * o).sum(-1), 0.35, 6)
    torch.library.opcheck(getattr(torch.ops.adat, op).default, args)


class _Attend(torch.nn.Module):
    def forward(self, q, k, v):
        return fa.mha(q, k, v, kv_len=9)


def test_export_traces_mha_into_the_op():
    q, k, v = _qkv(1, 2, 10, 10, 16, seed=8)
    with torch.no_grad():
        ep = torch.export.export(_Attend(), (q, k, v), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("adat.flash_attn_fwd.default") == 1
    torch.testing.assert_close(ep.module()(q, k, v), _Attend()(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("op", ["flash_attn_fwd", "flash_attn_bwd_dq",
                                "flash_attn_bwd_dkv", "fused_epilogue"])
def test_ops_take_the_plain_version_only_on_the_cpu(op):
    """Each op has a CPU kernel (the plain version), a CUDA kernel (the
    hand-written one), a Meta kernel (the fake implementation) and, for
    the forward, its autograd formula: no catch-all kernel, so no device
    reaches the plain version by way of a fallback."""
    dump = torch._C._dispatch_dump(f"adat::{op}")
    keys = {line.split(":")[0] for line in dump.splitlines()[4:] if line}
    want = {"CPU", "CUDA", "Meta", "Autograd[alias]"}
    assert keys == want, dump
