"""Multi-head attention dispatch: the Hopper kernel or the plain version.

`impl=None` takes the kernel for CUDA tensors and the plain version for CPU
tensors. An explicit "plain" is allowed on the card (the JAX package's
`attn_impl="xla"`), so the two can be compared there; an explicit "kernel"
on a CPU tensor raises.
"""

from __future__ import annotations

from .flash_attention import mha, mha_reference

__all__ = ["multi_head_attention", "ATTN_IMPLS"]

ATTN_IMPLS = ("kernel", "plain")


def multi_head_attention(q, k, v, *, impl: str | None = None,
                         kv_len: int | None = None,
                         sm_scale: float | None = None):
    """Attention over [B, H, N, D] tensors; returns [B, H, Nq, D].

    `kv_len`: keys at index >= kv_len are masked (default: all).
    `sm_scale`: softmax scale override (default 1/sqrt(D))."""
    if impl is None:
        impl = "kernel" if q.is_cuda else "plain"
    if impl == "kernel":
        if not q.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the CPU has "
                             "only the plain version (impl='plain')")
        return mha(q, k, v, kv_len=kv_len, sm_scale=sm_scale)
    if impl == "plain":
        return mha_reference(q, k, v, kv_len=kv_len, sm_scale=sm_scale)
    raise ValueError(f"unknown attention impl: {impl!r} (one of {ATTN_IMPLS})")
