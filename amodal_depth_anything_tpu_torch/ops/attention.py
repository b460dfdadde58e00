"""Multi-head attention dispatch: the Hopper kernels or the plain version.

`impl=None` takes the kernels for CUDA tensors and the plain version for CPU
tensors; both are differentiable. Nothing is rerouted by size: the trunks'
self-attention, the UNet's self-attention at head dims 40/80/160 and its
cross-attention onto 77 context tokens all launch the kernel on the card
(the JAX package sends tiny key sets to XLA to get around Mosaic tilings;
the CUDA kernel masks any Nk itself). An explicit "plain" is allowed on the
card (the JAX package's `attn_impl="xla"`), so the two can be compared
there, and is what the VAE's single-head f32 mid-block attention asks for,
as the JAX package does; an explicit "kernel" on a CPU tensor raises.
"""

from __future__ import annotations

from .flash_attention import mha, mha_reference

__all__ = ["multi_head_attention", "ATTN_IMPLS"]

ATTN_IMPLS = ("kernel", "plain")


def multi_head_attention(q, k, v, *, impl: str | None = None,
                         kv_len: int | None = None,
                         sm_scale: float | None = None,
                         residuals: dict | None = None):
    """Attention over [B, H, N, D] tensors; returns [B, H, Nq, D].

    `kv_len`: keys at index >= kv_len are masked (default: all).
    `sm_scale`: softmax scale override (default 1/sqrt(D)).
    `residuals`: see `mha`; `impl=None` and "kernel" pass it on, an explicit
    "plain" differentiates `mha_reference` with plain autograd and keeps
    nothing."""
    if impl == "kernel" and not q.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; the CPU has "
                         "only the plain version (impl='plain')")
    if impl is None or impl == "kernel":
        return mha(q, k, v, kv_len=kv_len, sm_scale=sm_scale,
                   residuals=residuals)
    if impl == "plain":
        return mha_reference(q, k, v, kv_len=kv_len, sm_scale=sm_scale)
    raise ValueError(f"unknown attention impl: {impl!r} (one of {ATTN_IMPLS})")
