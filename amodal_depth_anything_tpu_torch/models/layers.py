"""Transformer layers of the DINOv2 trunk as torch modules.

Attribute names give the reference checkpoints' state-dict keys
(`blocks.N.norm1.weight`, `blocks.N.attn.qkv.weight`, `blocks.N.ls1.gamma`,
`blocks.N.mlp.fc1.weight` or `blocks.N.mlp.w12.weight`, ...).

Parity points with the JAX package (`models/layers.py`):
  * LayerNorm eps is 1e-6 (reference `dinov2.py:96`), not torch's 1e-5.
  * GELU is the exact erf form.
  * SwiGLUFFNFused: w12 -> split -> silu(x1) * x2 -> w3, hidden size
    (int(d * 4 * 2 / 3) + 7) // 8 * 8 (4096 at vitg).
  * Pre-norm block: x += ls1(attn(norm1(x))); x += ls2(ffn(norm2(x))).
  * Precision: parameters are cast to the activation's dtype at use
    (`Linear`, `LayerScale`), and LayerNorm runs in float32, so a module
    that keeps float32 master weights computes in bfloat16 when it is fed
    bfloat16 activations, as the JAX train step does; a module cast whole
    with `.to(dtype)` (the inference pipeline) behaves as before.
  * `Block.forward(remat=...)`: `False` keeps every activation, `True`
    recomputes the block in the backward pass, `"attn"` recomputes all of
    it except the attention output and LSE, so the backward never runs the
    forward attention kernel again.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import multi_head_attention

__all__ = ["DEFAULT_LN_EPS", "REMAT_MODES", "Linear", "LayerNorm",
           "LayerScale", "Mlp", "SwiGLUFFNFused", "Attention", "Block",
           "swiglu_hidden_dim"]

DEFAULT_LN_EPS = 1e-6
REMAT_MODES = (False, True, "attn")


class Linear(nn.Linear):
    """nn.Linear whose parameters follow the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm that runs in float32 on float32 parameters whatever the
    input's dtype (training: float32 master weights, bfloat16 activations)
    and returns the input's dtype. A module cast whole to the input's dtype
    (the inference pipeline) takes the library's own path, with no casts."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


def swiglu_hidden_dim(dim: int, mlp_ratio: float = 4.0) -> int:
    hidden = int(dim * mlp_ratio * 2 / 3)
    return (hidden + 7) // 8 * 8


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFNFused(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = Linear(dim, 2 * hidden)
        self.w3 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, *, attn_impl: str | None = None,
                residuals: dict | None = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads)
        # [B,H,N,D] strided views of the one qkv buffer: the kernel reads
        # them in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = multi_head_attention(q, k, v, impl=attn_impl,
                                 residuals=residuals)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 ffn: str = "mlp", init_values: float | None = 1.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=DEFAULT_LN_EPS)
        self.attn = Attention(dim, num_heads)
        # init_values=None: no LayerScale (timm's ViT blocks, jo_dpt)
        self.ls1 = (nn.Identity() if init_values is None
                    else LayerScale(dim, init_values))
        self.norm2 = LayerNorm(dim, eps=DEFAULT_LN_EPS)
        if ffn == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio))
        elif ffn == "swiglufused":
            self.mlp = SwiGLUFFNFused(dim, swiglu_hidden_dim(dim, mlp_ratio))
        else:
            raise ValueError(f"unknown ffn: {ffn}")
        self.ls2 = (nn.Identity() if init_values is None
                    else LayerScale(dim, init_values))

    def _forward(self, x: torch.Tensor, attn_impl: str | None,
                 residuals: dict | None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), attn_impl=attn_impl,
                                   residuals=residuals))
        return x + self.ls2(self.mlp(self.norm2(x)))

    def forward(self, x: torch.Tensor, *, attn_impl: str | None = None,
                remat: bool | str = False) -> torch.Tensor:
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode: {remat!r} (one of "
                             f"{REMAT_MODES})")
        if not remat or not torch.is_grad_enabled():
            return self._forward(x, attn_impl, None)
        # "attn": this dict keeps the attention output and LSE of the first
        # pass alive until the backward, whose recompute of the block reuses
        # them in place of a second forward kernel. The plain implementation
        # names no residuals, so with it "attn" recomputes the whole block.
        residuals = {} if remat == "attn" and attn_impl != "plain" else None
        return checkpoint(self._forward, x, attn_impl, residuals,
                          use_reentrant=False, preserve_rng_state=False)
