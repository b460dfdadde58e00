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
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention

__all__ = ["DEFAULT_LN_EPS", "LayerScale", "Mlp", "SwiGLUFFNFused",
           "Attention", "Block", "swiglu_hidden_dim"]

DEFAULT_LN_EPS = 1e-6


def swiglu_hidden_dim(dim: int, mlp_ratio: float = 4.0) -> int:
    hidden = int(dim * mlp_ratio * 2 / 3)
    return (hidden + 7) // 8 * 8


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwiGLUFFNFused(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, *,
                attn_impl: str | None = None) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).view(b, n, 3, self.num_heads, c // self.num_heads)
        # [B,H,N,D] strided views of the one qkv buffer: the kernel reads
        # them in place
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = multi_head_attention(q, k, v, impl=attn_impl)
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 ffn: str = "mlp", init_values: float = 1.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=DEFAULT_LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim, init_values)
        self.norm2 = nn.LayerNorm(dim, eps=DEFAULT_LN_EPS)
        if ffn == "mlp":
            self.mlp = Mlp(dim, int(dim * mlp_ratio))
        elif ffn == "swiglufused":
            self.mlp = SwiGLUFFNFused(dim, swiglu_hidden_dim(dim, mlp_ratio))
        else:
            raise ValueError(f"unknown ffn: {ffn}")
        self.ls2 = LayerScale(dim, init_values)

    def forward(self, x: torch.Tensor, *,
                attn_impl: str | None = None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), attn_impl=attn_impl))
        return x + self.ls2(self.mlp(self.norm2(x)))
