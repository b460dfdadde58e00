"""CLIP ViT image encoder (pix2gestalt's conditioning) as torch modules.

Port of the JAX package's `models/clip_vit.py`: patch convolution without a
bias, class token, learned positions, pre-LN transformer with quick-GELU,
LayerNorm on the class token, projection without a bias. pix2gestalt feeds
the projected embedding of a 224 px crop to its UNet as one cross-attention
token (CLIP ViT-L/14: 16 heads of 64 over 257 tokens).

Module names give the HF `transformers` `CLIPVisionModelWithProjection`
state-dict keys (`vision_model.encoder.layers.N.self_attn.q_proj.weight`,
`vision_model.pre_layrnorm.weight`, `visual_projection.weight`, ...), so the
released vision tower loads with a strict `load_state_dict` (its
`position_ids` buffer, which holds no weight, is dropped by
`convert.heuristics.clip_state_dict`). Where the JAX package fuses q, k and
v into one projection, the port keeps HF's three; the weight bridge splits
and joins them.

Tensors are NHWC at the input. Self-attention goes through
`ops.attention.multi_head_attention`, so on CUDA tensors it launches the
flash-attention kernel at [B, 16, 257, 64]. LayerNorm eps is the JAX
package's 1e-6 (the released tower's is 1e-5; see ROADMAP, Queue 3).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..ops.attention import multi_head_attention
from ..ops.conv import Conv2dNHWC
from .layers import DEFAULT_LN_EPS, LayerNorm, Linear

__all__ = ["CLIPVisionConfig", "CLIPVisionModelWithProjection",
           "quick_gelu"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024            # vit-l/14
    depth: int = 24
    num_heads: int = 16
    projection_dim: int = 768

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, attn_impl: str | None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads

        def heads(t):
            return t.view(b, n, h, c // h).transpose(1, 2)

        o = multi_head_attention(heads(self.q_proj(x)), heads(self.k_proj(x)),
                                 heads(self.v_proj(x)), impl=attn_impl)
        return self.out_proj(o.transpose(1, 2).reshape(b, n, c))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim)
        self.fc2 = Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(dim, eps=DEFAULT_LN_EPS)
        self.self_attn = CLIPAttention(dim, num_heads)
        self.layer_norm2 = LayerNorm(dim, eps=DEFAULT_LN_EPS)
        self.mlp = CLIPMLP(dim)

    def forward(self, x: torch.Tensor, attn_impl: str | None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), attn_impl)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg.width, cfg.num_heads)
            for _ in range(cfg.depth))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_embedding = Conv2dNHWC(3, cfg.width, cfg.patch_size,
                                          stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.position_embedding = nn.Embedding(cfg.grid ** 2 + 1, cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embedding(x).flatten(1, 2)       # [B, N, D]
        cls = self.class_embedding.to(tokens.dtype).expand(
            tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + self.position_embedding.weight.to(tokens.dtype)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.width, eps=DEFAULT_LN_EPS)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.width, eps=DEFAULT_LN_EPS)


class CLIPVisionModelWithProjection(nn.Module):
    """The CLIP vision tower: [B,S,S,3] CLIP-normalised images ->
    [B, projection_dim] embeddings."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = Linear(cfg.width, cfg.projection_dim,
                                        bias=False)

    def forward(self, x: torch.Tensor, *,
                attn_impl: str | None = None) -> torch.Tensor:
        vm = self.vision_model
        tokens = vm.pre_layrnorm(vm.embeddings(x))
        for layer in vm.encoder.layers:
            tokens = layer(tokens, attn_impl)
        return self.visual_projection(vm.post_layernorm(tokens[:, 0]))
