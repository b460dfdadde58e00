"""Guided DINOv2 vision transformer as a torch module.

Port of the JAX package's `models/dinov2.py` (reference
`depth_anything_v2/dinov2.py:44-448`): a DINOv2 ViT whose RGB patch tokens
get the output of an extra, zero-initialised *guidance* patch embedding
added before the cls token and the positional embedding
(reference `dinov2.py:232-246`). `get_intermediate_layers` returns the
final-LayerNormed tokens at the DPT tap depths.

The JAX package pads the token stream to 1408 for its TPU kernel; this port
does not, because the CUDA kernel masks the ragged edge itself.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize2d
from .layers import DEFAULT_LN_EPS, Block, LayerNorm

__all__ = ["GUIDE_CHANNELS", "VIT_PRESETS", "INTERMEDIATE_LAYER_IDX",
           "ViTConfig", "PatchEmbed", "DinoVisionTransformer",
           "interpolate_pos_embed"]

GUIDE_CHANNELS = {
    "image+mask+observation": 5,
    "image+mask": 4,
    "image+observation": 4,
    "mask+observation": 2,
    "mask": 1,
    "observation": 1,
    "none": 0,
}

# Encoder presets (reference `dinov2.py:367-448`); 'vitt' (tests) and
# 'vitp' (the in-repo trained proxies) are the JAX package's own.
VIT_PRESETS = {
    "vitt": dict(embed_dim=64, depth=4, num_heads=2, ffn="mlp"),
    "vitp": dict(embed_dim=128, depth=12, num_heads=2, ffn="mlp"),
    "vits": dict(embed_dim=384, depth=12, num_heads=6, ffn="mlp"),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12, ffn="mlp"),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16, ffn="mlp"),
    "vitg": dict(embed_dim=1536, depth=40, num_heads=24, ffn="swiglufused"),
}

# DPT tap depths per encoder (reference `dpt.py:213-218`).
INTERMEDIATE_LAYER_IDX = {
    "vitt": (0, 1, 2, 3),
    "vitp": (2, 5, 8, 11),
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
    "vitg": (9, 19, 29, 39),
}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    ffn: str = "mlp"
    mlp_ratio: float = 4.0
    patch_size: int = 14
    img_size: int = 518
    init_values: float = 1.0
    interpolate_offset: float = 0.1
    guide_type: str = "none"

    @classmethod
    def preset(cls, name: str, guide_type: str = "none") -> "ViTConfig":
        return cls(**VIT_PRESETS[name], guide_type=guide_type)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def guide_channels(self) -> int:
        return GUIDE_CHANNELS[self.guide_type]


class PatchEmbed(nn.Module):
    """Stride-`patch` conv: [B, H, W, C] -> [B, (H/p)*(W/p), D]."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int = 14):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.proj
        y = F.conv2d(x.permute(0, 3, 1, 2), proj.weight.to(x.dtype),
                     proj.bias.to(x.dtype), stride=proj.stride)
        return y.flatten(2).transpose(1, 2)


def interpolate_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int, *,
                          offset: float = 0.1) -> torch.Tensor:
    """Resample the checkpoint's pos-embed grid to (gh, gw).

    Reference `dinov2.py:199-230`: bicubic, no antialias,
    scale_factor = (g + offset) / sqrt(N) -- not target-size semantics. The
    identity at 518 px; at the proxies' 112 px it resamples 37 -> 8."""
    n = pos_embed.shape[1] - 1
    g0 = int(round(math.sqrt(n)))
    if gh == g0 and gw == g0:
        return pos_embed
    cls_pe, patch_pe = pos_embed[:, :1], pos_embed[:, 1:]
    dim = pos_embed.shape[-1]
    sqrt_n = math.sqrt(n)
    grid = patch_pe.reshape(1, g0, g0, dim).float()
    out = resize2d(grid, scale_factor=((gh + offset) / sqrt_n,
                                       (gw + offset) / sqrt_n),
                   method="bicubic", align_corners=False)
    if out.shape[1:3] != (gh, gw):
        raise ValueError(f"pos-embed resample gave {tuple(out.shape[1:3])}, "
                         f"expected {(gh, gw)}")
    out = out.reshape(1, gh * gw, dim).to(pos_embed.dtype)
    return torch.cat([cls_pe, out], dim=1)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embed = PatchEmbed(3, d, cfg.patch_size)
        if cfg.guide_channels:
            self.patch_embed_guidance = PatchEmbed(cfg.guide_channels, d,
                                                   cfg.patch_size)
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, ffn=cfg.ffn,
                  init_values=cfg.init_values) for _ in range(cfg.depth))
        self.norm = LayerNorm(d, eps=DEFAULT_LN_EPS)

    def prepare_tokens(self, x: torch.Tensor,
                       guide: torch.Tensor | None) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, _ = x.shape
        tokens = self.patch_embed(x)
        if cfg.guide_channels:
            if guide is None:
                raise ValueError(f"guide_type={cfg.guide_type!r} requires a "
                                 f"guide input")
            tokens = tokens + self.patch_embed_guidance(guide)
        cls = self.cls_token.expand(b, 1, cfg.embed_dim).to(tokens.dtype)
        tokens = torch.cat([cls, tokens], dim=1)
        pe = interpolate_pos_embed(self.pos_embed, h // cfg.patch_size,
                                   w // cfg.patch_size,
                                   offset=cfg.interpolate_offset)
        return tokens + pe.to(tokens.dtype)

    def get_intermediate_layers(
            self, x: torch.Tensor, guide: torch.Tensor | None = None,
            taps: Sequence[int] | None = None, *,
            attn_impl: str | None = None, remat: bool | str = False
    ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """[(patch_tokens [B,N,D], cls [B,D])] per tap, final-LayerNormed
        (reference `get_intermediate_layers(norm=True,
        return_class_token=True)`). x: [B,H,W,3]; guide: [B,H,W,Cg].
        `remat`: False | True | "attn", per block (see `layers.Block`)."""
        taps = set((self.cfg.depth - 1,) if taps is None else taps)
        t = self.prepare_tokens(x, guide)
        out = []
        for i, blk in enumerate(self.blocks):
            t = blk(t, attn_impl=attn_impl, remat=remat)
            if i in taps:
                n = self.norm(t)
                out.append((n[:, 1:], n[:, 0]))
            if len(out) == len(taps):
                break
        return out
