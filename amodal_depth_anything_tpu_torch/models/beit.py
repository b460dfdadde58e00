"""BEiT-L/16 backbone (MiDaS DPT_BEiT_L_384 encoder).

Port of the JAX package's `models/beit.py`. The InvisibleStitch baseline's
ZoeDepth-N core is MiDaS DPT_BEiT_L_384 (reference `invisible_stitch.py:
43-47`). BEiT differs from the DINOv2/timm ViTs of this package:

  * no absolute positional embedding; each block adds a *relative
    position bias* to its attention logits, from a learned table of
    (2g-1)^2 + 3 entries (g = patch grid) indexed by relative offsets
    plus 3 cls-interaction slots;
  * attention has q_bias and v_bias but NO k bias;
  * residual branches are scaled by learned gamma_1 / gamma_2.

For grids other than the table's native one the bias table's spatial part
is resampled bilinearly (align_corners=True, MiDaS behaviour). The
attention stays plain tensor ops (scores, bias, float32 softmax, product),
as in the JAX package, which runs it on XLA even when a kernel is asked
for: the bias is not a Pallas kernel's input. The patch embedding is a
stride-16 convolution, as MiDaS's: it drops the last H % 16 rows and
W % 16 columns (518 px -> 32 x 32); the JAX package's space-to-depth
embedding needs a multiple of 16 and fails at 518, and the two agree
wherever it runs.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize2d
from .dinov2 import PatchEmbed
from .layers import DEFAULT_LN_EPS, LayerNorm, Linear, Mlp

__all__ = ["BEiTConfig", "BEiT"]


@dataclasses.dataclass(frozen=True)
class BEiTConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    patch_size: int = 16
    img_size: int = 384           # native table grid = 24
    in_chans: int = 3
    mlp_ratio: float = 4.0

    @property
    def native_grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def table_size(self) -> int:
        g = self.native_grid
        return (2 * g - 1) ** 2 + 3


@functools.lru_cache(maxsize=8)
def _rel_pos_index(g: int, device: str) -> torch.Tensor:
    """BEiT relative_position_index for a g x g grid + cls token, kept on
    `device`: an [N+1, N+1] int64 table (8.4 MB at 518 px), which copied
    from pageable memory in every block took 15.5 ms of an H100's time a
    train step (batch 8)."""
    coords = np.stack(np.meshgrid(np.arange(g), np.arange(g),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += g - 1
    rel[..., 1] += g - 1
    rel[..., 0] *= 2 * g - 1
    idx = np.zeros((g * g + 1, g * g + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = (2 * g - 1) ** 2 + 2
    idx[0:, 0] = (2 * g - 1) ** 2 + 1
    idx[0, 0] = (2 * g - 1) ** 2
    return torch.from_numpy(idx).to(device)


class BEiTAttention(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.qkv = Linear(d, 3 * d, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(d))
        self.v_bias = nn.Parameter(torch.zeros(d))
        self.proj = Linear(d, d)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(cfg.table_size, cfg.num_heads))

    def rel_pos_bias(self, grid: int) -> torch.Tensor:
        """[H, N+1, N+1] bias for a grid x grid token grid."""
        cfg, table = self.cfg, self.relative_position_bias_table
        g0 = cfg.native_grid
        if grid != g0:
            spatial = table[:-3].reshape(1, 2 * g0 - 1, 2 * g0 - 1,
                                         cfg.num_heads)
            spatial = resize2d(spatial.float(),
                               size=(2 * grid - 1, 2 * grid - 1),
                               method="bilinear", align_corners=True)[0]
            table = torch.cat([spatial.reshape(-1, cfg.num_heads),
                               table[-3:]], dim=0)
        return table[_rel_pos_index(grid, str(table.device))].permute(2, 0, 1)

    def forward(self, x: torch.Tensor, grid: int) -> torch.Tensor:
        b, n, c = x.shape
        heads = self.cfg.num_heads
        d = c // heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias]).to(x.dtype)
        qkv = F.linear(x, self.qkv.weight.to(x.dtype), bias)
        q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        attn = (q * d ** -0.5) @ k.transpose(-1, -2)
        attn = attn + self.rel_pos_bias(grid).to(attn.dtype)[None]
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        o = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(o)


class BEiTBlock(nn.Module):
    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, eps=DEFAULT_LN_EPS)
        self.attn = BEiTAttention(cfg)
        self.gamma_1 = nn.Parameter(torch.full((d,), 0.1))
        self.norm2 = LayerNorm(d, eps=DEFAULT_LN_EPS)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio))
        self.gamma_2 = nn.Parameter(torch.full((d,), 0.1))

    def forward(self, x: torch.Tensor, grid: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), grid) * self.gamma_1.to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.gamma_2.to(x.dtype)


class BEiT(nn.Module):
    def __init__(self, cfg: BEiTConfig = BEiTConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.in_chans, d, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.blocks = nn.ModuleList(BEiTBlock(cfg) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, taps) -> list[torch.Tensor]:
        """x: [B,H,W,in_chans] -> the token tensors [B, N+1, D] after each
        tap block (before any final norm: MiDaS hooks raw block outputs)."""
        grid_h = x.shape[1] // self.cfg.patch_size
        grid_w = x.shape[2] // self.cfg.patch_size
        if grid_h != grid_w:
            raise ValueError("the BEiT relative-position path needs a square "
                             f"patch grid, got {grid_h} x {grid_w}")
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        outs = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, grid_h)
            if i in taps:
                outs.append(tokens)
        return outs
