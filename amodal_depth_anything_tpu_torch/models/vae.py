"""Stable-Diffusion AutoencoderKL (VAE) as torch modules.

Port of the JAX package's `models/vae.py` (diffusers `AutoencoderKL`, which
the DepthFM branch uses to encode RGB / guide / depth images into SD-1.5
latents and to decode depth predictions back, reference
`src/models/depthfm/dfm.py:20-22`, `dfm_amodal.py:37-38,273-302`):

  encoder: conv_in -> down blocks (resnets; stride-2 conv after the
  (0,1,0,1) asymmetric pad between blocks) -> mid (resnet, single-head
  attention, resnet) -> GN/SiLU/conv_out -> moments; quant_conv.
  decoder: post_quant_conv -> conv_in -> mid -> up blocks (resnets,
  nearest-2x + conv upsample, fused) -> GN/SiLU/conv_out.

Module names give the diffusers state-dict keys (`encoder.down_blocks.0.
resnets.0.conv1.weight`, `decoder.up_blocks.0.upsamplers.0.conv.weight`,
`encoder.mid_block.attentions.0.to_out.0.bias`, ...), so the SD-1.5 VAE
loads with a strict `load_state_dict`. Tensors are NHWC. `encode_mode` is
the deterministic posterior mean the reference uses, times the latent
scale 0.18215. The mid-block attention always runs in float32 through the
plain version: one head of width 512 over a 64 x 64 map is outside the
flash-attention kernel's head dims, and the JAX package makes the same
explicit choice (`impl="xla"` in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..ops.conv import Conv2dNHWC, conv2d, upsample2x_conv
from ..ops.quant import is_quantized
from .layers import Linear
from .unet_ldm import GroupNorm

__all__ = ["VAEConfig", "SD_VAE", "SD_LATENT_SCALE", "AutoencoderKL"]

SD_LATENT_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2


SD_VAE = VAEConfig()


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.norm1 = GroupNorm(c_in, eps=1e-6)
        self.conv1 = Conv2dNHWC(c_in, c_out, 3, padding=1)
        self.norm2 = GroupNorm(c_out, eps=1e-6)
        self.conv2 = Conv2dNHWC(c_out, c_out, 3, padding=1)
        if c_in != c_out:
            self.conv_shortcut = Conv2dNHWC(c_in, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head self-attention over the H*W positions, in float32."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.Sequential(Linear(ch, ch), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = (proj(y)[:, None].float()       # one head: [B, 1, N, C]
                   for proj in (self.to_q, self.to_k, self.to_v))
        o = multi_head_attention(q, k, v, impl="plain")[:, 0].to(x.dtype)
        return x + self.to_out[0](o).view(b, h, w, c)


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch),
                                      ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([MidAttention(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Downsampler(nn.Module):
    """diffusers Downsample2D: pad (0, 1) on both axes, then a stride-2
    conv without padding."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2dNHWC(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_quantized(self.conv):   # pad, then the quantised conv
            return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        return conv2d(x, self.conv.weight, self.conv.bias, stride=2,
                      padding=((0, 1), (0, 1)))


class Upsampler(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2dNHWC(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_conv(x, self.conv)


class ResBlocks(nn.Module):
    """One down or up block: its resnets, then its resampler if it has one."""

    def __init__(self, c_in: int, c_out: int, n: int, resampler: str | None):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(c_in if j == 0 else c_out, c_out) for j in range(n))
        if resampler == "down":
            self.downsamplers = nn.ModuleList([Downsampler(c_out)])
        elif resampler == "up":
            self.upsamplers = nn.ModuleList([Upsampler(c_out)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for name in ("downsamplers", "upsamplers"):
            if hasattr(self, name):
                x = getattr(self, name)[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)
        self.conv_in = Conv2dNHWC(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            ResBlocks(chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                      "down" if i != len(chans) - 1 else None)
            for i, ch in enumerate(chans))
        self.mid_block = MidBlock(chans[-1])
        self.conv_norm_out = GroupNorm(chans[-1], eps=1e-6)
        self.conv_out = Conv2dNHWC(chans[-1], 2 * cfg.latent_channels, 3,
                                   padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            h = block(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans = list(cfg.block_out_channels)[::-1]
        self.conv_in = Conv2dNHWC(cfg.latent_channels, chans[0], 3, padding=1)
        self.mid_block = MidBlock(chans[0])
        self.up_blocks = nn.ModuleList(
            ResBlocks(chans[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                      "up" if i != len(chans) - 1 else None)
            for i, ch in enumerate(chans))
        self.conv_norm_out = GroupNorm(chans[-1], eps=1e-6)
        self.conv_out = Conv2dNHWC(chans[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            h = block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = SD_VAE):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2dNHWC(2 * cfg.latent_channels,
                                     2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2dNHWC(cfg.latent_channels,
                                          cfg.latent_channels, 1)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] in [-1,1] -> posterior-mean latents [B,H/8,W/8,4],
        times the latent scale."""
        moments = self.quant_conv(self.encoder(x))
        return moments[..., :self.cfg.latent_channels] * SD_LATENT_SCALE

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(Scaled) latents [B,h,w,4] -> image [B,8h,8w,3] in [-1,1]."""
        return self.decoder(self.post_quant_conv(z / SD_LATENT_SCALE))
