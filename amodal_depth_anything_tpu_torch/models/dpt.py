"""DPT depth decoder as a torch module (NHWC at its edges).

Port of the JAX package's `models/dpt.py` (reference
`depth_anything_v2/dpt.py:64-197`, `util/blocks.py`): per-tap 1x1
projections; resize layers (4x and 2x transposed conv, identity, stride-2
conv); the amodal variant's per-tap `input_projection` (conv3x3 + channel
LayerNorm + ReLU, absent in the raw head); the scratch 3x3 convs; four
FeatureFusionBlocks with align_corners bilinear upsampling; and the output
stack with a sigmoid, ReLU or linear head.

Attribute names give the reference state-dict keys (`projects.N`,
`resize_layers.{0,1,3}`, `input_projection.N.{0,1}`, `scratch.layerN_rn`,
`scratch.refinenetN.resConfUnit1.conv1`, `scratch.output_conv2.{0,2}`).
Activations stay NHWC, as in the JAX package; each convolution runs on the
NCHW view of the same memory. The convolutions may be quantised modules
(`ops.quant`: W8A8 with calibrated or dynamic scales) under the same names.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.utils.checkpoint
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC, ConvTranspose2dNHWC, LayerNorm2d
from ..ops.resize import resize2d

__all__ = ["DPTConfig", "DPTHead"]


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    in_channels: int                      # ViT embed dim
    features: int = 256
    out_channels: Sequence[int] = (256, 512, 1024, 1024)
    head_mode: str = "sigmoid"            # 'sigmoid' | 'linear' | 'relu' (raw)
    use_input_projection: bool = True     # the amodal variant's extra convs
    patch_size: int = 14


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2dNHWC(features, features, 3, padding=1)
        self.conv2 = Conv2dNHWC(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # reference blocks.py:57-80: relu -> conv -> relu -> conv -> +x
        out = self.conv1(F.relu(x))
        return self.conv2(F.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = Conv2dNHWC(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None,
                size: tuple[int, int] | None) -> torch.Tensor:
        # reference blocks.py:123-148
        out = x
        if skip is not None:
            out = out + self.resConfUnit1(skip)
        out = self.resConfUnit2(out)
        if size is None:
            out = resize2d(out, scale_factor=2.0, method="bilinear",
                           align_corners=True)
        else:
            out = resize2d(out, size=size, method="bilinear",
                           align_corners=True)
        return self.out_conv(out)


class DPTHead(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        oc, feat = cfg.out_channels, cfg.features
        self.projects = nn.ModuleList(
            Conv2dNHWC(cfg.in_channels, ch, 1) for ch in oc)
        self.resize_layers = nn.ModuleList([
            ConvTranspose2dNHWC(oc[0], oc[0], 4, stride=4),
            ConvTranspose2dNHWC(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            Conv2dNHWC(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        if cfg.use_input_projection:
            self.input_projection = nn.ModuleList(
                nn.Sequential(Conv2dNHWC(ch, ch, 3, padding=1),
                              LayerNorm2d(ch), nn.ReLU())
                for ch in oc)
        scratch = nn.Module()
        for i, ch in enumerate(oc):
            setattr(scratch, f"layer{i + 1}_rn",
                    Conv2dNHWC(ch, feat, 3, padding=1, bias=False))
        for i in range(len(oc)):
            setattr(scratch, f"refinenet{i + 1}", FeatureFusionBlock(feat))
        scratch.output_conv1 = Conv2dNHWC(feat, feat // 2, 3, padding=1)
        scratch.output_conv2 = nn.Sequential(
            Conv2dNHWC(feat // 2, 32, 3, padding=1), nn.ReLU(),
            Conv2dNHWC(32, 1, 1))
        self.scratch = scratch

    def forward(self, features: Sequence[tuple[torch.Tensor, torch.Tensor]],
                patch_hw: tuple[int, int], *,
                batch_tile: int | None = None) -> torch.Tensor:
        """features: [(patch_tokens [B,N,D], cls [B,D])] x4 ->
        depth [B, 14*ph, 14*pw, 1].

        `batch_tile`: run the head over batch chunks of this size, one after
        the other (JAX `dpt_head(batch_tile=)`; exact, the convolutions are
        independent per batch row): the full-grid fusion pyramid's
        activations then peak at one chunk's worth. Under grad each chunk
        is checkpointed, as the JAX head's `jax.checkpoint`ed `lax.map`
        body: only the chunk's inputs are kept and the backward recomputes
        one chunk's forward at a time (without that, tiling saves no
        memory)."""
        b = features[0][0].shape[0]
        if batch_tile is not None and b > batch_tile:
            if b % batch_tile:
                raise ValueError(f"batch {b} not divisible by batch_tile "
                                 f"{batch_tile}")

            def chunk(*flat):
                return self.forward(list(zip(flat[::2], flat[1::2])),
                                    patch_hw)

            outs = []
            for i in range(0, b, batch_tile):
                flat = [t[i:i + batch_tile] for pair in features
                        for t in pair]
                if torch.is_grad_enabled():
                    # no random op in the head: no RNG state to stash
                    # (which a CUDA graph capture would refuse)
                    outs.append(torch.utils.checkpoint.checkpoint(
                        chunk, *flat, use_reentrant=False,
                        preserve_rng_state=False))
                else:
                    outs.append(chunk(*flat))
            return torch.cat(outs)
        cfg, sc = self.cfg, self.scratch
        ph, pw = patch_hw
        taps = []
        for i, (tokens, _cls) in enumerate(features):
            x = tokens.reshape(tokens.shape[0], ph, pw, tokens.shape[-1])
            taps.append(self.resize_layers[i](self.projects[i](x)))
        if cfg.use_input_projection:
            taps = [proj(x) for proj, x in zip(self.input_projection, taps)]
        l1, l2, l3, l4 = (getattr(sc, f"layer{i + 1}_rn")(x)
                          for i, x in enumerate(taps))

        path4 = sc.refinenet4(l4, None, size=tuple(l3.shape[1:3]))
        path3 = sc.refinenet3(path4, l3, size=tuple(l2.shape[1:3]))
        path2 = sc.refinenet2(path3, l2, size=tuple(l1.shape[1:3]))
        path1 = sc.refinenet1(path2, l1, size=None)

        out = sc.output_conv1(path1)
        out = resize2d(out, size=(ph * cfg.patch_size, pw * cfg.patch_size),
                       method="bilinear", align_corners=True)
        out = sc.output_conv2(out)
        if cfg.head_mode == "sigmoid":
            return torch.sigmoid(out)
        if cfg.head_mode == "relu":
            return F.relu(out)
        if cfg.head_mode != "linear":
            raise ValueError(f"unknown head_mode: {cfg.head_mode}")
        return out
