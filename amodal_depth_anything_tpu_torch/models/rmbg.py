"""RMBG-1.4 (ISNet / U^2-Net family) background matting as torch modules.

Port of the JAX package's `models/rmbg.py`, the matting net the demo runs
on the pix2gestalt completion:

  * REBNCONV = 3x3 (dilated) conv + BatchNorm + ReLU, the BatchNorm folded
    to a per-channel scale and shift (eval mode), as the JAX package folds
    it when weights load;
  * RSU-7/6/5/4: an encoder/decoder U inside the U with 2x2 max-pools and
    bilinear upsamples, plus the residual from the block's input conv;
    RSU-4F is the dilated, pool-free variant;
  * ISNet: stride-2 conv_in, six encoder stages with pools, five decoder
    stages on concatenated skips; the matte is sigmoid(side1), resized to
    the input.

Module names give briaai/RMBG-1.4's state-dict keys
(`stage1.rebnconvin.conv_s1.weight`, `stage5d.rebnconv2d.conv_s1.bias`,
`side1.weight`, ...), except that each `bn_s1` holds the folded `scale`
and `shift`: `convert.heuristics.fold_rmbg_batchnorm` turns the released
BatchNorm statistics into them. The max-pool is the JAX package's
`reduce_window` with "SAME" padding: torch's `max_pool2d(2, 2,
ceil_mode=True)`; the upsample is bilinear with half-pixel centres
(`ops.resize.resize2d`). Tensors are NHWC.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC
from ..ops.resize import resize2d

__all__ = ["RMBGConfig", "ISNet", "maxpool2"]


@dataclasses.dataclass(frozen=True)
class RMBGConfig:
    width: int = 64          # conv_in out channels (ISNet: 64)
    # (mid, out) channels per encoder stage; ISNet-DIS defaults
    stage_mid: tuple = (32, 32, 64, 128, 256, 256)
    stage_out: tuple = (64, 128, 256, 512, 512, 512)
    dec_mid: tuple = (16, 32, 64, 128, 256)  # decoder RSU mids (stage1d..5d)
    heights: tuple = (7, 6, 5, 4, 4, 4)  # RSU heights; last two are RSU4F


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, on NHWC; an odd edge keeps its last row or
    column alone ("SAME": ceil(n / 2) outputs)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _up_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return resize2d(x, size=tuple(ref.shape[1:3]), method="bilinear")


class FoldedBatchNorm(nn.Module):
    """Eval-mode BatchNorm as y * scale + shift."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.shift = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype) + self.shift.to(x.dtype)


class REBNCONV(nn.Module):
    def __init__(self, cin: int, cout: int, dilation: int = 1):
        super().__init__()
        self.conv_s1 = Conv2dNHWC(cin, cout, 3, padding=dilation,
                                  dilation=dilation)
        self.bn_s1 = FoldedBatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn_s1(self.conv_s1(x)))


class RSU(nn.Module):
    """RSU-`height` (or RSU-`height`F when `dilated`), the reference's
    `rebnconvin`, `rebnconv1..height` and `rebnconv{height-1..1}d`."""

    def __init__(self, height: int, cin: int, cmid: int, cout: int,
                 dilated: bool = False):
        super().__init__()
        self.height, self.dilated = height, dilated
        self.rebnconvin = REBNCONV(cin, cout)
        for i in range(1, height + 1):
            if dilated:
                dil = 2 ** (i - 1)
            else:  # the deepest encoder conv is dilated, the rest are not
                dil = 2 if i == height else 1
            setattr(self, f"rebnconv{i}",
                    REBNCONV(cout if i == 1 else cmid, cmid, dil))
        for i in range(height - 1, 0, -1):
            setattr(self, f"rebnconv{i}d",
                    REBNCONV(2 * cmid, cout if i == 1 else cmid,
                             2 ** (i - 1) if dilated else 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hx_in = self.rebnconvin(x)
        feats = [hx_in]
        h = hx_in
        for i in range(1, self.height + 1):
            h = getattr(self, f"rebnconv{i}")(h)
            feats.append(h)
            # pools sit after enc1 .. enc(height - 2) in a pooled RSU
            if not self.dilated and i < self.height - 1:
                h = maxpool2(h)
        h = feats[-1]
        for i in range(self.height - 1, 0, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, feats[i]], -1))
            if not self.dilated and i > 1:
                h = _up_to(h, feats[i - 1])
        return h + hx_in


class ISNet(nn.Module):
    """RMBG-1.4: [B,H,W,3] in [0,1] -> alpha matte [B,H,W,1] in [0,1]."""

    def __init__(self, cfg: RMBGConfig = RMBGConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv2dNHWC(3, cfg.width, 3, stride=2, padding=1)
        cin = cfg.width
        for s in range(6):
            setattr(self, f"stage{s + 1}",
                    RSU(cfg.heights[s], cin, cfg.stage_mid[s],
                        cfg.stage_out[s], dilated=s >= 4))
            cin = cfg.stage_out[s]
        dec_out = []
        for s in range(5, 0, -1):
            cin_d = cfg.stage_out[s] + cfg.stage_out[s - 1] \
                if s == 5 else dec_out[-1] + cfg.stage_out[s - 1]
            out_d = cfg.stage_out[max(s - 2, 0)]
            setattr(self, f"stage{s}d",
                    RSU(cfg.heights[s - 1], cin_d, cfg.dec_mid[s - 1], out_d,
                        dilated=s - 1 >= 4))
            dec_out.append(out_d)
        for i, ch in enumerate([dec_out[-1]] + dec_out[::-1][1:]
                               + [cfg.stage_out[5]]):
            setattr(self, f"side{i + 1}", Conv2dNHWC(ch, 1, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x - 0.5)
        skips = []
        for s in range(6):
            h = getattr(self, f"stage{s + 1}")(h)
            skips.append(h)
            if s < 5:
                h = maxpool2(h)
        d = skips[5]
        for s in range(5, 0, -1):
            d = _up_to(d, skips[s - 1])
            d = getattr(self, f"stage{s}d")(torch.cat([d, skips[s - 1]], -1))
        side1 = self.side1(d)
        return torch.sigmoid(resize2d(side1, size=tuple(x.shape[1:3]),
                                      method="bilinear"))
