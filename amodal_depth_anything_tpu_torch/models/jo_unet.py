"""jo_amodal small U-Net family.

Port of the JAX package's `models/jo_unet.py` (the reference's vendored
plain U-Nets, `src/models/amodalsynthdrive/jo_amodal/unet/unet_model.py:
7-90`, `unet_parts.py:8-88`): `inconv` double-conv stem, maxpool `down`
stages, bilinear align_corners=True `up` stages with asymmetric odd-size
padding and skip concat `[skip, upsampled]`, and a 1x1 `outconv`. Three
depths (D2 / D3 / full, depth 4) with a width multiplier `w` (the
reference's `unet025 ... unet4` factories are `w` presets).

Vestigial in the reference (reachable from no main entry point); NHWC;
BatchNorm as in `models/resnet.py` (running stats move in place with
`train=True`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC
from ..ops.resize import resize2d
from .deeplab import reset_norms_
from .resnet import BatchNorm2d

__all__ = ["JoUNetConfig", "JoUNet"]


@dataclasses.dataclass(frozen=True)
class JoUNetConfig:
    in_channels: int = 3
    n_classes: int = 2
    w: float = 4.0
    depth: int = 4  # 2 = UNetD2, 3 = UNetD3, 4 = UNet

    def _c(self, mult: int) -> int:
        return int(mult * self.w)

    @property
    def plan(self):
        """(inc_ch, [down out_ch...], [up (in_ch, out_ch)...]): the channel
        schedule of unet_model.py:9-16 / 28-38 / 52-64."""
        c = self._c
        if self.depth == 2:
            return c(16), [c(32), c(32)], [(c(64), c(16)), (c(32), c(16))]
        if self.depth == 3:
            return (c(16), [c(32), c(64), c(64)],
                    [(c(128), c(32)), (c(64), c(16)), (c(32), c(16))])
        if self.depth == 4:
            return (c(16), [c(32), c(64), c(128), c(128)],
                    [(c(256), c(64)), (c(128), c(32)), (c(64), c(16)),
                     (c(32), c(16))])
        raise ValueError(f"depth must be 2/3/4, got {self.depth}")


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv2dNHWC(cin, cout, 3, padding=1)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2dNHWC(cout, cout, 3, padding=1)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x, train: bool):
        h = F.relu(self.bn1(self.conv1(x), train))
        return F.relu(self.bn2(self.conv2(h), train))


class JoUNet(nn.Module):
    def __init__(self, cfg: JoUNetConfig = JoUNetConfig()):
        super().__init__()
        self.cfg = cfg
        inc_ch, downs, ups = cfg.plan
        self.inc = DoubleConv(cfg.in_channels, inc_ch)
        ch = inc_ch
        for i, cout in enumerate(downs):
            setattr(self, f"down{i}", DoubleConv(ch, cout))
            ch = cout
        for i, (cin, cout) in enumerate(ups):
            setattr(self, f"up{i}", DoubleConv(cin, cout))
        self.outc = Conv2dNHWC(ups[-1][1], cfg.n_classes, 1)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                **_unused) -> torch.Tensor:
        """x: [B,H,W,in_channels] -> logits [B,H,W,n_classes] (forward of
        unet_model.py:17-24/39-48/66-77)."""
        _, downs, ups = self.cfg.plan
        skips = [self.inc(x, train)]
        for i in range(len(downs)):
            pooled = F.max_pool2d(skips[-1].permute(0, 3, 1, 2), 2, 2)
            skips.append(getattr(self, f"down{i}")(
                pooled.permute(0, 2, 3, 1), train))
        h = skips.pop()
        for i in range(len(ups)):
            skip = skips.pop()
            # unet_parts.py:49-78: bilinear 2x, pad the upsampled map to the
            # skip's size (left/top gets diff//2), concat [skip, up]
            up = resize2d(h, scale_factor=2.0, method="bilinear",
                          align_corners=True)
            dy = skip.shape[1] - up.shape[1]
            dx = skip.shape[2] - up.shape[2]
            if dy or dx:
                up = F.pad(up, (0, 0, dx // 2, dx - dx // 2, dy // 2,
                                dy - dy // 2))
            h = getattr(self, f"up{i}")(torch.cat([skip, up], dim=-1), train)
        return self.outc(h)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "JoUNet":
        """Seeded random init with the JAX scheme: convs
        uniform(+-1/sqrt(fan_in)), BatchNorm ones/zeros, stats 0/1."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
        reset_norms_(self)
        return self
