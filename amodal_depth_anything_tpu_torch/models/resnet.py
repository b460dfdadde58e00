"""ResNet feature backbone (NHWC) for the ADDeepLab baseline.

Port of the JAX package's `models/resnet.py`: the reference builds its
encoder with `timm.create_model('resnet50', features_only=True)` and widens
conv1 to 4 input channels (`src/models/amodalsynthdrive/deeplab.py:208,
239-250`); this is a ResNet-50 v1 (bottleneck blocks, BN) returning the four
stage features [256, 512, 1024, 2048] at strides 4/8/16/32. Module names
are torchvision's (`conv1`, `bn1`, `layerN.i.conv1`, `downsample.0/1`).

BatchNorm (`BatchNorm2d`, on NHWC) follows the JAX rule and not
`nn.BatchNorm2d`'s code path: statistics in float32 whatever the input's
dtype; with `train=True` it normalises with the biased batch variance and
moves the running stats in place with momentum 0.1 and the *unbiased*
variance (the JAX package returns them as `new_bn`); otherwise it
normalises with the running stats. `nn.BatchNorm2d` computes the same only
when it is fed float32 (tests/test_torch_baselines.py holds both to the
JAX rule).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC
from ..parallel.comm import batch_count, batch_sum, reduction_group

__all__ = ["BN_MOMENTUM", "BN_EPS", "ResNetConfig", "BatchNorm2d",
           "batch_norm", "update_running_stats_", "ResNet"]

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    in_channels: int = 4          # rgb + guide mask (widened conv1)
    layers: Sequence[int] = (3, 4, 6, 3)  # resnet50
    width: int = 64

    @property
    def stage_channels(self):
        return tuple(self.width * 4 * (2 ** i) for i in range(4))


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, *,
               train: bool, weight=None, bias=None):
    """The JAX package's BatchNorm on NHWC `x`, in float32. With `train`,
    returns (y, batch mean, unbiased batch variance), else (y, None, None)
    with the given running `mean` / `var`. Inside a data reduction
    (`parallel.comm.data_reduction`) the batch statistics are the global
    batch's."""
    xf = x.float()
    stats = (None, None)
    if train and reduction_group() is not None:
        # data parallelism: the global batch's statistics (SyncBatchNorm)
        n = batch_count(x, 0) * (x.shape[1] * x.shape[2])
        mean = batch_sum(xf.sum(dim=(0, 1, 2))) / n
        var = batch_sum((xf - mean).square().sum(dim=(0, 1, 2))) / n
        stats = (mean.detach(),
                 var.detach() * n / torch.clamp(n - 1, min=1))
    elif train:
        mean = xf.mean(dim=(0, 1, 2))
        var = xf.var(dim=(0, 1, 2), correction=0)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        stats = (mean.detach(), var.detach() * n / max(n - 1, 1))
    y = (xf - mean) * torch.rsqrt(var + BN_EPS)
    if weight is not None:
        y = y * weight + bias
    return (y.to(x.dtype),) + stats


def update_running_stats_(running_mean: torch.Tensor,
                          running_var: torch.Tensor, stats) -> None:
    with torch.no_grad():
        mean, unbiased = stats
        running_mean.copy_((1 - BN_MOMENTUM) * running_mean
                           + BN_MOMENTUM * mean)
        running_var.copy_((1 - BN_MOMENTUM) * running_var
                          + BN_MOMENTUM * unbiased)


class BatchNorm2d(nn.Module):
    """BatchNorm on NHWC with `nn.BatchNorm2d`'s state-dict keys (`weight`,
    `bias`, `running_mean`, `running_var`); see the module docstring."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y, *stats = batch_norm(x, self.running_mean, self.running_var,
                               train=train, weight=self.weight,
                               bias=self.bias)
        if train:
            update_running_stats_(self.running_mean, self.running_var, stats)
        return y


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2dNHWC(cin, cmid, 1, bias=False)
        self.bn1 = BatchNorm2d(cmid)
        self.conv2 = Conv2dNHWC(cmid, cmid, 3, stride=stride, padding=1,
                                bias=False)
        self.bn2 = BatchNorm2d(cmid)
        self.conv3 = Conv2dNHWC(cmid, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout)
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2dNHWC(cin, cout, 1, stride=stride, bias=False),
                BatchNorm2d(cout))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.relu(self.bn2(self.conv2(h), train))
        h = self.bn3(self.conv3(h), train)
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x), train)
        return F.relu(h + x)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig = ResNetConfig()):
        super().__init__()
        self.cfg = cfg
        self.conv1 = Conv2dNHWC(cfg.in_channels, cfg.width, 7, stride=2,
                                padding=3, bias=False)
        self.bn1 = BatchNorm2d(cfg.width)
        cin = cfg.width
        for stage, n_blocks in enumerate(cfg.layers):
            cmid = cfg.width * (2 ** stage)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(Bottleneck(cin, cmid, cmid * 4, stride))
                cin = cmid * 4
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))

    def forward(self, x: torch.Tensor, *,
                train: bool = False) -> list[torch.Tensor]:
        """x: [B,H,W,in_channels] -> [c2, c3, c4, c5] features."""
        h = F.relu(self.bn1(self.conv1(x), train))
        # maxpool 3x3 stride 2 pad 1 (padding is -inf, as the JAX window)
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        feats = []
        for stage in range(len(self.cfg.layers)):
            for block in getattr(self, f"layer{stage + 1}"):
                h = block(h, train)
            feats.append(h)
        return feats
