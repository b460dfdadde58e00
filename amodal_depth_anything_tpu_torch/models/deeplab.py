"""ADDeepLab baseline: ResNet + ASPP + AdaBins decoder + dual depth heads.

Port of the JAX package's `models/deeplab.py` (reference
`src/models/amodalsynthdrive/deeplab.py:203-291`): ImageNet-normalised RGB
concatenated with the amodal guide mask (4-channel widened conv1,
:239-250), ResNet-50 stage features, DeepLabV3 ASPP on the last stage
(dilations 1/12/24/36 with a global image-pool branch, :210 and
:110-154), an AdaBins-style top-down decoder (1x1 entry + bilinear-
upsample-concat-conv fusion, :156-170), then TWO heads (:172-201,273-280):

  * visible depth head (conv5 -> up2x -> conv3 -> pred);
  * an mViT transformer decoder (:186-201): 4 post-norm
    `TransformerDecoderLayer`s whose queries are the patched decoder
    feature and whose memory is the visible head's intermediate map; the
    output refines the feature for the invisible head.

Both heads end in sigmoid. The mViT's self- and cross-attention run
through `ops/attention.py` (the hand-written Hopper kernels on the card)
at head dim 16: d0 = 128 over 8 heads, 16 x 16 tokens at 518 px (ResNet
stride 4, then an 8 x 8 patch conv). Module names follow the JAX tree
(`aspp_head.branchN`, `conv_list.N.convA`, `cross_att_layer.layers.N.
self_attn.qkv`, ...).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import multi_head_attention
from ..ops.conv import Conv2dNHWC
from ..ops.resize import resize2d
from .amodal_dav2 import IMAGENET_MEAN, IMAGENET_STD
from .layers import LayerNorm, Linear
from .resnet import ResNet, ResNetConfig

__all__ = ["ADDeepLabConfig", "ADDeepLab"]


@dataclasses.dataclass(frozen=True)
class ADDeepLabConfig:
    channels: Sequence[int] = (256, 512, 1024, 2048)
    up_sample_channels: Sequence[int] = (128, 256, 512, 1024)
    aspp_dilations: Sequence[int] = (1, 12, 24, 36)
    aspp_channels: int = 512
    patch_size: int = 8
    mvit_heads: int = 8
    mvit_layers: int = 4
    mvit_ff: int = 1024
    resnet: ResNetConfig = ResNetConfig(in_channels=4)


def _mha(q, k, v, heads: int, attn_impl):
    b, n, c = q.shape
    d = c // heads
    qh, kh, vh = (t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
                  for t in (q, k, v))
    o = multi_head_attention(qh, kh, vh, impl=attn_impl)
    return o.transpose(1, 2).reshape(b, n, c)


class _SelfAttn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = Linear(d, 3 * d)
        self.out = Linear(d, d)


class _CrossAttn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = Linear(d, d)
        self.kv = Linear(d, 2 * d)
        self.out = Linear(d, d)


class _FF(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.fc1 = Linear(d, ff)
        self.fc2 = Linear(ff, d)


class DecoderLayer(nn.Module):
    """torch `TransformerDecoderLayer` (post-norm): self-attention,
    cross-attention onto the memory, ReLU feed-forward."""

    def __init__(self, d: int, heads: int, ff: int):
        super().__init__()
        self.heads = heads
        self.self_attn = _SelfAttn(d)
        self.cross_attn = _CrossAttn(d)
        self.ff = _FF(d, ff)
        # nn.LayerNorm's eps (1e-5) in float32, the JAX `_ln`
        self.norm1, self.norm2, self.norm3 = (LayerNorm(d, eps=1e-5)
                                              for _ in range(3))

    def forward(self, tgt, memory, attn_impl):
        q, k, v = self.self_attn.qkv(tgt).chunk(3, dim=-1)
        tgt = self.norm1(tgt + self.self_attn.out(
            _mha(q, k, v, self.heads, attn_impl)))
        q = self.cross_attn.q(tgt)
        k, v = self.cross_attn.kv(memory).chunk(2, dim=-1)
        tgt = self.norm2(tgt + self.cross_attn.out(
            _mha(q, k, v, self.heads, attn_impl)))
        h = self.ff.fc2(F.relu(self.ff.fc1(tgt)))
        return self.norm3(tgt + h)


class _DepthHead(nn.Module):
    def __init__(self, d0: int):
        super().__init__()
        self.conv_1 = Conv2dNHWC(d0, d0, 5, padding=2, bias=False)
        self.conv_2 = Conv2dNHWC(d0, d0, 3, padding=1, bias=False)
        self.pred = Conv2dNHWC(d0, 1, 3, padding=1, bias=False)

    def forward(self, x):
        ym = F.relu(self.conv_1(x))
        h = resize2d(ym, scale_factor=2.0, method="bilinear",
                     align_corners=True)
        return ym, self.pred(F.relu(self.conv_2(h)))


class ADDeepLab(nn.Module):
    def __init__(self, cfg: ADDeepLabConfig = ADDeepLabConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = ResNet(cfg.resnet)
        c_last, ac = cfg.channels[-1], cfg.aspp_channels
        # the whole decoder uses Conv2DModule(bias=False) in the reference
        # (deeplab.py:40-75 default); only the mViT patch convs carry bias
        aspp = nn.Module()
        aspp.image_pool = Conv2dNHWC(c_last, ac, 1, bias=False)
        for i, d in enumerate(cfg.aspp_dilations):
            setattr(aspp, f"branch{i}", Conv2dNHWC(
                c_last, ac, 1, bias=False) if d == 1 else Conv2dNHWC(
                c_last, ac, 3, padding=d, dilation=d, bias=False))
        aspp.bottleneck = Conv2dNHWC((len(cfg.aspp_dilations) + 1) * ac,
                                     c_last, 3, padding=1, bias=False)
        self.aspp_head = aspp

        conv_list = []
        up_prev = None
        for i, (cin, cup) in enumerate(zip(cfg.channels[::-1],
                                           cfg.up_sample_channels[::-1])):
            m = nn.Module()
            if i == 0:
                m.conv = Conv2dNHWC(cin, cup, 1, bias=False)
            else:
                m.convA = Conv2dNHWC(cin + up_prev, cup, 3, padding=1,
                                     bias=False)
                m.convB = Conv2dNHWC(cup, cup, 3, padding=1, bias=False)
            conv_list.append(m)
            up_prev = cup
        self.conv_list = nn.ModuleList(conv_list)

        d0 = cfg.up_sample_channels[0]
        self.visible_depth_head = _DepthHead(d0)
        self.in_visible_depth_head = _DepthHead(d0)
        ca = nn.Module()
        ps = cfg.patch_size
        ca.patch_x = Conv2dNHWC(d0, d0, ps, stride=ps)
        ca.patch_ym = Conv2dNHWC(d0, d0, ps, stride=ps)
        ca.layers = nn.ModuleList(
            DecoderLayer(d0, cfg.mvit_heads, cfg.mvit_ff)
            for _ in range(cfg.mvit_layers))
        self.cross_att_layer = ca
        self.register_buffer("mean", torch.empty(3), persistent=False)
        self.register_buffer("std", torch.empty(3), persistent=False)
        self.reset_constants_()

    @torch.no_grad()
    def reset_constants_(self) -> None:
        """The ImageNet normalisation buffers (left empty by a build on the
        meta device)."""
        self.mean.copy_(torch.tensor(IMAGENET_MEAN))
        self.std.copy_(torch.tensor(IMAGENET_STD))

    def forward(self, x: torch.Tensor, guide_mask: torch.Tensor | None = None,
                *, train: bool = False, attn_impl: str | None = None,
                **_unused):
        """x: [B,H,W,3] in [0,1]; guide_mask: [B,H,W,1].

        Returns (visible_depth, invisible_depth), both [B,H/2,W/2,1]
        sigmoid (the heads predict at half input resolution: the /4 decoder
        output upsampled 2x). `train=True` normalises every BatchNorm with
        batch statistics and moves its running stats in place."""
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        h = torch.cat([x, guide_mask.to(x.dtype)], dim=-1)
        feats = self.encoder(h, train=train)
        return self.decoder(feats, attn_impl=attn_impl)

    def decoder(self, feats, *, attn_impl=None):
        """ASPP -> top-down fusion -> dual heads + mViT on the backbone
        features [stride 4/8/16/32] (reference forward,
        deeplab.py:252-281)."""
        cfg, aspp = self.cfg, self.aspp_head
        last = feats[-1]
        pool = last.mean(dim=(1, 2), keepdim=True)
        pool = F.relu(aspp.image_pool(pool))
        pool = resize2d(pool, size=tuple(last.shape[1:3]), method="bilinear",
                        align_corners=True)
        branches = [pool] + [
            F.relu(getattr(aspp, f"branch{i}")(last))
            for i in range(len(cfg.aspp_dilations))]
        cur_in = F.relu(aspp.bottleneck(torch.cat(branches, dim=-1)))

        top_down = (list(feats[:-1]) + [cur_in])[::-1]
        cur = None
        for i, feat in enumerate(top_down):
            m = self.conv_list[i]
            if i == 0:
                cur = F.relu(m.conv(feat))
            else:
                up = resize2d(cur, size=tuple(feat.shape[1:3]),
                              method="bilinear", align_corners=True)
                cur = F.relu(m.convA(torch.cat([up, feat], dim=-1)))
                cur = F.relu(m.convB(cur))

        ym, visible_pred = self.visible_depth_head(cur)
        ca = self.cross_att_layer
        xp, yp = ca.patch_x(cur), ca.patch_ym(ym)
        b, gh, gw, d0 = xp.shape
        tgt = xp.reshape(b, gh * gw, d0)
        mem = yp.reshape(b, gh * gw, d0)
        for layer in ca.layers:
            tgt = layer(tgt, mem, attn_impl)
        att_up = resize2d(tgt.reshape(b, gh, gw, d0),
                          size=tuple(cur.shape[1:3]), method="bilinear",
                          align_corners=True)
        _, invisible_pred = self.in_visible_depth_head(cur + att_up)
        return torch.sigmoid(visible_pred), torch.sigmoid(invisible_pred)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "ADDeepLab":
        """Seeded random init with the JAX scheme (`init_addeeplab`): convs
        uniform(+-1/sqrt(fan_in)), the mViT linears uniform(+-1/sqrt(in))
        for weight and bias, norms ones/zeros, running stats 0/1, and the
        guide-mask input channel of conv1 zero."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.uniform_(-bound, bound, generator=generator)
                if mod.bias is not None:
                    mod.bias.uniform_(-bound, bound, generator=generator)
        reset_norms_(self)
        self.encoder.conv1.weight[:, 3:] = 0.0
        return self


def reset_norms_(model: nn.Module) -> None:
    """Norm scales to one, shifts to zero, running stats to 0 / 1."""
    for mod in model.modules():
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            t = getattr(mod, name, None)
            if t is not None and not isinstance(
                    mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
                t.data.fill_(value)
