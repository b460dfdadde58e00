"""PartialCompletionContentDPT baseline (jo_amodal DPT + SPADE).

Port of the JAX package's `models/jo_dpt.py` (reference
`src/models/amodalsynthdrive/jo_amodal/PartialCompletionContentDPT.py:26-58`
and `jo_amodal/dpt/`): a timm-style ViT-L/16-384 trunk whose patch
embedding takes 4 channels (rgb + amodal guide mask, `vit.py:291`), hook
taps at blocks [5,11,17,23], the 'project' readout (cls concatenated onto
every token -> linear + GELU), the DPT reassemble convs, SPADE blocks that
modulate each fusion input with the nearest-resized guide mask
(`SPADE.py:13-56`: parameter-free BatchNorm, shared conv + relu, gamma /
beta convs, x_norm * (1 + gamma) + beta), the refinenets, and the MiDaS
output head, sigmoid-wrapped.

The trunk's blocks are the port's DINOv2 `Block`s without LayerScale, so
their attention runs the hand-written kernels on the card ([B,16,1025,64]
at 518 px). The patch embedding is a stride-16 convolution, as the
reference's: it drops the image's last H % 16 rows and W % 16 columns (518
px -> a 32 x 32 grid). The JAX package's space-to-depth embedding needs a
multiple of 16 and fails at 518; the two agree wherever it runs.

SPADE's running statistics (`spade.N.param_free_norm.running_mean` /
`running_var`) follow the JAX package as its registry uses them: they are
entries of the model's parameter tree, and `train=True` normalises with
batch statistics but leaves them where they are (the JAX registry drops
the new stats, `models/__init__.py:183`). Under the discriminative trainer,
which never passes `train`, they normalise in every step and the optimizer
moves them like any other parameter, as it does in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import Conv2dNHWC, ConvTranspose2dNHWC
from ..ops.resize import resize2d, resize_nearest
from .deeplab import reset_norms_
from .dinov2 import PatchEmbed
from .dpt import FeatureFusionBlock
from .layers import DEFAULT_LN_EPS, Block, LayerNorm, Linear
from .resnet import batch_norm

__all__ = ["JoDPTConfig", "JoDPT", "DPTReadout", "init_dpt_readout_"]


@dataclasses.dataclass(frozen=True)
class JoDPTConfig:
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    patch_size: int = 16
    img_size: int = 384
    in_chans: int = 4
    hooks: tuple = (5, 11, 17, 23)
    tap_channels: tuple = (256, 512, 1024, 1024)
    features: int = 256
    spade_hidden: int = 128

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


class DPTReadout(nn.Module):
    """The MiDaS/DPT reassemble and scratch stack shared by jo_dpt and
    ZoeDepth's core: per tap a 'project' readout (`readout.N`), a 1x1
    projection and the resize layer (`reassemble.N.project` / `.resize`),
    the scratch 3x3 convs and four refinenets, and the output convs."""

    def __init__(self, embed_dim: int, tap_channels, features: int,
                 out_mid: int = 32):
        super().__init__()
        d = embed_dim
        self.readout = nn.ModuleList(Linear(2 * d, d) for _ in tap_channels)
        c0, c1, _, c3 = tap_channels
        reassemble = []
        for i, ch in enumerate(tap_channels):
            m = nn.Module()
            m.project = Conv2dNHWC(d, ch, 1)
            if i == 0:
                m.resize = ConvTranspose2dNHWC(c0, c0, 4, stride=4)
            elif i == 1:
                m.resize = ConvTranspose2dNHWC(c1, c1, 2, stride=2)
            elif i == 3:
                m.resize = Conv2dNHWC(c3, c3, 3, stride=2, padding=1)
            reassemble.append(m)
        self.reassemble = nn.ModuleList(reassemble)
        sc = nn.Module()
        for i, ch in enumerate(tap_channels):
            setattr(sc, f"layer{i + 1}_rn",
                    Conv2dNHWC(ch, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(sc, f"refinenet{i}", FeatureFusionBlock(features))
        oc = nn.Module()
        oc.conv1 = Conv2dNHWC(features, features // 2, 3, padding=1)
        oc.conv2 = Conv2dNHWC(features // 2, out_mid, 3, padding=1)
        oc.conv3 = Conv2dNHWC(out_mid, 1, 1)
        sc.output_conv = oc
        self.scratch = sc

    def taps_to_maps(self, taps, grid_hw):
        """Token taps [B, 1+N, D] -> the four scratch maps (layerN_rn)."""
        gh, gw = grid_hw
        maps = []
        for i, tok in enumerate(taps):
            cls_t = tok[:, :1].expand_as(tok[:, 1:])
            proj = F.gelu(self.readout[i](torch.cat([tok[:, 1:], cls_t],
                                                    dim=-1)))
            fm = proj.reshape(tok.shape[0], gh, gw, tok.shape[-1])
            m = self.reassemble[i]
            fm = m.project(fm)
            if hasattr(m, "resize"):
                fm = m.resize(fm)
            maps.append(getattr(self.scratch, f"layer{i + 1}_rn")(fm))
        return maps

    def output_head(self, path1):
        """conv3 -> 2x bilinear up -> conv3 -> relu: (the 32-channel map,
        conv1x1 of it)."""
        oc = self.scratch.output_conv
        out = resize2d(oc.conv1(path1), scale_factor=2.0, method="bilinear",
                       align_corners=True)
        out = F.relu(oc.conv2(out))
        return out, oc.conv3(out)


@torch.no_grad()
def init_dpt_readout_(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX init of the readout stack: readout linears trunc-normal(0.02)
    with zero bias, convs uniform(+-1/sqrt(fan_in)), the transposed-conv
    resize layers zero."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            nn.init.trunc_normal_(mod.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.ConvTranspose2d):
            mod.weight.zero_()
            mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=generator)


class ParamFreeNorm(nn.Module):
    """SPADE's `param_free_norm` (BatchNorm2d without affine); its running
    statistics are parameters of the tree, as in the JAX package."""

    def __init__(self, ch: int):
        super().__init__()
        self.running_mean = nn.Parameter(torch.zeros(ch))
        self.running_var = nn.Parameter(torch.ones(ch))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return batch_norm(x, self.running_mean, self.running_var,
                          train=train)[0]


class SPADE(nn.Module):
    def __init__(self, ch: int, hidden: int):
        super().__init__()
        self.param_free_norm = ParamFreeNorm(ch)
        self.mlp_shared = Conv2dNHWC(1, hidden, 3, padding=1)
        self.mlp_gamma = Conv2dNHWC(hidden, ch, 3, padding=1)
        self.mlp_beta = Conv2dNHWC(hidden, ch, 3, padding=1)

    def forward(self, x, seg, train: bool):
        normalized = self.param_free_norm(x, train)
        seg = resize_nearest(seg, size=tuple(x.shape[1:3])).to(x.dtype)
        h = F.relu(self.mlp_shared(seg))
        return normalized * (1.0 + self.mlp_gamma(h)) + self.mlp_beta(h)


class JoDPT(DPTReadout):
    def __init__(self, cfg: JoDPTConfig = JoDPTConfig()):
        super().__init__(cfg.embed_dim, cfg.tap_channels, cfg.features)
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.in_chans, d, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid ** 2 + 1, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, init_values=None)
            for _ in range(cfg.depth))
        # in the tree (and the reference checkpoint), not on the DPT path
        self.norm = LayerNorm(d, eps=DEFAULT_LN_EPS)
        self.spade = nn.ModuleDict({str(i): SPADE(cfg.features,
                                                  cfg.spade_hidden)
                                    for i in range(1, 5)})

    def forward(self, x: torch.Tensor, guide_rgb=None,
                guide_mask: torch.Tensor | None = None, observation=None, *,
                train: bool = False, attn_impl: str | None = None,
                **_unused) -> torch.Tensor:
        """x: [B,H,W,3] rgb; guide_mask: [B,H,W,1]. Returns the sigmoid
        depth [B, 32*(H//16), 32*(W//16), 1]."""
        cfg = self.cfg
        h_img = torch.cat([x, guide_mask.to(x.dtype)], dim=-1)
        gh, gw = h_img.shape[1] // cfg.patch_size, \
            h_img.shape[2] // cfg.patch_size
        tokens = self.patch_embed(h_img)
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        pe = self.pos_embed
        if gh * gw + 1 != pe.shape[1]:
            # timm _resize_pos_embed: bilinear, align_corners=False
            g0 = int((pe.shape[1] - 1) ** 0.5)
            grid = pe[:, 1:].reshape(1, g0, g0, -1).float()
            grid = resize2d(grid, size=(gh, gw), method="bilinear")
            pe = torch.cat([pe[:, :1],
                            grid.reshape(1, gh * gw, -1).to(pe.dtype)], dim=1)
        tokens = tokens + pe.to(tokens.dtype)

        taps = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, attn_impl=attn_impl)
            if i in cfg.hooks:
                taps.append(tokens)
            if i >= cfg.hooks[-1]:
                break
        l1, l2, l3, l4 = self.taps_to_maps(taps, (gh, gw))

        sc, sp = self.scratch, self.spade
        path4 = sc.refinenet4(sp["4"](l4, guide_mask, train), None, None)
        path3 = sc.refinenet3(sp["3"](path4, guide_mask, train), l3, None)
        path2 = sc.refinenet2(sp["2"](path3, guide_mask, train), l2, None)
        path1 = sc.refinenet1(sp["1"](path2, guide_mask, train), l1, None)
        return torch.sigmoid(self.output_head(path1)[1])

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "JoDPT":
        """Seeded random init with the JAX scheme (`init_jo_dpt`): trunk
        linears trunc-normal(0.02), patch embed and pos embed normal(0.02),
        cls token zero, DPT and SPADE convs uniform(+-1/sqrt(fan_in)), the
        transposed convs zero, norms ones/zeros, SPADE stats 0/1."""
        init_dpt_readout_(self, generator)
        self.patch_embed.proj.weight.normal_(0.0, 0.02, generator=generator)
        self.patch_embed.proj.bias.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.cls_token.zero_()
        reset_norms_(self)
        return self
