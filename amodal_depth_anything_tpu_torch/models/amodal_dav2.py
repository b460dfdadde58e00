"""AmodalDAv2 and the raw Depth-Anything-V2 base model as torch modules.

Port of the JAX package's `models/amodal_dav2.py`:
  * `AmodalDAv2` (reference `src/models/amodalsynthdrive/dav2.py:21-90`)
    ImageNet-normalises the input, concatenates the guide channels that
    `guide_type` names, and runs the guided DepthAnythingV2 (DINOv2 + DPT
    head, sigmoid output unless an 'ssi' loss selects a linear head). The
    reference wraps it as `self.encoder`, so its keys start "encoder.".
  * `RawDAV2` (reference `depth_anything_v2_raw/dpt.py:146-183`), the
    frozen base-depth predictor: no guidance branch, no input_projection,
    ReLU head, squeezed channel, bare keys.

Inputs are NHWC RGB in [0, 1]; outputs [B, H', W', 1] (amodal) or
[B, H', W'] (raw) with H' = 14 * (H // 14).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from ..ops.conv import ConvTranspose2dNHWC, LayerNorm2d
from .dinov2 import (INTERMEDIATE_LAYER_IDX, DinoVisionTransformer,
                     PatchEmbed, ViTConfig)
from .dpt import DPTConfig, DPTHead
from .layers import LayerNorm, LayerScale

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "DAV2_PRESETS", "DAV2Config",
           "build_guide", "DepthAnythingV2", "AmodalDAv2", "RawDAV2",
           "build_model", "init_weights_"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Per-encoder decoder widths (reference `dav2.py:31-34`; the raw base uses
# the vitg-shaped head, reference `infer.py:60`).
DAV2_PRESETS = {
    "vitt": dict(features=16, out_channels=(8, 16, 32, 32)),
    "vitp": dict(features=32, out_channels=(16, 32, 64, 64)),
    "vits": dict(features=64, out_channels=(48, 96, 192, 384)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024)),
    "vitg": dict(features=384, out_channels=(1536, 1536, 1536, 1536)),
}


@dataclasses.dataclass(frozen=True)
class DAV2Config:
    encoder: str = "vitl"
    guide_type: str = "mask+observation"
    loss_strategy: str = "entire_target_object"
    raw: bool = False  # True -> base-depth predictor variant
    # Width/depth overrides of the encoder preset (narrow or shallow
    # variants of a released architecture); taps remap with depth.
    embed_dim: int | None = None
    num_heads: int | None = None
    depth: int | None = None

    @property
    def vit(self) -> ViTConfig:
        cfg = ViTConfig.preset(self.encoder,
                               "none" if self.raw else self.guide_type)
        if self.embed_dim is not None:
            heads = self.num_heads or max(1, self.embed_dim // 32)
            cfg = dataclasses.replace(cfg, embed_dim=self.embed_dim,
                                      num_heads=heads)
        if self.depth is not None:
            cfg = dataclasses.replace(cfg, depth=self.depth)
        return cfg

    @property
    def dpt(self) -> DPTConfig:
        preset = DAV2_PRESETS[self.encoder]
        if self.raw:
            head_mode = "relu"
        elif "ssi" in self.loss_strategy:
            head_mode = "linear"
        else:
            head_mode = "sigmoid"
        return DPTConfig(in_channels=self.vit.embed_dim,
                         features=preset["features"],
                         out_channels=preset["out_channels"],
                         head_mode=head_mode,
                         use_input_projection=not self.raw)

    @property
    def taps(self) -> tuple[int, ...]:
        taps = INTERMEDIATE_LAYER_IDX[self.encoder]
        if self.depth is None:
            return taps
        # proportional remap onto the shallow trunk, then repair to
        # strictly increasing within [0, depth-1]
        if self.depth < len(taps):
            raise ValueError(f"depth override {self.depth} < {len(taps)} "
                             f"DPT taps")
        d, pd = self.depth, ViTConfig.preset(self.encoder).depth
        m = [min(d - 1, round(t * (d - 1) / (pd - 1))) for t in taps]
        for i in range(1, len(m)):
            m[i] = max(m[i], m[i - 1] + 1)
        overflow = m[-1] - (d - 1)
        if overflow > 0:
            m = [v - overflow for v in m]
        for i in range(len(m) - 2, -1, -1):
            m[i] = min(m[i], m[i + 1] - 1)
        return tuple(m)


def build_guide(cfg: DAV2Config, guide_rgb=None, guide_mask=None,
                observation=None) -> torch.Tensor | None:
    """Concatenate guide channels per guide_type (reference dav2.py:67-82).
    NHWC; mask and observation have one channel in [-1, 1]."""
    parts = {
        "image+mask+observation": (guide_rgb, guide_mask, observation),
        "image+mask": (guide_rgb, guide_mask),
        "image+observation": (guide_rgb, observation),
        "mask+observation": (guide_mask, observation),
        "observation": (observation,),
        "mask": (guide_mask,),
        "none": (),
    }[cfg.guide_type]
    if not parts:
        return None
    for i, part in enumerate(parts):
        if part is None:
            raise ValueError(
                f"guide_type={cfg.guide_type!r} requires component {i}")
    return torch.cat(parts, dim=-1)


class DepthAnythingV2(nn.Module):
    """DINOv2 (`pretrained`) + DPT head (`depth_head`)."""

    def __init__(self, cfg: DAV2Config):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoVisionTransformer(cfg.vit)
        self.depth_head = DPTHead(cfg.dpt)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, x: torch.Tensor, guide: torch.Tensor | None = None, *,
                attn_impl: str | None = None, remat: bool | str = False,
                token_merge: tuple[int, int] | None = None,
                head_batch_tile: int | None = None) -> torch.Tensor:
        """`token_merge=(after_layer, r)`: ToMe in the trunk
        (`DinoVisionTransformer.get_intermediate_layers`);
        `head_batch_tile`: the head over batch chunks (`DPTHead`). Both
        opt-in serving knobs of the JAX `apply_amodal_dav2`."""
        x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        ph, pw = x.shape[1] // 14, x.shape[2] // 14
        feats = self.pretrained.get_intermediate_layers(
            x, guide, self.cfg.taps, attn_impl=attn_impl, remat=remat,
            token_merge=token_merge)
        return self.depth_head(feats, (ph, pw), batch_tile=head_batch_tile)


class AmodalDAv2(nn.Module):
    def __init__(self, cfg: DAV2Config):
        super().__init__()
        if cfg.raw:
            raise ValueError("AmodalDAv2 needs a guided config; use RawDAV2")
        self.cfg = cfg
        self.encoder = DepthAnythingV2(cfg)

    def forward(self, x: torch.Tensor, *, guide_rgb=None, guide_mask=None,
                observation=None, attn_impl: str | None = None,
                remat: bool | str = False,
                token_merge: tuple[int, int] | None = None,
                head_batch_tile: int | None = None):
        """x: [B,H,W,3] RGB in [0,1] -> depth [B,H',W',1], in x's dtype
        whatever the parameters' dtype. `remat`: False | True | "attn",
        what the trunk's blocks keep for the backward pass;
        `token_merge` / `head_batch_tile` as in `DepthAnythingV2`."""
        guide = build_guide(self.cfg, guide_rgb, guide_mask, observation)
        return self.encoder(x, guide, attn_impl=attn_impl, remat=remat,
                            token_merge=token_merge,
                            head_batch_tile=head_batch_tile)


class RawDAV2(DepthAnythingV2):
    """Base-depth predictor: [B,H,W,3] in [0,1] -> [B,H',W'] relative depth.

    The reference normalises on the host before the model (`infer.py:19`);
    it is folded in here, as in the JAX package."""

    def __init__(self, cfg: DAV2Config):
        if not cfg.raw:
            raise ValueError("RawDAV2 needs DAV2Config(raw=True)")
        super().__init__(cfg)

    def forward(self, x: torch.Tensor, *, attn_impl: str | None = None,
                token_merge: tuple[int, int] | None = None,
                head_batch_tile: int | None = None) -> torch.Tensor:
        return super().forward(x, attn_impl=attn_impl,
                               token_merge=token_merge,
                               head_batch_tile=head_batch_tile)[..., 0]


def build_model(cfg: DAV2Config, *, device=None,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """The module `cfg` describes (RawDAV2 or AmodalDAv2), parameters
    allocated on `device` and left uninitialised."""
    with torch.device("meta"):
        model = RawDAV2(cfg) if cfg.raw else AmodalDAv2(cfg)
    model = model.to_empty(device=device or "cpu").to(dtype)
    for mod in model.modules():
        if isinstance(mod, DepthAnythingV2):
            mod.mean.copy_(torch.tensor(IMAGENET_MEAN))
            mod.std.copy_(torch.tensor(IMAGENET_STD))
    return model


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init with the JAX package's scheme (`init_*`): linear
    trunc-normal(0.02) with zero bias; LayerNorm and LayerScale ones; the
    RGB patch embed normal(sqrt(1/fan_in)), the guidance embed zero; pos
    embed trunc-normal(0.02); cls and mask tokens zero; DPT convs
    uniform(+-1/sqrt(fan_in)); the transposed-conv resize layers zero.
    Draws from `generator`, which must live on the parameters' device."""
    nn_init = nn.init
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            nn_init.trunc_normal_(mod.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            mod.bias.zero_()
        elif isinstance(mod, (LayerNorm, LayerNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, LayerScale):
            mod.gamma.fill_(1.0)
        elif isinstance(mod, PatchEmbed):
            if name.endswith("patch_embed_guidance"):
                mod.proj.weight.zero_()
            else:
                fan = mod.proj.weight[0].numel()
                nn_init.normal_(mod.proj.weight, std=math.sqrt(1.0 / fan),
                                generator=generator)
            mod.proj.bias.zero_()
        elif isinstance(mod, ConvTranspose2dNHWC):
            mod.weight.zero_()
            mod.bias.zero_()
        elif isinstance(mod, nn.Conv2d) and ".depth_head." in f".{name}.":
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            nn_init.uniform_(mod.weight, -bound, bound, generator=generator)
            if mod.bias is not None:
                nn_init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, DinoVisionTransformer):
            nn_init.trunc_normal_(mod.pos_embed, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            mod.cls_token.zero_()
            mod.mask_token.zero_()
    for mod in model.modules():
        if isinstance(mod, DPTHead) and mod.cfg.head_mode == "relu":
            # the one departure from the JAX scheme: a ReLU head whose last
            # bias draws negative outputs zero everywhere at init (about
            # every other seed), and the base map then carries nothing
            last = mod.scratch.output_conv2[2]
            last.bias.fill_(1.0 / math.sqrt(last.weight[0].numel()))
    return model
