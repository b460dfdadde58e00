"""pix2gestalt: amodal completion by a latent-diffusion UNet, as torch
modules and one plain method.

Port of the JAX package's `Pix2GestaltConfig` and
`MaskHeuristics._p2g_jit` (`heuristics/mask_heuristics.py`): the SD-1.5
UNet body (`models.unet_ldm`, conv proj_in/out) whose conv-in takes the
noisy latent with the conditioning latents concatenated on channels, and
whose cross-attention reads ONE context token, the CLIP ViT-L/14 image
embedding (`models.clip_vit`); the SD VAE (`models.vae`) encodes the
conditioning images and decodes the sample; DDIM (`ops.ddim.ddim_sample`)
with classifier-free guidance runs the loop, both halves of the guidance in
one UNet call at batch 2B.

Conditioning layouts (`cond_mode`, read off conv-in's width by
`convert.heuristics.p2g_cfg_from_ckpt`):
  * "image+mask" (conv-in 12): VAE(image) ++ VAE(the visible mask as an RGB
    image); CLIP sees the occluded image by default;
  * "image" (conv-in 8): VAE(image) only; CLIP sees the masked object.
The unconditional half of the guidance zeroes both conditionings, the
concatenated latent and the context token.

At 256 px a UNet call makes 32 attention calls (16 self, 16 cross onto the
one token); with the joint batch they run at [2, 8, 1024, 40],
[2, 8, 256, 80], [2, 8, 64, 160] and [2, 8, 16, 160], so a completion
launches the forward kernel 24 (CLIP) + 32 x `ddim_steps` times.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..ops.ddim import ddim_sample
from ..ops.resize import resize2d
from .clip_vit import CLIPVisionConfig, CLIPVisionModelWithProjection
from .layers import Linear
from .unet_ldm import UNetConfig, UNetModel
from .vae import SD_VAE, AutoencoderKL, VAEConfig

__all__ = ["Pix2GestaltConfig", "Pix2Gestalt", "CLIP_MEAN", "CLIP_STD",
           "CLIP_INPUTS"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CLIP_INPUTS = ("auto", "occluded", "masked_object")


@dataclasses.dataclass(frozen=True)
class Pix2GestaltConfig:
    """pix2gestalt checkpoint hparams (SD-1.5 UNet body, the CLIP image
    embedding as a one-token context of width 768). `clip_input` picks the
    image CLIP sees ("auto": the occluded image for "image+mask", the
    masked object for "image"); `ddim_deep_cache` is DeepCache's
    (interval, shallow groups) over the DDIM steps, None for none."""
    image_size: int = 256
    context_dim: int = 768
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_heads: int = 8
    ddim_steps: int = 100
    guidance_scale: float = 1.5
    cond_mode: str = "image+mask"
    clip_input: str = "auto"
    ddim_deep_cache: tuple | None = None

    @property
    def unet(self) -> UNetConfig:
        cond_ch = 8 if self.cond_mode == "image+mask" else 4
        return UNetConfig(in_channels=4 + cond_ch,
                          context_dim=self.context_dim,
                          model_channels=self.model_channels,
                          channel_mult=tuple(self.channel_mult),
                          num_heads=self.num_heads,
                          use_linear_in_transformer=False)


class Pix2Gestalt(nn.Module):
    """The parameters of the completion program: `unet`, `vae`, `clip`, the
    unconditional context `uncond_ctx` [1, 1, context_dim] and, for
    zero123-lineage checkpoints, `cc_projection` ([CLIP ++ pose pad] ->
    context; `cc_in` its input width, 0 for none)."""

    def __init__(self, cfg: Pix2GestaltConfig,
                 clip_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 vae_cfg: VAEConfig = SD_VAE, *, cc_in: int = 0,
                 cc_bias: bool = True):
        super().__init__()
        self.cfg, self.clip_cfg, self.vae_cfg = cfg, clip_cfg, vae_cfg
        self.unet = UNetModel(cfg.unet)
        self.vae = AutoencoderKL(vae_cfg)
        self.clip = CLIPVisionModelWithProjection(clip_cfg)
        self.uncond_ctx = nn.Parameter(torch.zeros(1, 1, cfg.context_dim))
        self.cc_projection = (Linear(cc_in, cfg.context_dim, bias=cc_bias)
                              if cc_in else None)

    def context(self, image01: torch.Tensor, mask01: torch.Tensor,
                cfg: Pix2GestaltConfig):
        """(CLIP context [B,1,D], conditioning latents [B,h,w,C]) of images
        [B,S,S,3] and visible masks [B,S,S,1] in [0, 1]."""
        if cfg.clip_input not in CLIP_INPUTS:
            # a typo'd value would quietly fall through to one of the two
            raise ValueError(f"clip_input={cfg.clip_input!r}: expected one "
                             f"of {' | '.join(map(repr, CLIP_INPUTS))}")
        img_latent = self.vae.encode_mode(image01 * 2.0 - 1.0)
        if cfg.cond_mode == "image+mask":
            mask_rgb = mask01.expand_as(image01)
            cond = torch.cat([img_latent,
                              self.vae.encode_mode(mask_rgb * 2.0 - 1.0)], -1)
            default_clip = "occluded"
        else:
            cond, default_clip = img_latent, "masked_object"
        choice = default_clip if cfg.clip_input == "auto" else cfg.clip_input
        clip_in = image01 if choice == "occluded" else image01 * mask01
        size = self.clip_cfg.image_size
        clip_in = resize2d(clip_in, size=(size, size), method="bilinear")
        mean = torch.tensor(CLIP_MEAN, dtype=image01.dtype,
                            device=image01.device)
        std = torch.tensor(CLIP_STD, dtype=image01.dtype,
                           device=image01.device)
        ctx = self.clip((clip_in - mean) / std)[:, None]
        if self.cc_projection is not None:
            # zero123-lineage: [CLIP ++ pose] -> context; no pose here
            pad = ctx.new_zeros(ctx.shape[:-1] + (
                self.cc_projection.in_features - ctx.shape[-1],))
            ctx = self.cc_projection(torch.cat([ctx, pad], -1))
        return ctx, cond

    def sample(self, ctx: torch.Tensor, cond: torch.Tensor, rng, *,
               cfg: Pix2GestaltConfig | None = None) -> torch.Tensor:
        """The guided DDIM loop on `context`'s output -> latents [B,h,w,4].
        `rng`: a `torch.Generator` or the initial noise [B,h,w,4] (see
        `ops.ddim.ddim_sample`)."""
        cfg = cfg or self.cfg
        uncond = self.uncond_ctx.to(ctx.dtype).expand_as(ctx)
        zero = torch.zeros_like(cond)

        def eps_fn(ctx_tokens, concat):
            def f(x, t, **dc):
                return self.unet(x, t.to(x.dtype), context=concat,
                                 context_ca=ctx_tokens, **dc)
            return f

        # both guidance halves in one UNet call at batch 2B (exact: no op
        # of the UNet mixes samples)
        joint = eps_fn(torch.cat([ctx, uncond]), torch.cat([cond, zero]))
        return ddim_sample(eps_fn(ctx, cond), rng, (*cond.shape[:3], 4),
                           num_steps=cfg.ddim_steps,
                           guidance_scale=cfg.guidance_scale,
                           uncond_fn=eps_fn(uncond, zero), joint_fn=joint,
                           deep_cache=cfg.ddim_deep_cache, dtype=cond.dtype,
                           device=cond.device)

    def render(self, z: torch.Tensor) -> torch.Tensor:
        """Latents -> renders [B,S,S,3] in [0, 1]."""
        return torch.clamp((self.vae.decode(z) + 1.0) / 2.0, 0.0, 1.0)

    def complete(self, image01: torch.Tensor, mask01: torch.Tensor, rng, *,
                 cfg: Pix2GestaltConfig | None = None) -> torch.Tensor:
        """images [B,S,S,3] and visible masks [B,S,S,1] in [0, 1], in the
        compute dtype -> completion renders [B,S,S,3] in [0, 1]: `context`,
        `sample`, `render`. `cfg` overrides the module's (steps, guidance,
        `clip_input`, DeepCache)."""
        cfg = cfg or self.cfg
        ctx, cond = self.context(image01, mask01, cfg)
        return self.render(self.sample(ctx, cond, rng, cfg=cfg))
