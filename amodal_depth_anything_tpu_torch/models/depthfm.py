"""DepthFM / DepthFMAmodal: flow-matching depth in SD latent space.

Port of the JAX package's `models/depthfm.py`
(reference `src/models/depthfm/dfm.py:17-159`, `dfm_amodal.py:34-346`):

  * the SD-1.5 VAE (`models.vae`) encodes the image (and a guide image)
    into 4-channel latents; mask and observation guides are bilinearly
    downsampled to the latent resolution (`dfm_amodal.py:185-219`);
  * the LDM UNet (`models.unet_ldm`) takes x_t with the conditioning
    latents concatenated on channels and the empty-text embedding through
    cross-attention; conv-in is widened by `additional_dim` channels;
  * training (`depthfm_train_outputs`): x_0 = the cosine-noised image latent
    at `noising_step`, x_1 = the depth latent, x_t their linear
    interpolation at a random t; the target is x_1 - x_0
    (`dfm_amodal.py:225-244`);
  * inference: x_0 as in training, a fixed-step Euler solve of the flow ODE
    over `num_steps` (a Python loop where the JAX package scans), decode,
    channel mean, depth = 1 - clamp((d + 1) / 2) (`dfm_amodal.py:246-265`).

Randomness is explicit: every function that noises takes `rng`, either a
`torch.Generator` (the noise is drawn on the generator's device in float32
and moved to the latents' device and dtype, so a CPU generator gives one
result on the card and on the CPU) or a ready noise tensor of the latents'
shape.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from ..ops.resize import resize2d
from .unet_ldm import GroupNorm, UNetConfig, UNetModel
from .vae import AutoencoderKL, VAEConfig

__all__ = ["GUIDE_LATENT_DIMS", "DepthFMConfig", "DepthFM", "build_depthfm",
           "init_depthfm_", "cosine_alpha_bar", "q_sample",
           "depthfm_train_outputs", "depthfm_generate",
           "depthfm_predict_depth"]

# guide latent channels: VAE latent (4) for image; 1 each for mask/obs
GUIDE_LATENT_DIMS = {
    "image+mask+observation": 6, "image+mask": 5, "image+observation": 5,
    "mask+observation": 2, "mask": 1, "observation": 1, "image": 4,
    "none": 0,
}


@dataclasses.dataclass(frozen=True)
class DepthFMConfig:
    guide_type: str = "mask+observation"
    noising_step: int = 400
    n_diffusion_timesteps: int = 1000
    context_dim: int = 1024
    context_len: int = 77
    # UNet size (SD-1.5 defaults; shrink for tests)
    model_channels: int = 320
    channel_mult: tuple = (1, 2, 4, 4)
    num_heads: int = 8
    num_res_blocks: int = 2
    # VAE size
    vae_channels: tuple = (128, 256, 512, 512)
    vae_layers: int = 2

    @property
    def additional_dim(self) -> int:
        return GUIDE_LATENT_DIMS[self.guide_type]

    @property
    def unet(self) -> UNetConfig:
        # the base DepthFM UNet is 8-in (image latent 4 + depth latent 4);
        # the amodal variant widens conv-in by additional_dim
        return UNetConfig(in_channels=8 + self.additional_dim,
                          context_dim=self.context_dim,
                          model_channels=self.model_channels,
                          channel_mult=tuple(self.channel_mult),
                          num_heads=self.num_heads,
                          num_res_blocks=self.num_res_blocks)

    @property
    def vae(self) -> VAEConfig:
        return VAEConfig(block_out_channels=tuple(self.vae_channels),
                         layers_per_block=self.vae_layers)


def cosine_alpha_bar(t: torch.Tensor) -> torch.Tensor:
    """sigmoid(-2 log(tan(pi t / 2) + eps)) (ref. dfm_amodal.py:305-318)."""
    eps = 1e-5
    log_snr = -2.0 * torch.log(torch.tan((math.pi * t) / 2.0) + eps)
    return torch.sigmoid(log_snr)


def q_sample(x_start: torch.Tensor, t, noise: torch.Tensor,
             n_diffusion_timesteps: int = 1000) -> torch.Tensor:
    """Cosine-schedule forward noising q(x_t | x_0); t in diffusion steps.

    A Python number becomes a device scalar by a fill, not a copy from the
    host, so the noising can sit inside a captured CUDA graph."""
    if isinstance(t, torch.Tensor):
        t = t.to(device=x_start.device, dtype=torch.float32)
    else:
        t = torch.full((), t, dtype=torch.float32, device=x_start.device)
    ab = cosine_alpha_bar(t / n_diffusion_timesteps).to(x_start.dtype)
    return torch.sqrt(ab) * x_start + torch.sqrt(1.0 - ab) * noise


def _noise(rng, like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of `like`'s shape, device and dtype from `rng`:
    a generator, or the noise itself."""
    if isinstance(rng, torch.Tensor):
        if rng.shape != like.shape:
            raise ValueError(f"noise must have the latents' shape "
                             f"{tuple(like.shape)}, got {tuple(rng.shape)}")
        return rng.to(device=like.device, dtype=like.dtype)
    if not isinstance(rng, torch.Generator):
        raise TypeError(f"rng must be a torch.Generator or a noise tensor, "
                        f"got {type(rng).__name__}")
    noise = torch.randn(like.shape, generator=rng, device=rng.device,
                        dtype=torch.float32)
    return noise.to(device=like.device, dtype=like.dtype)


class DepthFM(nn.Module):
    """The parameters of DepthFM / DepthFMAmodal: `unet`, `vae` and the
    empty-text embedding [1, context_len, context_dim], with `forward` as
    the model registry's entry (the JAX package's `Model.apply`)."""

    def __init__(self, cfg: DepthFMConfig):
        super().__init__()
        self.cfg = cfg
        self.unet = UNetModel(cfg.unet)
        self.vae = AutoencoderKL(cfg.vae)
        self.empty_text_embed = nn.Parameter(
            torch.zeros(1, cfg.context_len, cfg.context_dim))

    def forward(self, x: torch.Tensor, rng=None, mode: str = "eval",
                depth=None, guide_rgb=None, guide_mask=None,
                observation=None, num_steps: int = 4,
                attn_impl: str | None = None, deep_cache=None, t=None,
                remat: bool = False, tome=None):
        """mode "eval": `depthfm_generate` (`tome`: ToMe-SD, as there) ->
        depth [B,H,W,1]; mode "train":
        `depthfm_train_outputs` (needs `depth`; `t` and `remat` are its)
        -> (model_pred, target) latents."""
        if mode == "train":
            if depth is None:
                raise ValueError("mode='train' needs the target depth")
            return depthfm_train_outputs(
                self, rng, x, depth, t=t, guide_rgb=guide_rgb,
                guide_mask=guide_mask, observation=observation,
                attn_impl=attn_impl, remat=remat)
        if mode != "eval":
            raise ValueError(f"unknown mode: {mode!r}")
        return depthfm_generate(
            self, rng, x, num_steps=num_steps, guide_rgb=guide_rgb,
            guide_mask=guide_mask, observation=observation,
            attn_impl=attn_impl, tome=tome, deep_cache=deep_cache)


def build_depthfm(cfg: DepthFMConfig, *, device="cuda",
                  dtype: torch.dtype = torch.float32) -> DepthFM:
    """The module `cfg` describes, parameters allocated on `device` and left
    uninitialised (load a state dict or call `init_depthfm_`)."""
    with torch.device("meta"):
        model = DepthFM(cfg)
    return model.to_empty(device=device).to(dtype)


@torch.no_grad()
def init_depthfm_(model: DepthFM, generator: torch.Generator) -> DepthFM:
    """Seeded random weights for smoke runs and tests: every convolution and
    linear uniform(+-1/sqrt(fan_in)) as in the JAX package's `init_*`, norms
    at one and zero, the empty-text embedding normal(0.02). The one departure
    from the JAX scheme: the layers it starts at zero for training (each
    ResBlock's second conv, the transformers' proj_out, the output conv, the
    guidance channels of conv-in) are drawn too, or nothing but the VAE
    would reach the output. Draws from `generator`, which must live on the
    parameters' device."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
            if mod.bias is not None:
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, (nn.LayerNorm, GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    nn.init.normal_(model.empty_text_embed, std=0.02, generator=generator)
    return model


def _guide_latents(model: DepthFM, rgb_latent, guide_rgb, guide_mask,
                   observation):
    """Conditioning latents concatenated after the image latent
    (reference dfm_amodal.py:185-219)."""
    guide_type = model.cfg.guide_type
    size = tuple(rgb_latent.shape[1:3])
    parts = []
    if "image" in guide_type:
        if guide_rgb is None:
            raise ValueError("guide_type includes image: guide_rgb required")
        parts.append(model.vae.encode_mode(guide_rgb))
    if "mask" in guide_type:
        if guide_mask is None:
            raise ValueError("guide_type includes mask: guide_mask required")
        parts.append(resize2d(guide_mask, size=size, method="bilinear"))
    if "observation" in guide_type:
        if observation is None:
            raise ValueError(
                "guide_type includes observation: observation required")
        parts.append(resize2d(observation, size=size, method="bilinear"))
    if not parts:
        return rgb_latent
    return torch.cat([rgb_latent] + parts, dim=-1)


def _conditioning(model: DepthFM, batch_size: int, dtype) -> torch.Tensor:
    e = model.empty_text_embed.to(dtype)
    return e.expand(batch_size, *e.shape[1:])


def depthfm_train_outputs(model: DepthFM, rng, ims: torch.Tensor,
                          depth: torch.Tensor, *, t=None, guide_rgb=None,
                          guide_mask=None, observation=None,
                          attn_impl: str | None = None,
                          remat: bool = False):
    """ims: [B,H,W,3] in [-1,1]; depth: [B,H,W,1] in [0,1].

    Returns (model_pred, target) latents [B,h,w,4]. `rng`: a generator, or
    the q_sample noise of the latents' shape; `t`: the integer flow steps
    [B] in [0, noising_step), or None to draw them from `rng` (a generator;
    noise first, then t). The VAE, the guide latents and the empty-text
    embedding run without gradient: training moves the UNet only."""
    cfg = model.cfg
    with torch.no_grad():
        rgb_latent = model.vae.encode_mode(ims)
        cond_latent = _guide_latents(model, rgb_latent, guide_rgb,
                                     guide_mask, observation)
        conditioning = _conditioning(model, ims.shape[0], ims.dtype)
        depth_in = (1.0 - depth) * 2.0 - 1.0
        x_1 = model.vae.encode_mode(depth_in.expand(*depth_in.shape[:3], 3))
    noise = _noise(rng, rgb_latent)
    x_0 = q_sample(rgb_latent, cfg.noising_step, noise,
                   cfg.n_diffusion_timesteps)
    if t is None:
        if not isinstance(rng, torch.Generator):
            raise ValueError("pass t with a noise tensor, or a generator to "
                             "draw both")
        t = torch.randint(0, cfg.noising_step, (ims.shape[0],),
                          generator=rng, device=rng.device)
    # the flow time in the compute dtype, as the JAX package rounds it
    t = t.to(device=ims.device, dtype=ims.dtype).view(-1, 1, 1, 1) \
        / cfg.noising_step
    x_t = (1.0 - t) * x_0 + t * x_1
    model_pred = model.unet(x_t, t[:, 0, 0, 0], context=cond_latent,
                            context_ca=conditioning, attn_impl=attn_impl,
                            remat=remat)
    return model_pred, x_1 - x_0


def _euler_depth(model: DepthFM, rng, rgb_latent, cond_latent, conditioning,
                 num_steps: int, dtype, attn_impl, tome=None,
                 deep_cache=None) -> torch.Tensor:
    """q_sample -> fixed-step Euler ODE -> decode -> channel-mean depth
    (shared by the amodal eval and the plain predict paths).

    deep_cache=(interval N, shallow groups G): every N-th Euler step runs
    the full UNet and keeps the deep feature; the N-1 steps in between run
    only the G shallowest input/output groups around it (see
    `UNetModel.forward`). N = 1 is identical to the plain path. Opt-in:
    for N > 1 it is an approximation. `tome=(ratio, min_tokens)`: ToMe-SD
    in every UNet call (opt-in, an approximation)."""
    cfg = model.cfg
    z = q_sample(rgb_latent, cfg.noising_step, _noise(rng, rgb_latent),
                 cfg.n_diffusion_timesteps)
    dt = 1.0 / num_steps
    ts = torch.arange(num_steps, dtype=dtype, device=z.device) * dt
    b = rgb_latent.shape[0]

    def vfield(z, t, **kw):
        return model.unet(z, t.expand(b), context=cond_latent,
                          context_ca=conditioning, attn_impl=attn_impl,
                          tome=tome, **kw)

    if deep_cache is None:
        for t in ts:
            z = z + dt * vfield(z, t)
    else:
        interval, groups = deep_cache
        if num_steps % interval != 0:
            raise ValueError(f"deep_cache interval {interval} must divide "
                             f"num_steps {num_steps}")
        deep = None
        for i, t in enumerate(ts):
            if i % interval == 0:
                v, deep = vfield(z, t, deep_cache_groups=groups)
            else:
                v = vfield(z, t, deep_cache_groups=groups, cached_deep=deep)
            z = z + dt * v
    return model.vae.decode(z).mean(dim=-1, keepdim=True)


def depthfm_generate(model: DepthFM, rng, ims: torch.Tensor, *,
                     num_steps: int = 4, guide_rgb=None, guide_mask=None,
                     observation=None, attn_impl: str | None = None,
                     tome=None, deep_cache=None) -> torch.Tensor:
    """Euler ODE from the noised image latent to the depth latent. ims:
    [B,H,W,3] in [-1,1]; returns depth [B,H,W,1] in [0,1] (far = 0 after
    the 1-x flip, dfm_amodal.py:261-262)."""
    rgb_latent = model.vae.encode_mode(ims)
    cond_latent = _guide_latents(model, rgb_latent, guide_rgb, guide_mask,
                                 observation)
    conditioning = _conditioning(model, ims.shape[0], ims.dtype)
    depth = _euler_depth(model, rng, rgb_latent, cond_latent, conditioning,
                         num_steps, ims.dtype, attn_impl, tome=tome,
                         deep_cache=deep_cache)
    return 1.0 - torch.clamp((depth + 1.0) / 2.0, 0.0, 1.0)


def depthfm_predict_depth(model: DepthFM, rng, ims: torch.Tensor, *,
                          num_steps: int = 4, ensemble_size: int = 1,
                          attn_impl: str | None = None, tome=None,
                          deep_cache=None) -> torch.Tensor:
    """Plain (unguided) DepthFM inference (reference `dfm.py:59-94`, the
    pseudo-label factory's labeler): `ensemble_size` copies of the image
    latent, each with its own q_sample noise, Euler solve, decode, channel
    mean, ensemble mean, then per-sample min-max of exp(depth). ims:
    [1,H,W,3] in [-1,1] when ensembling (the reference asserts batch 1),
    else [B,H,W,3]; the noise has the repeated latents' shape.

    Returns [B,H,W,1] in [0,1], float32, with no 1-x flip (that is the
    amodal eval convention)."""
    if model.cfg.guide_type != "none":
        raise ValueError("plain predict_depth is the unguided path (dfm.py); "
                         "use depthfm_generate for guided configs")
    rgb_latent = model.vae.encode_mode(ims)
    if ensemble_size > 1:
        if ims.shape[0] != 1:
            raise ValueError("ensemble mode needs batch 1 (dfm.py:67)")
        # encode once: the posterior mean is deterministic, so repeating
        # the latent equals the reference's repeat-then-encode
        rgb_latent = rgb_latent.repeat_interleave(ensemble_size, dim=0)
    conditioning = _conditioning(model, rgb_latent.shape[0], ims.dtype)
    depth = _euler_depth(model, rng, rgb_latent, rgb_latent, conditioning,
                         num_steps, ims.dtype, attn_impl, tome=tome,
                         deep_cache=deep_cache)
    if ensemble_size > 1:
        depth = depth.mean(dim=0, keepdim=True)
    depth = torch.exp(depth.float())
    lo = depth.amin(dim=(1, 2, 3), keepdim=True)
    hi = depth.amax(dim=(1, 2, 3), keepdim=True)
    return (depth - lo) / torch.clamp(hi - lo, min=1e-8)
