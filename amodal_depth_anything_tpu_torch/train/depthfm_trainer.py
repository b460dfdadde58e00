"""Generative-branch trainers: flow matching (amodal) and the DDPM finetune.

Port of the JAX package's `train/depthfm_trainer.py`, its re-design of the
reference `DepthFMAmodalTrainer` / `DepthFMTrainer`
(`src/trainer/depthfm_amodal_trainer.py:35-749`, `depthfm_trainer.py`):
the loss lives in LATENT space -- `loss(model_pred, target, mask)` where the
valid mask comes down to latent resolution by max-pooling the *invalid* mask
8x8 (any invalid pixel invalidates its latent cell, reference :181-186) and
the strategy masks are nearest-downsampled. The VAE and the empty-text
embedding stay frozen: gradients flow through the UNet only (the reference
freezes the VAE and optimizes the UNet), so only the UNet's parameters are
in the optimizer (`trainable = "unet"`); the frozen ones keep
requires_grad=False and stay bit-identical.

`DepthFMTrainer` is a different training path (reference
`src/trainer/depthfm_trainer.py:93-310`): a Marigold-style DDPM finetune,
the pseudo-label factory -- DDPM noise schedule with per-sample integer
timesteps, optional multi-resolution noise with timestep annealing,
VAE-encoded 3-channel-stacked depth, and sample / epsilon / v-prediction
targets.

Randomness: each train step draws its timesteps and noise from a
`torch.Generator` on the trainer's device seeded from (init_seed, step), and
evaluation from `val_init_seed`, so a resumed run repeats an unbroken one
bit for bit. Every draw goes through `_draws`, which a test can override to
hand over another generator's numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.depthfm import _conditioning, init_depthfm_
from ..ops.ddim import (ddim_sample, ddpm_add_noise, ddpm_velocity,
                        linear_alphas_cumprod)
from ..ops.resize import resize_nearest
from ..parallel.sharding import shard_batch
from ..utils.alignment import fit_scale_shift
from ..utils.multi_res_noise import (multi_res_noise_like,
                                     multi_res_noise_shapes)
from .trainer import DiscriminativeTrainer, TrainerConfig

__all__ = ["DepthFMAmodalTrainer", "DepthFMTrainer"]

PREDICTION_TYPES = ("sample", "epsilon", "v_prediction")
DEPTHFM_LOSS_STRATEGIES = ("invisible_part", "entire_target_object",
                           "entire_scene")
EVAL_STEPS = 4   # the JAX trainers' evaluation solve


def _unet_remat(cfg: TrainerConfig) -> bool:
    """UNet recompute only when remat is the boolean True: the default
    "attn" is a policy of the ViT blocks (keep the attention output and
    LSE) and must not turn on per-level recompute of the UNet."""
    return cfg.remat is True


def _latent_masks(batch, cfg: TrainerConfig, latent_hw, vae_factor: int):
    """(valid, guide, invisible) at the latents' resolution, [B,h,w,1]
    bool: a latent cell is valid when no pixel under it is invalid."""
    invalid = (~(batch[cfg.gt_mask_type] > 0)).float()
    pooled = F.max_pool2d(invalid.permute(0, 3, 1, 2), vae_factor)
    valid_down = pooled.permute(0, 2, 3, 1) <= 0
    guide = resize_nearest(batch["guide"], size=latent_hw) > 0
    invisible = resize_nearest(batch["invisible_mask"], size=latent_hw) > 0
    return valid_down, guide, invisible


class DepthFMAmodalTrainer(DiscriminativeTrainer):
    """Trainer for DepthFMAmodal (and plain DepthFM with guide_type none).

    The loss strategies are `invisible_part`, `entire_target_object` and
    `entire_scene`, in latent space. The model is fed `rgb_norm` in
    [-1, 1] and `guide` and `depth_observation` as the dataset gives them
    (the discriminative trainer feeds `rgb_int / 255` and rescales those
    two to [-1, 1])."""

    trainable = "unet"

    def __init__(self, cfg: TrainerConfig, model, *args, **kwargs):
        if cfg.loss_strategy not in DEPTHFM_LOSS_STRATEGIES:
            raise ValueError(
                f"unsupported depthfm loss strategy: {cfg.loss_strategy}")
        super().__init__(cfg, model, *args, **kwargs)
        self.vae_factor = 2 ** (len(self.model.cfg.vae_channels) - 1)

    def _init_weights(self, generator: torch.Generator) -> None:
        init_depthfm_(self.model, generator)

    def _draws(self, specs: dict, *, step: int | None = None) -> dict:
        """Named random draws: `specs` maps a name to ("normal", shape) or
        ("randint", shape, high), a shape being a tuple (one tensor) or a
        list of tuples (a list of tensors), drawn in order. Train steps
        (`step` given) draw from a generator on the trainer's device seeded
        from (init_seed, step), evaluation from one seeded with
        val_init_seed. Float draws are float32. Shapes are this rank's
        rows: under a mesh the global batch is drawn and the rank keeps its
        rows, as one process holding the whole batch would draw them."""
        if step is None:
            seed = self.cfg.val_init_seed
        else:
            seed = int(np.random.SeedSequence([self.cfg.init_seed or 0, step])
                       .generate_state(1, np.uint64)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def draw(kind, shape, *high):
            # the global batch's draw, of which this rank keeps its rows
            shape = (shape[0] * self._n_data,) + tuple(shape[1:])
            if kind == "normal":
                out = torch.randn(shape, generator=gen, device=self.device)
            else:
                out = torch.randint(0, *high, shape, generator=gen,
                                    device=self.device)
            return shard_batch(self.mesh, out)

        return {name: ([draw(kind, s, *rest) for s in shape]
                       if isinstance(shape, list)
                       else draw(kind, shape, *rest))
                for name, (kind, shape, *rest) in specs.items()}

    def _latent_shape(self, batch) -> tuple[int, ...]:
        b, h, w = batch["rgb_norm"].shape[:3]
        return (b, h // self.vae_factor, w // self.vae_factor,
                self.model.vae.cfg.latent_channels)

    def _inputs(self, batch) -> dict:
        dtype = self.dtype
        return {"guide_rgb": batch["guide_rgb_norm"].to(dtype),
                "guide_mask": batch["guide"].to(dtype),
                "observation": batch["depth_observation"].to(dtype),
                "attn_impl": self.cfg.attn_impl}

    def _step_draws(self, batch: dict) -> dict:
        """The flow step's noise and timesteps, drawn for `state.step`."""
        shape = self._latent_shape(batch)
        return self._draws({"noise": ("normal", shape),
                            "t": ("randint", shape[:1],
                                  self.model.cfg.noising_step)},
                           step=self.state.step)

    def loss_of(self, batch: dict, draws: dict | None = None) -> torch.Tensor:
        cfg = self.cfg
        if draws is None:
            draws = self._step_draws(batch)
        pred, target = self.model(
            batch["rgb_norm"].to(self.dtype), draws["noise"], mode="train",
            depth=batch[cfg.gt_depth_type].to(self.dtype), t=draws["t"],
            remat=_unet_remat(cfg), **self._inputs(batch))
        pred, target = pred.float(), target.float()
        valid_down, guide, invisible = _latent_masks(
            batch, cfg, tuple(pred.shape[1:3]), self.vae_factor)
        if cfg.loss_strategy == "invisible_part":
            mask = valid_down & invisible
        elif cfg.loss_strategy == "entire_target_object":
            mask = valid_down & guide
        else:
            mask = valid_down
        loss = self.loss_fn(pred, target, mask.expand_as(pred))
        # NaN guard (reference zero-loss fallback)
        return torch.where(torch.isfinite(loss), loss, 0.0)

    def _align(self, pred, batch):
        """(pred at the ground truth's size, pred aligned by least squares
        to the observation over the visible mask). A batch without an
        observation (a plain depth dataset, the DDPM factory's protocol,
        reference depthfm_trainer.py:544-560) aligns to the ground truth
        over the valid mask instead."""
        gt = batch[self.cfg.gt_depth_type]
        if pred.shape[1:3] != gt.shape[1:3]:
            pred = resize_nearest(pred, size=tuple(gt.shape[1:3]))
        if "depth_observation" in batch:
            ref, mask = batch["depth_observation"], batch["visible_mask"]
        else:
            ref, mask = gt.float(), batch[self.cfg.gt_mask_type] > 0
        scale, shift = fit_scale_shift(pred[..., 0], ref[..., 0],
                                       mask[..., 0])
        return pred, pred * scale[:, None, None, None] + \
            shift[:, None, None, None]

    @torch.no_grad()
    def _eval_forward(self, batch: dict):
        noise = self._draws({"noise": ("normal",
                                       self._latent_shape(batch))})["noise"]
        pred = self.model(batch["rgb_norm"].to(self.dtype), noise,
                          mode="eval", num_steps=EVAL_STEPS,
                          **self._inputs(batch)).float()
        return self._align(pred, batch)


class DepthFMTrainer(DepthFMAmodalTrainer):
    """Marigold-style DDPM finetune, the pseudo-label factory path.

    The reference's `DepthFMTrainer` (`src/trainer/depthfm_trainer.py`)
    finetunes a depth diffusion UNet with a diffusers `DDPMScheduler`
    (scaled-linear betas, :93-105), per-sample integer timesteps
    (:240-247), optional multi-resolution noise with timestep annealing
    (:249-261), stacked 3-channel depth encoded by the frozen VAE
    (:389-403), and sample / epsilon / v-prediction targets (:291-301)
    under the 8x8 max-pooled latent valid mask (:216-227). Here that runs
    on a DepthFM model with guide_type "none" (conv-in 8 = image latent 4
    + noisy depth latent 4). Evaluation samples with DDIM (the prediction
    converted to epsilon), decodes, and min-max normalizes each sample."""

    def __init__(self, cfg: TrainerConfig, model, *args,
                 prediction_type: str = "v_prediction",
                 num_train_timesteps: int = 1000,
                 beta_start: float = 0.00085, beta_end: float = 0.012,
                 multi_res_noise: dict | None = None, **kwargs):
        if prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"unknown prediction type {prediction_type!r}")
        self.prediction_type = prediction_type
        self.num_train_timesteps = int(num_train_timesteps)
        self.beta_start = float(beta_start)
        self.beta_end = float(beta_end)
        self.multi_res_noise = dict(multi_res_noise) if multi_res_noise \
            else None
        super().__init__(cfg, model, *args, **kwargs)
        self.alphas = linear_alphas_cumprod(
            self.num_train_timesteps, self.beta_start, self.beta_end,
            device=self.device)

    def _encode(self, batch):
        """(image latent, empty-text conditioning) from the frozen VAE."""
        rgb = batch["rgb_norm"].to(self.dtype)
        with torch.no_grad():
            return (self.model.vae.encode_mode(rgb),
                    _conditioning(self.model, rgb.shape[0], self.dtype))

    def _step_draws(self, batch: dict) -> dict:
        """The DDPM step's timesteps and (pyramid) noise, drawn for
        `state.step` at the depth latents' shape."""
        mrn = self.multi_res_noise
        shape = self._latent_shape(batch)
        noise_shape = shape if mrn is None else multi_res_noise_shapes(
            shape, mrn.get("downscale_strategy", "original"))
        return self._draws({"t": ("randint", shape[:1],
                                  self.num_train_timesteps),
                            "noise": ("normal", noise_shape)},
                           step=self.state.step)

    def loss_of(self, batch: dict, draws: dict | None = None) -> torch.Tensor:
        cfg, model, mrn = self.cfg, self.model, self.multi_res_noise
        T = self.num_train_timesteps
        if draws is None:
            draws = self._step_draws(batch)
        rgb_latent, cond = self._encode(batch)
        with torch.no_grad():
            depth3 = batch[cfg.gt_depth_type].to(self.dtype)
            gt_latent = model.vae.encode_mode(
                depth3.expand(*depth3.shape[:3], 3))
        t = draws["t"]
        if mrn is None:
            noise = draws["noise"].to(gt_latent.dtype)
        else:
            ann = None
            if mrn.get("annealed", True):
                # strength annealed by t/T (reference :252-255)
                ann = (t.float() / T).view(-1, 1, 1, 1).to(gt_latent.dtype)
            noise = multi_res_noise_like(
                draws["noise"], gt_latent,
                strength=float(mrn.get("strength", 0.9)),
                downscale_strategy=mrn.get("downscale_strategy", "original"),
                annealed_t=ann)
        noisy = ddpm_add_noise(self.alphas, gt_latent, noise, t)
        pred = model.unet(noisy, t.to(self.dtype), context=rgb_latent,
                          context_ca=cond, attn_impl=cfg.attn_impl,
                          remat=_unet_remat(cfg))
        if self.prediction_type == "sample":
            target = gt_latent
        elif self.prediction_type == "epsilon":
            target = noise
        else:
            target = ddpm_velocity(self.alphas, gt_latent, noise, t)
        valid_down, _, _ = _latent_masks(batch, cfg, tuple(pred.shape[1:3]),
                                         self.vae_factor)
        loss = self.loss_fn(pred.float(), target.float(),
                            valid_down.expand_as(pred))
        return torch.where(torch.isfinite(loss), loss, 0.0)

    @torch.no_grad()
    def _eval_forward(self, batch: dict):
        cfg, model, alphas = self.cfg, self.model, self.alphas
        rgb_latent, cond = self._encode(batch)

        def eps_fn(x, tb):
            v = model.unet(x, tb.to(self.dtype), context=rgb_latent,
                           context_ca=cond, attn_impl=cfg.attn_impl)
            if self.prediction_type == "epsilon":
                return v
            ab = alphas[tb].to(x.dtype)[:, None, None, None]
            if self.prediction_type == "v_prediction":
                # eps = sqrt(ab) v + sqrt(1 - ab) x_t
                return torch.sqrt(ab) * v + torch.sqrt(1.0 - ab) * x
            # sample: eps = (x_t - sqrt(ab) x0) / sqrt(1 - ab)
            return (x - torch.sqrt(ab) * v) / torch.sqrt(1.0 - ab)

        noise = self._draws({"noise": ("normal",
                                       tuple(rgb_latent.shape))})["noise"]
        z = ddim_sample(eps_fn, noise, tuple(rgb_latent.shape),
                        num_steps=EVAL_STEPS,
                        n_train_timesteps=self.num_train_timesteps,
                        dtype=rgb_latent.dtype, beta_start=self.beta_start,
                        beta_end=self.beta_end)
        depth = model.vae.decode(z).mean(dim=-1, keepdim=True).float()
        # per-sample min-max to [0, 1] (pseudo-label convention, reference
        # dfm.py:59-94)
        lo = depth.amin(dim=(1, 2), keepdim=True)
        hi = depth.amax(dim=(1, 2), keepdim=True)
        return self._align((depth - lo) / torch.clamp(hi - lo, min=1e-8),
                           batch)
