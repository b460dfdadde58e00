"""Serving pipeline of the generative (DepthFM) family on the card.

Port of the JAX package's `pipeline/depthfm_pipeline.py`, the counterpart of
`AmodalDepthPipeline` for DepthFMAmodal / plain DepthFM (reference
`src/models/depthfm/dfm_amodal.py:246-265` eval path and the preprocessing
contract of `src/scripts/amodel_depthfm_inference.py`): load the weights
once, then per call preprocess -> VAE encode -> guidance latents -> Euler
ODE through the UNet -> VAE decode. Input conventions match the reference
trainers (`depthfm_amodal_trainer.py:197-199`): rgb / guide_rgb scaled to
[-1, 1], guide mask 0/1, observation in [0, 1]. Host arrays in and out.

The q_sample noise is drawn per call from a CPU generator seeded with
`seed` and moved to the device, so one seed gives one result on the card
and on the CPU, call after call (the JAX class folds the same key into
every call); `noise=` hands in a ready array or device tensor instead.
`seeded_noise` draws that same noise once, as a device tensor, so that a
captured CUDA graph (`pipeline.aot`) holds no host generator and no copy
from pageable host memory, and replays what the eager call computes.

`save_serving` / `load_serving` write and read the JAX package's
serving-state format (`pipeline.serving_ckpt`, kind "depthfm"), compressed
or not.

Serving compression, opt-in and parity-breaking as in the JAX package:
`quantize_int8` (W8A8 with dynamic or calibrated scales, or weight-only w8 /
w4, over the UNet and the VAE; `ops.quant`) and `tome` (ToMe-SD in the
UNet's transformers; `ops.token_merge`).

Scale-out (`mesh=`, JAX `DepthFMPipeline(mesh=)`): data-parallel serving.
Every rank draws the whole batch's noise, runs its rows of the batch (which
the data size must divide) and the depth maps are all-gathered, so each
rank returns what one process would.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.depthfm import (DepthFM, DepthFMConfig, _noise,
                              build_depthfm, depthfm_generate,
                              depthfm_predict_depth, init_depthfm_)
from ..ops.ddim import parse_deep_cache
from ..ops.precision import apply_precision_policy
from ..ops.resize import resize2d, resize_nearest
from ..parallel import comm
from ..parallel.mesh import axis_group
from ..parallel.multihost import local_device
from ..parallel.sharding import shard_batch

__all__ = ["DepthFMPipeline"]


class DepthFMPipeline:
    """Load the weights once, infer many images.

    `model` comes from `models.get_model("DepthFMAmodal")` (or "DepthFM"),
    `init_random` or `from_checkpoints`. `size` must be divisible by the
    VAE's factor (8 at the SD widths). Runs on `device` ("cuda" unless the
    caller asks for "cpu") in `dtype`; a float32 pipeline turns TF32 off
    (`ops.precision`). `deep_cache`: (interval N, shallow groups G), an int
    or "N" (G = 3: the whole highest-resolution level of the SD topology)
    or "N,G"; N must divide `num_steps`; opt-in, an approximation.
    `tome`: ToMe-SD, a ratio (then `(ratio, 4096)`) or `(ratio,
    min_tokens)`; opt-in, an approximation. `mesh`
    (`parallel.make_mesh`): data-parallel serving over its ``data`` ranks,
    the parameters replicated; in a process group "cuda" is this rank's
    card."""

    def __init__(self, model: DepthFM, *, size: int = 512, num_steps: int = 4,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str | None = None, seed: int = 2024,
                 deep_cache=None, device="cuda", tome=None, mesh=None):
        self.device = local_device(device)
        self.mesh = mesh
        self.dtype = dtype
        apply_precision_policy(dtype)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.cfg = model.cfg
        self.size = size
        self.num_steps = num_steps
        self.attn_impl = attn_impl
        self.seed = seed
        self.deep_cache = parse_deep_cache(deep_cache)
        # a ratio or (ratio, min_tokens): ToMe-SD in the UNet transformers
        self.tome = (float(tome), 4096) if isinstance(tome, (int, float)) \
            else (None if tome is None else (float(tome[0]), int(tome[1])))

    @classmethod
    def init_random(cls, seed: int = 0, *, size: int = 32, num_steps: int = 2,
                    tiny: bool = True, guide_type: str = "mask+observation",
                    cfg_overrides: dict | None = None, device="cuda", **kw):
        """Seeded random-weight pipeline, the no-checkpoint smoke
        constructor: the tiny preset by default, the full SD-1.5 widths
        with `tiny=False`. Outputs are meaningless; every seam is real.
        The weights are drawn on `device` in float32 from a
        `torch.Generator` seeded with `seed` (`init_depthfm_`)."""
        from ..models import get_model
        model = get_model("DepthFMAmodal", guide_type=guide_type, tiny=tiny,
                          cfg_overrides=cfg_overrides, device=device)
        init_depthfm_(model, torch.Generator(device=device).manual_seed(seed))
        return cls(model, size=size, num_steps=num_steps, device=device, **kw)

    @classmethod
    def from_checkpoints(cls, depthfm_ckpt: str, vae_ckpt: str, *,
                         guide_type: str = "mask+observation",
                         cfg_overrides: dict | None = None, device="cuda",
                         **kw):
        """depthfm_ckpt: the reference's `depthfm-v1.ckpt` (torch: UNet,
        empty-text embedding, hparams, `dfm_amodal.py:91-142`); vae_ckpt:
        diffusers SD-1.5 AutoencoderKL weights (.safetensors or .bin; the
        VAE ships apart, reference `dfm.py:20-22`). The VAE's topology is
        read off its state dict; `cfg_overrides` patches DepthFMConfig
        fields the artifacts do not carry."""
        from ..convert.weights import load_depthfm_checkpoints
        model = load_depthfm_checkpoints(
            depthfm_ckpt, vae_ckpt, guide_type=guide_type,
            cfg_overrides=cfg_overrides, device=device)
        return cls(model, device=device, **kw)

    def save_serving(self, path: str) -> None:
        """Persist the READY-TO-SERVE state: the weights in their serving
        dtype and what builds the pipeline, in the JAX package's format
        (kind "depthfm"), which its `DepthFMPipeline.load_serving` restores
        too (see pipeline/serving_ckpt.py)."""
        import dataclasses

        from ..convert.weights import depthfm_params_to_jax
        from .serving_ckpt import (attn_impl_to_jax, dtype_name,
                                   save_serving_state)
        save_serving_state(path, {"params": depthfm_params_to_jax(
            self.model.state_dict(), self.cfg, tensors=True)}, {
            "kind": "depthfm",
            "cfg": dataclasses.asdict(self.cfg),
            "size": self.size,
            "num_steps": self.num_steps,
            "attn_impl": attn_impl_to_jax(self.attn_impl),
            "seed": self.seed,
            "tome": list(self.tome) if self.tome else None,
            "deep_cache": list(self.deep_cache) if self.deep_cache else None,
            "dtype": dtype_name(self.dtype),
        })

    @classmethod
    def load_serving(cls, path: str, *, attn_impl: str | None = None,
                     device="cuda", mesh=None):
        """Restore a pipeline saved by `save_serving` of either package on
        `device`, the weights in their saved dtype (no cast). `attn_impl`
        overrides the saved one. Quantised layers keep their saved dtypes
        (no re-quantisation); ToMe comes back as it was saved. `mesh`:
        data-parallel serving, as in the constructor."""
        from ..convert.weights import depthfm_params_from_jax
        from ..ops.quant import apply_quantized_
        from .serving_ckpt import (attn_impl_from_jax, cfg_from_dict,
                                   restore_serving_state, serving_dtype)
        trees, meta = restore_serving_state(path, expect_kind="depthfm",
                                            device=device)
        dtype = serving_dtype(meta, trees)
        cfg = cfg_from_dict(DepthFMConfig, meta["cfg"])
        model = build_depthfm(cfg, device=device, dtype=dtype)
        sd = depthfm_params_from_jax(trees["params"], cfg)
        apply_quantized_(model, sd)
        model.load_state_dict(sd, strict=True, assign=True)
        deep_cache = meta.get("deep_cache")
        tome = meta.get("tome")
        return cls(model, size=int(meta["size"]),
                   num_steps=int(meta["num_steps"]), dtype=dtype,
                   attn_impl=attn_impl or attn_impl_from_jax(
                       meta["attn_impl"]),
                   seed=int(meta["seed"]),
                   deep_cache=tuple(deep_cache) if deep_cache else None,
                   tome=tuple(tome) if tome else None, device=device,
                   mesh=mesh)

    @torch.no_grad()
    def quantize_int8(self, calibration=None, margin: float = 1.1, *,
                      noise=None, **kw) -> None:
        """Opt-in compression of the UNet + VAE, in place (JAX
        `DepthFMPipeline.quantize_int8`; `ops.quant`): the wide convs and
        linears the JAX rule picks (`kw`: `min_conv_fan`, `min_lin_dim`,
        `skip_suffixes`, `weight_only`, `bits`) as W8A8 with dynamic
        scales, or with `weight_only=True` as w8 (`bits=8`) or w4
        (`bits=4`).

        `calibration=(image, mask, observation[, guide_rgb])` (as
        `__call__` takes them) promotes every W8A8 site to a static scale:
        one run of the whole program (VAE encode, the Euler steps, VAE
        decode; without ToMe and DeepCache, as the JAX calibration runs)
        records each site's largest dynamic scale and bakes in that x
        `margin`. `noise`: the q_sample noise of that run, as in
        `__call__`."""
        from ..convert.weights import depthfm_layer_paths
        from ..ops import quant as Q

        Q.quantize_diffusion_modules(self.model,
                                     depthfm_layer_paths(self.cfg), **kw)
        if calibration is None:
            return
        image, mask, observation, *rest = tuple(calibration) + (None,)
        guide_rgb = rest[0] if rest else None
        g = self.cfg.guide_type
        img, _ = self._batch(image, 3)
        msk, _ = self._batch(mask if "mask" in g else None, 1)
        obs, _ = self._batch(observation if "observation" in g else None, 1)
        grgb, _ = self._batch(guide_rgb if "image" in g else None, 3)
        rgb, m, o, gr = self._prep(img, msk, obs, grgb)
        Q.calibrate_dynamic_scales(self.model, lambda: depthfm_generate(
            self.model, self._rng(noise), rgb, num_steps=self.num_steps,
            guide_rgb=gr, guide_mask=m, observation=o,
            attn_impl=self.attn_impl), margin)

    def _prep(self, image, mask, observation, guide_rgb):
        s = (self.size, self.size)

        def rgb(x):
            return resize2d(x / 255.0, size=s, method="bilinear") * 2.0 - 1.0

        m = None if mask is None else \
            (resize_nearest(mask, size=s) > 0).to(image.dtype)
        obs = None if observation is None else \
            resize2d(observation, size=s, method="bilinear")
        return (rgb(image), m, obs,
                None if guide_rgb is None else rgb(guide_rgb))

    def _batch(self, x, channels: int):
        """-> ([B,H,W,c] device tensor or None, was it unbatched)."""
        if x is None:
            return None, False
        arr = np.asarray(x, np.float32)
        if channels == 3:   # [H,W,3] or [B,H,W,3]
            squeeze = arr.ndim == 3
            if squeeze:
                arr = arr[None]
        else:               # [H,W] or [B,H,W] -> [B,H,W,1]
            squeeze = arr.ndim == 2
            arr = arr[None, :, :, None] if squeeze else arr[..., None]
        return torch.from_numpy(arr).to(device=self.device,
                                        dtype=self.dtype), squeeze

    def _rng(self, noise):
        if isinstance(noise, torch.Tensor):
            return noise
        if noise is not None:
            return torch.from_numpy(np.array(noise, np.float32))
        return torch.Generator(device="cpu").manual_seed(self.seed)

    def latent_size(self) -> int:
        """The side of the latents at `size`: each VAE downsampler pads
        (0, 1) and takes a 3x3 conv at stride 2."""
        n = self.size
        for _ in range(len(self.cfg.vae_channels) - 1):
            n = (n - 2) // 2 + 1
        return n

    def seeded_noise(self, batch: int) -> torch.Tensor:
        """The q_sample noise a call of `batch` images draws from `seed`,
        [B, s, s, 4] on the device in the compute dtype (s =
        `latent_size()`). Passed as `noise=`, it gives the seeded call's
        output."""
        s = self.latent_size()
        like = torch.empty((batch, s, s, self.cfg.vae.latent_channels),
                           device=self.device, dtype=self.dtype)
        return _noise(self._rng(None), like)

    def _generate(self, img, msk, obs, grgb, rng) -> torch.Tensor:
        """The device program: preprocess, VAE encode, Euler solve, decode.
        Batched [B,H,W,c] device tensors in (None for a guide the config
        does not take); depth [B,S,S] float32 on the device out. `rng`: a
        generator or the noise tensor. Under a mesh this rank runs its rows
        of the batch and of its noise, and the maps are gathered over the
        data ranks."""
        rgb, m, o, gr = self._prep(img, msk, obs, grgb)
        group = axis_group(self.mesh, "data")
        if group is not None:
            s = self.latent_size()
            like = rgb.new_empty((rgb.shape[0], s, s,
                                  self.cfg.vae.latent_channels))
            rng, rgb, m, o, gr = (
                None if t is None else shard_batch(self.mesh, t)
                for t in (_noise(rng, like), rgb, m, o, gr))
        out = depthfm_generate(
            self.model, rng, rgb, num_steps=self.num_steps, guide_rgb=gr,
            guide_mask=m, observation=o, attn_impl=self.attn_impl,
            tome=self.tome, deep_cache=self.deep_cache)
        return comm.all_gather(out[..., 0].float(), group)

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, mask: np.ndarray | None = None,
                 observation: np.ndarray | None = None,
                 guide_rgb: np.ndarray | None = None, *,
                 noise: np.ndarray | None = None) -> np.ndarray:
        """image: [H,W,3] or [B,H,W,3] uint8/float in [0,255]; mask: [H,W] /
        [B,H,W] (> 0 = amodal object); observation: same shape in [0,1]
        (the normalised base depth); guide_rgb: the un-occluded render in
        [0,255] for guide types including "image". `noise`: the q_sample
        noise, [B, s, s, 4] with s = `latent_size()` (an array, or a tensor
        such as `seeded_noise`'s), instead of the seeded draw.

        Returns amodal depth [H,W] (or [B,H,W]) in [0,1], far = 0 (the
        1-x flip of `dfm_amodal.py:261-262`), float32."""
        g = self.cfg.guide_type
        if "mask" in g and mask is None:
            raise ValueError(f"guide_type {g!r} requires mask")
        if "observation" in g and observation is None:
            raise ValueError(f"guide_type {g!r} requires observation")
        if "image" in g and guide_rgb is None:
            raise ValueError(f"guide_type {g!r} requires guide_rgb")
        img, squeeze = self._batch(image, 3)
        msk, _ = self._batch(mask if "mask" in g else None, 1)
        obs, _ = self._batch(observation if "observation" in g else None, 1)
        grgb, _ = self._batch(guide_rgb if "image" in g else None, 3)
        out = self._generate(img, msk, obs, grgb,
                             self._rng(noise)).cpu().numpy()
        return out[0] if squeeze else out

    @torch.inference_mode()
    def predict_depth(self, image: np.ndarray, *, ensemble_size: int = 1,
                      num_steps: int = 2,
                      noise: np.ndarray | None = None) -> np.ndarray:
        """Plain (unguided) DepthFM depth, the pseudo-label factory's
        labeler protocol (reference `dfm.py:59-94`, `sam_pl_gen.py:56-61`:
        2 steps x ensemble). Requires guide_type "none". Returns [H,W] /
        [B,H,W] in [0,1] (no 1-x flip: the factory's convention)."""
        img, squeeze = self._batch(image, 3)
        rgb, _, _, _ = self._prep(img, None, None, None)
        out = depthfm_predict_depth(
            self.model, self._rng(noise), rgb, num_steps=num_steps,
            ensemble_size=ensemble_size, attn_impl=self.attn_impl,
            tome=self.tome, deep_cache=self.deep_cache)
        out = out[..., 0].float().cpu().numpy()
        return out[0] if squeeze else out
