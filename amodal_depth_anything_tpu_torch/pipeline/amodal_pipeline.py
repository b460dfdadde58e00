"""End-to-end amodal-depth inference on the card.

Port of the exact path of the JAX package's `pipeline/amodal_pipeline.py`:
resize the image, run the frozen raw DAV2 base, min-max normalise its
depth, run the guided AmodalDAv2 on the image, the mask and that depth,
and blend the result into the base depth (`ops.blend.median_filter_blend`).

Behaviour parity with the reference `infer.py:16-121`:
  * Channel order: the reference feeds cv2's BGR straight into both models
    (`infer.py:75-76,83`); `infer_single_image` does the same.
  * Base input: bilinear, align_corners=False (cv2 INTER_LINEAR on uint8
    when `base_image` is passed, as `infer_single_image` does).
  * Guided inputs: nearest resize (`infer.py:84-86`); the model gets
    `mask*2-1` and `depth*2-1` (`infer.py:88-93`).

`save_serving` / `load_serving` write and read the JAX package's
serving-state format (`pipeline.serving_ckpt`, kind "amodal_dav2"), so a
state saved by either package serves in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.amodal_dav2 import (AmodalDAv2, DAV2Config, RawDAV2,
                                  build_model, init_weights_)
from ..ops.blend import median_filter_blend
from ..ops.precision import apply_precision_policy
from ..ops.resize import resize2d, resize_nearest

__all__ = ["amodal_depth_graph", "AmodalDepthPipeline"]


def amodal_depth_graph(raw_model: RawDAV2, amodal_model: AmodalDAv2,
                       image: torch.Tensor, mask: torch.Tensor, *,
                       size: int = 518, attn_impl: str | None = None,
                       base_image: torch.Tensor | None = None):
    """image: [B,h,w,3] float in [0,255]; mask: [B,h,w,1] float (>0 = on).

    Returns (base_depth [B,S,S], blended_depth [B,S,S]) in [0,1].

    `base_image`: optional [B,S,S,3] float in [0,255], a host-resized input
    for the base branch (the reference resizes with cv2 on uint8)."""
    img01 = image / 255.0
    if base_image is not None:
        base_in = base_image / 255.0
    else:
        base_in = resize2d(img01, size=(size, size), method="bilinear")
    base_depth = raw_model(base_in, attn_impl=attn_impl)  # [B,S,S]
    lo = base_depth.amin(dim=(-1, -2), keepdim=True)
    hi = base_depth.amax(dim=(-1, -2), keepdim=True)
    base_depth = (base_depth - lo) / torch.clamp(hi - lo, min=1e-8)

    rgb = resize_nearest(img01, size=(size, size))
    m = (resize_nearest(mask, size=(size, size)) > 0).to(image.dtype)
    obs = base_depth[..., None]
    pred = amodal_model(rgb, guide_mask=m * 2.0 - 1.0,
                        observation=obs * 2.0 - 1.0,
                        attn_impl=attn_impl)  # [B,S,S,1]
    blended = median_filter_blend(pred, obs, m)
    return base_depth, blended[..., 0]


class AmodalDepthPipeline:
    """Load the two models once, infer many images.

    The reference CLI's contract (`infer.py:59-121`): an image and an
    amodal mask in; base and amodal depth maps (and colourised renders) out.
    Runs on `device` ("cuda" unless the caller asks for "cpu") in `dtype`;
    a float32 pipeline turns TF32 off (`ops.precision`)."""

    def __init__(self, raw_model: RawDAV2, amodal_model: AmodalDAv2, *,
                 size: int = 518, attn_impl: str | None = None,
                 device="cuda", dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        apply_precision_policy(dtype)
        self.raw_model = raw_model.to(device=self.device, dtype=dtype).eval()
        self.amodal_model = amodal_model.to(device=self.device,
                                            dtype=dtype).eval()
        self.raw_cfg: DAV2Config = raw_model.cfg
        self.amodal_cfg: DAV2Config = amodal_model.cfg
        self.size = size
        self.attn_impl = attn_impl

    @classmethod
    def init_random(cls, seed: int = 0, *, encoder: str = "vitt",
                    base_encoder: str | None = None, size: int = 56,
                    device="cuda", dtype: torch.dtype = torch.float32, **kw):
        """Seeded random-weight pipeline: a raw base on `base_encoder`
        (default `encoder`) and an AmodalDAv2 on `encoder`. Outputs are
        meaningless; every seam is real. The weights are drawn on `device`
        in float32 from a `torch.Generator` seeded with `seed`."""
        raw_cfg = DAV2Config(encoder=base_encoder or encoder,
                             guide_type="none", raw=True)
        am_cfg = DAV2Config(encoder=encoder, guide_type="mask+observation")
        gen = torch.Generator(device=device).manual_seed(seed)
        models = [init_weights_(build_model(c, device=device), gen)
                  for c in (raw_cfg, am_cfg)]
        return cls(*models, size=size, device=device, dtype=dtype, **kw)

    @classmethod
    def from_checkpoints(cls, base_ckpt: str, amodal_ckpt: str, **kw):
        """base_ckpt: raw DAV2 .pth / .safetensors; amodal_ckpt: HF-style
        model.safetensors (or the directory holding it)."""
        from ..convert.weights import infer_dav2_config, load_state_dict
        if os.path.isdir(amodal_ckpt):
            amodal_ckpt = os.path.join(amodal_ckpt, "model.safetensors")
        models = []
        for path, raw in ((base_ckpt, True), (amodal_ckpt, None)):
            sd = load_state_dict(path)
            model = build_model(infer_dav2_config(sd, raw=raw))
            model.load_state_dict(sd, strict=True)
            models.append(model)
        return cls(*models, **kw)

    def save_serving(self, path: str) -> None:
        """Persist the READY-TO-SERVE state: both models' weights in their
        serving dtype and what builds the pipeline, in the JAX package's
        format (kind "amodal_dav2"), which its
        `AmodalDepthPipeline.load_serving` restores too (see
        pipeline/serving_ckpt.py)."""
        import dataclasses

        from ..convert.weights import params_to_jax
        from .serving_ckpt import (attn_impl_to_jax, dtype_name,
                                   save_serving_state)
        save_serving_state(path, {
            "raw": params_to_jax(self.raw_model.state_dict(), self.raw_cfg,
                                 tensors=True),
            "amodal": params_to_jax(self.amodal_model.state_dict(),
                                    self.amodal_cfg, tensors=True),
        }, {
            "kind": "amodal_dav2",
            "raw_cfg": dataclasses.asdict(self.raw_cfg),
            "amodal_cfg": dataclasses.asdict(self.amodal_cfg),
            "size": self.size,
            "attn_impl": attn_impl_to_jax(self.attn_impl),
            "dtype": dtype_name(self.dtype),
            "base_token_merge": None,
            "amodal_token_merge": None,
            "head_batch_tile": None,
        })

    @classmethod
    def load_serving(cls, path: str, *, attn_impl: str | None = None,
                     device="cuda"):
        """Restore a pipeline saved by `save_serving` of either package on
        `device`, the weights in their saved dtype (no cast). `attn_impl`
        overrides the saved one. Refuses int8, ToMe and head_batch_tile
        states."""
        from ..convert.weights import params_from_jax
        from .serving_ckpt import (attn_impl_from_jax, cfg_from_dict,
                                   restore_serving_state, serving_dtype)
        trees, meta = restore_serving_state(path, expect_kind="amodal_dav2",
                                            device=device)
        dtype = serving_dtype(meta, trees)
        models = []
        for name in ("raw", "amodal"):
            cfg = cfg_from_dict(DAV2Config, meta[f"{name}_cfg"])
            model = build_model(cfg, device=device, dtype=dtype)
            model.load_state_dict(params_from_jax(trees[name], cfg),
                                  strict=True, assign=True)
            models.append(model)
        return cls(*models, size=int(meta["size"]),
                   attn_impl=attn_impl or attn_impl_from_jax(
                       meta["attn_impl"]),
                   device=device, dtype=dtype)

    def _graph(self, img: torch.Tensor, msk: torch.Tensor,
               base_image: torch.Tensor | None = None):
        """The device program on batched device tensors (image [B,H,W,3],
        mask [B,H,W,1]): (base, blended) [B,S,S] float32 on the device."""
        base, blended = amodal_depth_graph(
            self.raw_model, self.amodal_model, img, msk, size=self.size,
            attn_impl=self.attn_impl, base_image=base_image)
        return base.float(), blended.float()

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 base_image: np.ndarray | None = None):
        """image: [H,W,3] or [B,H,W,3] uint8/float; mask: [H,W] / [B,H,W].

        `base_image`: optional pre-resized [.,S,S,3] input for the base
        branch (`infer_single_image` passes the cv2-resized uint8 image).

        Returns (base_depth, blended_depth) as float32 numpy arrays."""
        img = np.asarray(image, np.float32)
        msk = np.asarray(mask, np.float32)
        squeeze = img.ndim == 3
        if squeeze:
            img, msk = img[None], msk[None]
            if base_image is not None and base_image.ndim == 3:
                base_image = base_image[None]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(
                device=self.device, dtype=self.dtype)

        base, blended = (t.cpu().numpy() for t in self._graph(
            dev(img), dev(msk[..., None]),
            None if base_image is None else dev(base_image)))
        if squeeze:
            base, blended = base[0], blended[0]
        return base, blended

    def infer_single_image(self, input_image_path: str, input_mask_path: str,
                           output_path: str):
        """Reference-compatible file-in/file-out inference
        (infer.py:71-121). Needs cv2, PIL and matplotlib."""
        import cv2
        from PIL import Image

        from ..utils.image import colorize_depth, highlight_target

        os.makedirs(output_path, exist_ok=True)
        name = os.path.basename(input_image_path).split(".")[0]
        image = cv2.imread(input_image_path)  # BGR, as the reference feeds it
        mask = (np.asarray(Image.open(input_mask_path)) > 0).astype(np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]

        # cv2 uint8 resize on the host for the base branch, as the
        # reference's predict_base_depth (infer.py:17)
        base_image = cv2.resize(image, (self.size, self.size))
        base, blended = self(image, mask, base_image=base_image)

        mask_s = resize_nearest(torch.from_numpy(mask[None, :, :, None]),
                                size=(self.size, self.size))[0, :, :, 0]
        mask_u8 = (mask_s.numpy() > 0).astype(np.uint8) * 255
        h, w = image.shape[:2]

        def render(depth, highlight):
            colored = (colorize_depth(depth) * 255).astype(np.uint8)
            if highlight:
                colored = highlight_target(colored, mask_u8)
            colored = cv2.resize(colored, (w, h),
                                 interpolation=cv2.INTER_NEAREST)
            return colored[:, :, ::-1]  # the reference's BGR->RGB flip

        raw_render = render(base, highlight=False)
        amodal_render = render(blended, highlight=True)
        cv2.imwrite(os.path.join(output_path,
                                 f"{name}_raw_depth_rendered.png"), raw_render)
        cv2.imwrite(os.path.join(output_path,
                                 f"{name}_amodal_depth_rendered.png"),
                    amodal_render)
        return raw_render, amodal_render
