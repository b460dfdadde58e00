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
state saved by either package serves in the other, compressed or not.

Serving compression, opt-in and parity-breaking as in the JAX package:
`quantize_int8` (W8A8 trunks and heads, `ops.quant`), `base_token_merge` /
`amodal_token_merge` (ToMe in the trunks, `ops.token_merge`) and
`head_batch_tile` (the DPT heads over batch chunks; exact).

Scale-out (`mesh=`, JAX `AmodalDepthPipeline(mesh=)`): with a ``model``
axis > 1 both trunks run tensor-parallel (`parallel.shard_params`) and
their token streams sequence-parallel, the DPT heads replicated; with
``data`` ranks every rank runs its rows of the batch and the maps are
all-gathered, so every rank returns the whole batch.

Batch invariance: on the card the DPT heads always run one batch row at a
time (`served_head_tile`), so that a served request gets the same bits in
every row of every batch bucket (the trunks' products and attention are
row-invariant there; cuDNN's head convolutions are not).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.amodal_dav2 import (AmodalDAv2, DAV2Config, DepthAnythingV2,
                                  RawDAV2, build_guide, build_model,
                                  init_weights_)
from ..ops.blend import median_filter_blend
from ..ops.precision import apply_precision_policy
from ..ops.resize import resize2d, resize_nearest
from ..parallel import comm
from ..parallel.mesh import axis_group, axis_size
from ..parallel.multihost import local_device
from ..parallel.sharding import shard_batch, shard_params

__all__ = ["amodal_depth_graph", "AmodalDepthPipeline"]


def _pair(v) -> tuple[int, int] | None:
    return tuple(int(x) for x in v) if v else None


def _dav2(model) -> DepthAnythingV2:
    """The DINOv2 + DPT module of an AmodalDAv2 or a RawDAV2."""
    return model.encoder if isinstance(model, AmodalDAv2) else model


def _trunk_inputs(model, x: torch.Tensor, **guides):
    """(normalised image, guide) as the model's trunk takes them."""
    enc = _dav2(model)
    xn = (x - enc.mean.to(x.dtype)) / enc.std.to(x.dtype)
    guide = None if enc.cfg.raw else build_guide(enc.cfg, **guides)
    return xn, guide


def _head_sites(model) -> dict:
    """{head module name: JAX path under "depth_head"} of `model`'s head."""
    from ..convert.weights import dav2_layer_paths
    prefix = "" if isinstance(model, RawDAV2) else "encoder."
    head = f"{prefix}depth_head."
    return {name[len(head):]: path[len("depth_head/"):]
            for name, path in dav2_layer_paths(_dav2(model).cfg).items()
            if name.startswith(head)}


def amodal_depth_graph(raw_model: RawDAV2, amodal_model: AmodalDAv2,
                       image: torch.Tensor, mask: torch.Tensor, *,
                       size: int = 518, attn_impl: str | None = None,
                       base_image: torch.Tensor | None = None,
                       base_token_merge: tuple[int, int] | None = None,
                       amodal_token_merge: tuple[int, int] | None = None,
                       head_batch_tile: int | None = None,
                       act_sharding=None):
    """image: [B,h,w,3] float in [0,255]; mask: [B,h,w,1] float (>0 = on).

    Returns (base_depth [B,S,S], blended_depth [B,S,S]) in [0,1].

    `base_image`: optional [B,S,S,3] float in [0,255], a host-resized input
    for the base branch (the reference resizes with cv2 on uint8).
    `base_token_merge` / `amodal_token_merge`: ToMe `(after_layer, r)` per
    trunk; `head_batch_tile`: both heads over batch chunks; `act_sharding`:
    a mesh whose model axis splits both trunks' token streams (the trunks
    tensor-parallel over it)."""
    img01 = image / 255.0
    if base_image is not None:
        base_in = base_image / 255.0
    else:
        base_in = resize2d(img01, size=(size, size), method="bilinear")
    base_depth = raw_model(base_in, attn_impl=attn_impl,
                           token_merge=base_token_merge,
                           head_batch_tile=head_batch_tile,
                           act_sharding=act_sharding)  # [B,S,S]
    lo = base_depth.amin(dim=(-1, -2), keepdim=True)
    hi = base_depth.amax(dim=(-1, -2), keepdim=True)
    base_depth = (base_depth - lo) / torch.clamp(hi - lo, min=1e-8)

    rgb = resize_nearest(img01, size=(size, size))
    m = (resize_nearest(mask, size=(size, size)) > 0).to(image.dtype)
    obs = base_depth[..., None]
    pred = amodal_model(rgb, guide_mask=m * 2.0 - 1.0,
                        observation=obs * 2.0 - 1.0,
                        attn_impl=attn_impl, token_merge=amodal_token_merge,
                        head_batch_tile=head_batch_tile,
                        act_sharding=act_sharding)  # [B,S,S,1]
    blended = median_filter_blend(pred, obs, m)
    return base_depth, blended[..., 0]


class AmodalDepthPipeline:
    """Load the two models once, infer many images.

    The reference CLI's contract (`infer.py:59-121`): an image and an
    amodal mask in; base and amodal depth maps (and colourised renders) out.
    Runs on `device` ("cuda" unless the caller asks for "cpu") in `dtype`;
    a float32 pipeline turns TF32 off (`ops.precision`).

    `base_token_merge` / `amodal_token_merge`: opt-in ToMe `(after_layer,
    r)` per trunk; `head_batch_tile`: the DPT heads over batch chunks of
    this size (exact). A model that is already quantised keeps its
    quantised layers' dtypes (`ops.quant`).

    `mesh` (`parallel.make_mesh`): a ``model`` axis > 1 shards both trunks
    tensor-parallel over it, in place, and runs their token streams
    sequence-parallel; ``data`` ranks each run their rows of a batch,
    which the data size must divide. In a process group, "cuda" is this
    rank's card."""

    def __init__(self, raw_model: RawDAV2, amodal_model: AmodalDAv2, *,
                 size: int = 518, attn_impl: str | None = None,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 base_token_merge: tuple[int, int] | None = None,
                 amodal_token_merge: tuple[int, int] | None = None,
                 head_batch_tile: int | None = None, mesh=None):
        self.device = local_device(device)
        self.dtype = dtype
        apply_precision_policy(dtype)
        self.raw_model = raw_model.to(device=self.device, dtype=dtype).eval()
        self.amodal_model = amodal_model.to(device=self.device,
                                            dtype=dtype).eval()
        self.raw_cfg: DAV2Config = raw_model.cfg
        self.amodal_cfg: DAV2Config = amodal_model.cfg
        self.size = size
        self.attn_impl = attn_impl
        self.base_token_merge = _pair(base_token_merge)
        self.amodal_token_merge = _pair(amodal_token_merge)
        self.head_batch_tile = int(head_batch_tile) if head_batch_tile \
            else None
        self.mesh = mesh
        self.act_sharding = None
        if axis_size(mesh, "model") > 1:
            for model in (self.raw_model, self.amodal_model):
                shard_params(mesh, model, tensor_parallel=True)
            self.act_sharding = mesh

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
            "base_token_merge": list(self.base_token_merge)
            if self.base_token_merge else None,
            "amodal_token_merge": list(self.amodal_token_merge)
            if self.amodal_token_merge else None,
            "head_batch_tile": self.head_batch_tile,
        })

    @classmethod
    def load_serving(cls, path: str, *, attn_impl: str | None = None,
                     device="cuda", mesh=None):
        """Restore a pipeline saved by `save_serving` of either package on
        `device`, the weights in their saved dtype (no cast, no
        re-quantisation: int8 codes stay int8, scales float32) and the
        ToMe / head_batch_tile knobs it was saved with. `attn_impl`
        overrides the saved one; `mesh` as in the constructor."""
        from ..convert.weights import params_from_jax
        from ..ops.quant import apply_quantized_
        from .serving_ckpt import (attn_impl_from_jax, cfg_from_dict,
                                   restore_serving_state, serving_dtype)
        trees, meta = restore_serving_state(path, expect_kind="amodal_dav2",
                                            device=device)
        dtype = serving_dtype(meta, trees)
        models = []
        for name in ("raw", "amodal"):
            cfg = cfg_from_dict(DAV2Config, meta[f"{name}_cfg"])
            model = build_model(cfg, device=device, dtype=dtype)
            sd = params_from_jax(trees[name], cfg)
            apply_quantized_(model, sd)
            model.load_state_dict(sd, strict=True, assign=True)
            models.append(model)
        return cls(*models, size=int(meta["size"]),
                   attn_impl=attn_impl or attn_impl_from_jax(
                       meta["attn_impl"]),
                   device=device, dtype=dtype,
                   base_token_merge=meta.get("base_token_merge"),
                   amodal_token_merge=meta.get("amodal_token_merge"),
                   head_batch_tile=meta.get("head_batch_tile"), mesh=mesh)

    @torch.no_grad()
    def quantize_int8(self, *, base: bool = True, amodal: bool = False,
                      head: bool = False, calibration=None,
                      margin: float = 1.25, dynamic: bool = False,
                      smooth_alpha: float | None = None,
                      families: tuple | None = None, mixed: bool = False,
                      base_layer_mask=None, amodal_layer_mask=None) -> None:
        """Opt-in W8A8 int8 serving of the frozen models, in place (JAX
        `AmodalDepthPipeline.quantize_int8`, the same options, checks and
        order; `ops.quant`).

        Without `calibration`: LayerNorm-bound static scales on the LN-fed
        qkv and first FFN matmuls. `calibration=(image, mask)` (as
        `__call__` takes them): one forward per model records per-block
        activation maxima and all four trunk families quantise with static
        scales (x `margin`); `head=True` also quantises the DPT-head convs
        from maxima recorded on the quantised trunks. `dynamic=True`: all
        four families (and with `head` the head convs the JAX diffusion
        rule picks) with run-time scales, no calibration. `smooth_alpha`:
        SmoothQuant on proj / ffn2 first (calibrated only); `families`
        restricts the trunk families; `mixed`: LN-bound scales on qkv /
        ffn1 and calibrated ones on proj / ffn2; `base_layer_mask` /
        `amodal_layer_mask` ([depth] bools) restrict it to those blocks."""
        from ..ops import quant as Q

        if families is None:
            families = Q.FAMILIES
        families = tuple(families)
        if smooth_alpha is not None and calibration is None:
            raise ValueError("smooth_alpha requires calibration=(image, "
                             "mask) — it needs per-channel act stats")
        models = []
        if base:
            models.append((self.raw_model, base_layer_mask))
        if amodal:
            models.append((self.amodal_model, amodal_layer_mask))

        if dynamic:
            if calibration is not None:
                raise ValueError("dynamic=True needs no calibration")
            if mixed or smooth_alpha is not None or families != Q.FAMILIES:
                raise ValueError("dynamic=True is incompatible with "
                                 "families/smooth_alpha/mixed")
            for model, mask in models:
                enc = _dav2(model)
                Q.quantize_vit_trunk_int8(enc.pretrained, dynamic=True,
                                          layer_mask=mask)
                if head:
                    Q.quantize_diffusion_modules(
                        enc.depth_head, _head_sites(model),
                        skip_suffixes=("output_conv2/conv2",))
            return

        if head and calibration is None:
            raise ValueError("head=True requires calibration=(image, mask)")
        if head and not (base or amodal):
            raise ValueError("head=True quantizes the heads of the models "
                             "selected by base=/amodal= — enable at least one")

        stats = {}
        base_in = rgb = guides = None
        if calibration is not None:
            image, mask = calibration
            img = np.asarray(image, np.float32)
            msk = np.asarray(mask, np.float32)
            if img.ndim == 3:
                img, msk = img[None], msk[None]
            img_t, msk_t = self._device(img), self._device(msk[..., None])
            img01 = img_t / 255.0
            size = (self.size, self.size)
            if base:
                base_in = resize2d(img01, size=size, method="bilinear")
                stats["raw"] = Q.collect_trunk_act_stats(
                    _dav2(self.raw_model).pretrained,
                    *_trunk_inputs(self.raw_model, base_in),
                    attn_impl=self.attn_impl)
            if amodal:
                m = (resize_nearest(msk_t, size=size) > 0).to(self.dtype)
                base_d, _ = amodal_depth_graph(
                    self.raw_model, self.amodal_model, img_t, msk_t,
                    size=self.size, attn_impl=self.attn_impl)
                guides = {"guide_mask": m * 2.0 - 1.0,
                          "observation": base_d[..., None] * 2.0 - 1.0}
                rgb = resize_nearest(img01, size=size)
                stats["amodal"] = Q.collect_trunk_act_stats(
                    _dav2(self.amodal_model).pretrained,
                    *_trunk_inputs(self.amodal_model, rgb, **guides),
                    attn_impl=self.attn_impl)

        def quantize_trunk(vit, st, lm):
            if mixed:
                if st is None:
                    raise ValueError("mixed=True requires calibration")
                Q.quantize_vit_trunk_int8(
                    vit, act_stats=st, margin=margin,
                    smooth_alpha=smooth_alpha, layer_mask=lm,
                    families=tuple(f for f in ("proj", "ffn2")
                                   if f in families))
                Q.quantize_vit_trunk_int8(
                    vit, layer_mask=lm,
                    families=tuple(f for f in ("qkv", "ffn1")
                                   if f in families))
                return
            Q.quantize_vit_trunk_int8(vit, act_stats=st, margin=margin,
                                      families=families,
                                      smooth_alpha=smooth_alpha,
                                      layer_mask=lm)

        if base:
            quantize_trunk(_dav2(self.raw_model).pretrained,
                           stats.get("raw"), base_layer_mask)
        if amodal:
            quantize_trunk(_dav2(self.amodal_model).pretrained,
                           stats.get("amodal"), amodal_layer_mask)
        if head:
            # head maxima recorded on the quantised trunks, as they serve
            for model, x, kw in ((self.raw_model, base_in, {}),
                                 (self.amodal_model, rgb, guides)):
                if x is None:
                    continue
                enc = _dav2(model)
                xn, guide = _trunk_inputs(model, x, **kw)
                feats = enc.pretrained.get_intermediate_layers(
                    xn, guide, enc.cfg.taps, attn_impl=self.attn_impl)
                hs, _ = Q.collect_dpt_head_act_stats(
                    enc.depth_head, feats,
                    (x.shape[1] // 14, x.shape[2] // 14))
                Q.quantize_dpt_head_int8(enc.depth_head, hs, margin=margin)

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(
            device=self.device, dtype=self.dtype)

    @property
    def served_head_tile(self) -> int | None:
        """The DPT heads' batch tile the program runs: 1 on the card, so a
        row's result is the same in every row of every batch (cuDNN's 3x3
        convolutions at the heads' 37 x 37 level round a repeated bf16
        input differently in the two halves of a batch of 4,
        `tools/batch_position_probe.py`); `head_batch_tile` elsewhere."""
        return 1 if self.device.type == "cuda" else self.head_batch_tile

    def _graph(self, img: torch.Tensor, msk: torch.Tensor,
               base_image: torch.Tensor | None = None):
        """The device program on batched device tensors (image [B,H,W,3],
        mask [B,H,W,1]): (base, blended) [B,S,S] float32 on the device.
        Under a mesh this rank runs its rows and the maps are gathered over
        the data ranks."""
        group = axis_group(self.mesh, "data")
        if group is not None:
            img, msk, base_image = (
                None if t is None else shard_batch(self.mesh, t)
                for t in (img, msk, base_image))
        base, blended = amodal_depth_graph(
            self.raw_model, self.amodal_model, img, msk, size=self.size,
            attn_impl=self.attn_impl, base_image=base_image,
            base_token_merge=self.base_token_merge,
            amodal_token_merge=self.amodal_token_merge,
            head_batch_tile=self.served_head_tile,
            act_sharding=self.act_sharding)
        return tuple(comm.all_gather(t.float(), group)
                     for t in (base, blended))

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

        dev = self._device
        base, blended = (t.cpu().numpy() for t in self._graph(
            dev(img), dev(msk[..., None]),
            None if base_image is None else dev(base_image)))
        if squeeze:
            base, blended = base[0], blended[0]
        return base, blended

    def infer_single_image(self, input_image_path: str, input_mask_path: str,
                           output_path: str):
        """Reference-compatible file-in/file-out inference
        (infer.py:71-121), without cv2, PIL or matplotlib: the image read
        as `cv2.imread` reads it (BGR, as the reference feeds it) and the
        mask as PIL reads it (`utils.image`, the native codec), cv2's
        INTER_LINEAR and INTER_NEAREST resizes from `heuristics.host_ops`,
        the Spectral_r render and contour of `utils.image`, written as PNGs
        whose pixels equal `cv2.imwrite`'s. Returns the two renders as
        written (BGR, the reference's arrays)."""
        from ..heuristics import host_ops
        from ..utils.image import (colorize_depth, highlight_target,
                                   read_image, read_image_bgr, write_png)

        os.makedirs(output_path, exist_ok=True)
        name = os.path.basename(input_image_path).split(".")[0]
        image = read_image_bgr(input_image_path)
        mask = (read_image(input_mask_path) > 0).astype(np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]

        # cv2 uint8 resize on the host for the base branch, as the
        # reference's predict_base_depth (infer.py:17)
        base_image = host_ops.resize_linear(image, (self.size, self.size))
        base, blended = self(image, mask, base_image=base_image)

        mask_s = resize_nearest(torch.from_numpy(mask[None, :, :, None]),
                                size=(self.size, self.size))[0, :, :, 0]
        mask_u8 = (mask_s.numpy() > 0).astype(np.uint8) * 255
        h, w = image.shape[:2]

        def render(depth, highlight):
            colored = (colorize_depth(depth) * 255).astype(np.uint8)
            if highlight:
                colored = highlight_target(colored, mask_u8)
            colored = host_ops.resize_nearest(colored, (w, h))
            return colored[:, :, ::-1]  # the reference's BGR->RGB flip

        raw_render = render(base, highlight=False)
        amodal_render = render(blended, highlight=True)
        # cv2.imwrite stores a BGR array as RGB: the file holds the flip back
        write_png(os.path.join(output_path, f"{name}_raw_depth_rendered.png"),
                  raw_render[:, :, ::-1])
        write_png(os.path.join(output_path,
                               f"{name}_amodal_depth_rendered.png"),
                  amodal_render[:, :, ::-1])
        return raw_render, amodal_render
