"""SAM + pix2gestalt amodal-mask derivation (the demo's model heuristics).

Port of the JAX package's `heuristics/mask_heuristics.py`. A user marks
points on an object; `MaskHeuristics.amodal_mask_from_points` turns the
point-hint mask into prompts (`get_points_from_components`: centroids of
small connected components, a 10 px grid over large ones, at most
`max_points` in label order), SAM gives the visible mask, pix2gestalt
completes the object at 256 px, RMBG-1.4 (or, without it, a threshold on
the near-white background) mattes the completion, and the result, resized
back, is united with the visible mask.

The host steps are `heuristics.host_ops`, which compute what the JAX
package asks cv2 for, bit for bit; the models are `models.sam`,
`models.pix2gestalt` (UNet, VAE, CLIP) and `models.rmbg`. Everything runs
on the device the modules live on: "cuda" unless the caller asks for
"cpu". The compute dtype is float32 (TF32 off) until `cast_to`; RMBG
stays float32, as in the JAX package. The noise of a completion comes from
a `torch.Generator` seeded with `seed` on the modules' device, or is
handed over as `noise` (the tests hand over the JAX package's draws).

The completion is one program, as the JAX package jits it: on the card it
is captured whole -- the CLIP context, the DDIM loop and the VAE render --
as one CUDA graph per (`p2g_cfg`, compute dtype), so steps, guidance,
`clip_input` and DeepCache each get their own, over static inputs (the
image, the visible mask and the initial noise, drawn outside the graph
from the seeded generator as the eager call draws it), and each call
replays it; at most `MAX_COMPLETION_GRAPHS` are kept. The replay is
bitwise the eager call. `captured=False` runs the completion eagerly (the
CPU's only way, and what a comparison on the card asks for).

`quantize_p2g_int8` (weight-only w8 or w4, or W8A8, over the pix2gestalt
UNet) and `quantize_sam_int8` (SAM's linears and convs) swap the layers the
JAX package's `quantize_diffusion_int8` picks for `ops.quant`'s quantised
modules, with its site rules (the UNet's thresholds scaled with its width;
SAM's transposed upscaling convs skipped); a quantised completion is
captured anew. `save_serving` / `load_serving` write and read the JAX
package's serving-state format (kind "mask_heuristics": trees "sam", "p2g"
and the optional "rmbg" in the JAX layout, quantised layers under their JAX
leaf names and dtypes), so a state saved by either package restores in the
other.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn

from ..models.clip_vit import CLIPVisionConfig
from ..models.pix2gestalt import Pix2Gestalt, Pix2GestaltConfig
from ..models.rmbg import FoldedBatchNorm, ISNet, RMBGConfig
from ..models.sam import SAM, SAMConfig
from ..models.unet_ldm import GroupNorm
from ..models.vae import SD_VAE, VAEConfig
from ..ops.conv import LayerNorm2d
from ..ops.precision import apply_precision_policy
from ..utils.graphs import capture
from . import host_ops

__all__ = ["Pix2GestaltConfig", "MaskHeuristics", "make_rmbg_matting_fn",
           "get_points_from_components", "init_heuristics_",
           "SAM_PIXEL_MEAN", "SAM_PIXEL_STD"]

SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)
MAX_COMPLETION_GRAPHS = 4
COMPLETION_WARMUP = 1   # eager completions before a capture


@torch.no_grad()
def init_heuristics_(module: nn.Module,
                     generator: torch.Generator) -> nn.Module:
    """Seeded random weights for smoke runs: convolutions and linears
    uniform(+-1/sqrt(fan_in)), norms at one and zero, embeddings and
    position tables normal(0.02), the Fourier matrix normal(1), the
    unconditional context at zero, as the JAX package starts them. Unlike
    the JAX init, nothing that feeds the output starts at zero (SAM's
    upscaling convolutions, the UNet's output layers), or the mask and the
    completion would not depend on the input. Draws from `generator`, which
    must live on the parameters' device; raises if a parameter is left
    undrawn."""
    drawn = set()

    def normal(t, std):
        nn.init.normal_(t, std=std, generator=generator)
        drawn.add(id(t))

    for mod in module.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            for p in (mod.weight, mod.bias):
                if p is not None:
                    nn.init.uniform_(p, -bound, bound, generator=generator)
                    drawn.add(id(p))
        elif isinstance(mod, nn.Embedding):
            normal(mod.weight, 0.02)
        elif isinstance(mod, (nn.LayerNorm, LayerNorm2d, GroupNorm,
                              FoldedBatchNorm)):
            one, zero = ((mod.scale, mod.shift) if isinstance(
                mod, FoldedBatchNorm) else (mod.weight, mod.bias))
            one.fill_(1.0)
            zero.zero_()
            drawn.update((id(one), id(zero)))
        for name, p in mod.named_parameters(recurse=False):
            if name in ("pos_embed", "class_embedding", "rel_pos_h",
                        "rel_pos_w"):
                normal(p, 0.02)
            elif name == "uncond_ctx":
                p.zero_()
                drawn.add(id(p))
        for name, buf in mod.named_buffers(recurse=False):
            if name == "positional_encoding_gaussian_matrix":
                normal(buf, 1.0)
    missed = [n for n, p in module.named_parameters() if id(p) not in drawn]
    if missed:
        raise ValueError(f"init_heuristics_ left {missed[:3]} undrawn")
    return module


def _empty(cls, *args, device, **kw):
    """`cls(*args)` with uninitialised parameters on `device`."""
    with torch.device("meta"):
        module = cls(*args, **kw)
    return module.to_empty(device=device)


def make_rmbg_matting_fn(model: ISNet, input_size: int = 1024,
                         threshold: float = 0.5):
    """The RMBG-1.4 matting hook: a completion render [H,W,3] float in
    [0, 1] -> a binary [H,W] float mask. Resized to the net's square input
    (1024 for RMBG-1.4), the float32 ISNet forward on the module's device,
    the alpha resized back (both as cv2 INTER_LINEAR), thresholded. The
    module and its settings ride on the function (`rmbg_model`, ...), so
    `MaskHeuristics.save_serving` can persist it."""
    model = model.float().eval()
    device = next(model.parameters()).device

    @torch.inference_mode()
    def matting_fn(completion: np.ndarray) -> np.ndarray:
        h, w = completion.shape[:2]
        img = host_ops.resize_linear(completion.astype(np.float32),
                                     (input_size, input_size))
        x = torch.from_numpy(img[None]).to(device)
        alpha = model(x)[0, ..., 0].cpu().numpy()
        alpha = host_ops.resize_linear(alpha, (w, h))
        return (alpha > threshold).astype(np.float32)

    matting_fn.rmbg_model = model
    matting_fn.rmbg_cfg = model.cfg
    matting_fn.rmbg_input_size = input_size
    matting_fn.rmbg_threshold = threshold
    return matting_fn


def get_points_from_components(mask_u8: np.ndarray,
                               small_component_thresh: int = 100,
                               grid_step: int = 10) -> np.ndarray:
    """Point prompts from the 8-connected components of a hint mask
    (reference app.py:77-99): the centroid of a component under
    `small_component_thresh` pixels, a `grid_step` grid over a larger one;
    components in cv2's label order. Returns [P, 2] float32 (x, y)."""
    n, labels, stats, centroids = host_ops.connected_components_with_stats(
        mask_u8)
    points = []
    for i in range(1, n):
        if stats[i, 4] < small_component_thresh:
            points.append([int(centroids[i][0]), int(centroids[i][1])])
        else:
            ys, xs = np.where(labels == i)
            for y in range(ys.min(), ys.max(), grid_step):
                for x in range(xs.min(), xs.max(), grid_step):
                    if labels[y, x] == i:
                        points.append([x, y])
    return np.asarray(points, np.float32)


def _dtype_of(module: nn.Module) -> torch.dtype:
    return next(p.dtype for p in module.parameters() if p.is_floating_point())


class MaskHeuristics:
    """Derives amodal masks from point prompts (the reference app's
    "prompt_points" flow) with a SAM and a pix2gestalt module, optionally
    an RMBG matting hook."""

    def __init__(self, sam: SAM, p2g: Pix2Gestalt, *, matting_fn=None,
                 max_points: int = 64):
        self.sam = sam.eval()
        self.p2g = p2g.eval()
        self.sam_cfg: SAMConfig = sam.cfg
        self.p2g_cfg: Pix2GestaltConfig = p2g.cfg
        self.clip_cfg: CLIPVisionConfig = p2g.clip_cfg
        self.vae_cfg: VAEConfig = p2g.vae_cfg
        self.matting_fn = matting_fn   # e.g. make_rmbg_matting_fn(...)
        self.max_points = max_points
        self.device = next(sam.parameters()).device
        self.compute_dtype = _dtype_of(p2g)
        apply_precision_policy(self.compute_dtype)
        self._completions: dict = {}   # captured completions by key

    def cast_to(self, dtype: torch.dtype) -> None:
        """Cast the SAM and pix2gestalt modules (in place) and the image
        inputs to `dtype`; prompt coordinates enter as float32 and RMBG
        stays float32, as in the JAX package."""
        self.sam.to(dtype)
        self.p2g.to(dtype)
        self.compute_dtype = dtype
        self._completions.clear()   # their graphs read the old weights
        apply_precision_policy(dtype)

    # -------------------------------------------------------- constructors

    @classmethod
    def init_random(cls, generator: torch.Generator | int = 0, *,
                    tiny: bool = False, device="cuda", **kw):
        """A seeded random-weight stack (smoke runs and tests) on `device`:
        SAM ViT-H, pix2gestalt on the SD-1.5 UNet with CLIP ViT-L/14 and
        the SD VAE, or with `tiny` the JAX package's tiny presets. The
        weights are drawn from `generator` (or a generator on `device`
        seeded with it). No RMBG: pass `matting_fn=` for one."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=device).manual_seed(
                int(generator))
        if tiny:
            sam_cfg = SAMConfig(img_size=64, embed_dim=32, depth=2,
                                num_heads=2, window_size=2,
                                global_blocks=(1,), out_chans=32,
                                decoder_dim=32, decoder_heads=2)
            p2g_cfg = Pix2GestaltConfig(image_size=32, context_dim=32,
                                        model_channels=32,
                                        channel_mult=(1, 2), num_heads=2,
                                        ddim_steps=2)
            clip_cfg = CLIPVisionConfig(image_size=32, patch_size=8,
                                        width=32, depth=2, num_heads=2,
                                        projection_dim=32)
            vae_cfg = VAEConfig(block_out_channels=(16, 32),
                                layers_per_block=1)
        else:
            sam_cfg, p2g_cfg = SAMConfig(), Pix2GestaltConfig()
            clip_cfg, vae_cfg = CLIPVisionConfig(), SD_VAE
        sam = init_heuristics_(_empty(SAM, sam_cfg, device=device), generator)
        p2g = init_heuristics_(
            _empty(Pix2Gestalt, p2g_cfg, clip_cfg, vae_cfg, device=device),
            generator)
        return cls(sam, p2g, **kw)

    @classmethod
    def from_checkpoints(cls, sam_ckpt: str, p2g_ckpt: str, vae_ckpt: str,
                         clip_ckpt: str, rmbg_ckpt: str | None = None, *,
                         device="cuda", **kw):
        """The released stack: SAM `sam_vit_h.pth`, the pix2gestalt LDM
        checkpoint (`epoch=000005.ckpt`; its conditioning layout and
        `cc_projection` read off the file), the diffusers SD VAE, the HF
        CLIP vision tower and, optionally, briaai/RMBG-1.4 as the matting
        hook; loaded strictly, on `device`."""
        from ..convert import heuristics as ch
        from ..convert.weights import load_state_dict

        if rmbg_ckpt is not None and "matting_fn" not in kw:
            rmbg = _empty(ISNet, RMBGConfig(), device=device)
            rmbg.load_state_dict(ch.fold_rmbg_batchnorm(
                load_state_dict(rmbg_ckpt)), strict=True)
            kw["matting_fn"] = make_rmbg_matting_fn(rmbg)
        sam = _empty(SAM, SAMConfig(), device=device)
        sam.load_state_dict(ch.sam_state_dict(load_state_dict(sam_ckpt)),
                            strict=True)
        ldm = torch.load(p2g_ckpt, map_location="cpu", weights_only=False)
        ldm_sd = ldm.get("state_dict", ldm)
        cfg, cc = ch.p2g_cfg_from_ckpt(ldm_sd)
        p2g = _empty(Pix2Gestalt, cfg, CLIPVisionConfig(), SD_VAE,
                     device=device,
                     cc_in=0 if cc is None else cc["weight"].shape[1],
                     cc_bias=cc is not None and "bias" in cc)
        p2g.unet.load_state_dict(ch.pix2gestalt_unet_state_dict(ldm_sd),
                                 strict=True)
        p2g.vae.load_state_dict(load_state_dict(vae_ckpt), strict=True)
        p2g.clip.load_state_dict(ch.clip_state_dict(
            load_state_dict(clip_ckpt)), strict=True)
        with torch.no_grad():
            p2g.uncond_ctx.zero_()
            if cc is not None:
                p2g.cc_projection.load_state_dict(cc, strict=True)
        return cls(sam, p2g, **kw)

    # ---------------------------------------------------------------- SAM

    @torch.inference_mode()
    def sam_visible_mask(self, image_rgb: np.ndarray,
                         points_xy: np.ndarray) -> np.ndarray:
        """image_rgb: [H,W,3] uint8; points_xy: [P,2] pixel coordinates.
        Returns the [H,W] bool visible-object mask (mask token 0, the
        reference's single-mask output)."""
        s = self.sam_cfg.img_size
        h, w = image_rgb.shape[:2]
        img = host_ops.resize_linear(image_rgb, (s, s)).astype(np.float32)
        img = (img - np.asarray(SAM_PIXEL_MEAN)) / np.asarray(SAM_PIXEL_STD)
        n = min(len(points_xy), self.max_points)
        if n == 0:
            raise ValueError("no point prompts")
        pts = np.zeros((1, self.max_points, 2), np.float32)
        lbl = np.full((1, self.max_points), -1.0, np.float32)
        pts[0, :n, 0] = points_xy[:n, 0] / w
        pts[0, :n, 1] = points_xy[:n, 1] / h
        lbl[0, :n] = 1.0
        x = torch.from_numpy(img[None]).to(self.device, self.compute_dtype)
        masks, _ = self.sam(x, torch.from_numpy(pts).to(self.device),
                            torch.from_numpy(lbl).to(self.device))
        logits = masks[0, 0].float().cpu().numpy()
        return host_ops.resize_linear(logits, (w, h)) > 0

    # -------------------------------------------------------- pix2gestalt

    def p2g_inputs(self, image_rgb: np.ndarray, visible_mask: np.ndarray):
        """The completion's device inputs: the image [1,S,S,3] and the
        visible mask [1,S,S,1] in [0, 1] and the compute dtype (cv2's
        INTER_LINEAR and INTER_AREA, then > 127)."""
        s = self.p2g_cfg.image_size
        img = host_ops.resize_linear(image_rgb, (s, s)).astype(
            np.float32) / 255.0
        m = host_ops.resize_area(visible_mask.astype(np.uint8) * 255, (s, s))
        m01 = (m > 127).astype(np.float32)[..., None]

        def dev(a):
            return torch.from_numpy(a[None]).to(self.device,
                                                self.compute_dtype)

        return dev(img), dev(m01)

    def p2g_noise(self, seed: int = 0) -> torch.Tensor:
        """The completion's initial latents [1, S/8, S/8, 4] float32, drawn
        on the modules' device from a generator seeded with `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(self.p2g.latent_shape(1, self.p2g_cfg.image_size),
                           generator=gen, device=self.device,
                           dtype=torch.float32)

    @torch.inference_mode()
    def pix2gestalt_completion(self, image_rgb: np.ndarray,
                               visible_mask: np.ndarray, seed: int = 0, *,
                               noise=None,
                               captured: bool | None = None) -> np.ndarray:
        """The amodal completion render [S,S,3] float32 in [0, 1] (S =
        `p2g_cfg.image_size`). `noise`: the initial latents [1, S/8, S/8, 4]
        (numpy or tensor); else drawn from a generator seeded with `seed`.
        `captured`: replay the completion's CUDA graph (default on the
        card) or run it eagerly."""
        img, m01 = self.p2g_inputs(image_rgb, visible_mask)
        if noise is None:
            z = self.p2g_noise(seed)
        else:
            z = (noise if isinstance(noise, torch.Tensor)
                 else torch.from_numpy(np.array(noise, np.float32)))
            z = z.to(self.device, torch.float32)
        if captured is None:
            captured = self.device.type == "cuda"
        if captured:
            out = self._captured_completion(img, m01, z)
        else:
            out = self.p2g.complete(img, m01, z, cfg=self.p2g_cfg)
        return out.float()[0].cpu().numpy()

    def _captured_completion(self, img, m01, z) -> torch.Tensor:
        """`Pix2Gestalt.complete` replayed from its CUDA graph for the
        current `p2g_cfg` and dtype (captured at the first call)."""
        if self.device.type != "cuda":
            raise RuntimeError("a captured completion needs the modules on a "
                               "CUDA device; captured=False runs it eagerly")
        cfg = self.p2g_cfg
        key = (cfg, self.compute_dtype, tuple(img.shape))
        entry = self._completions.pop(key, None)
        if entry is None:
            statics = [t.clone() for t in (img, m01, z)]
            graph, out = capture(
                lambda: self.p2g.complete(*statics, cfg=cfg),
                device=self.device, warmup=COMPLETION_WARMUP)
            entry = (statics, graph, out)
            while len(self._completions) >= MAX_COMPLETION_GRAPHS:
                self._completions.pop(next(iter(self._completions)))
        self._completions[key] = entry
        statics, graph, out = entry
        for static, t in zip(statics, (img, m01, z)):
            static.copy_(t)
        graph.replay()
        return out

    # -------------------------------------------------------------- public

    def amodal_mask_from_points(self, image_rgb: np.ndarray,
                                point_hint_mask: np.ndarray, *,
                                seed: int = 0, noise=None) -> np.ndarray:
        """Point hints -> SAM visible mask -> pix2gestalt completion ->
        matting -> [H,W] float32 amodal mask (a superset of the visible
        one). `seed` / `noise` as in `pix2gestalt_completion`."""
        hint_u8 = (np.asarray(point_hint_mask) > 0).astype(np.uint8) * 255
        points = get_points_from_components(hint_u8)
        visible = self.sam_visible_mask(image_rgb, points)
        completion = self.pix2gestalt_completion(image_rgb, visible, seed,
                                                 noise=noise)
        if self.matting_fn is not None:
            amodal = self.matting_fn(completion)   # e.g. RMBG-1.4
        else:
            # threshold matting: the completed object against the
            # (near-white) pix2gestalt background
            amodal = (completion.mean(axis=-1) < 0.95).astype(np.float32)
        h, w = image_rgb.shape[:2]
        amodal = host_ops.resize_nearest(amodal, (w, h))
        return np.maximum(amodal, visible.astype(np.float32))

    # ------------------------------------------------------------- knobs

    def quantize_p2g_int8(self, *, weight_only: bool = True,
                          bits: int = 8) -> dict:
        """Opt-in int8 for the pix2gestalt UNet, in place (JAX
        `MaskHeuristics.quantize_p2g_int8`; changes the result): weight-only
        w8 (`bits=8`, the default) or w4 (`bits=4`), or with
        `weight_only=False` W8A8 with dynamic scales. The JAX rule's wide
        convs and linears, its thresholds scaled with the UNet's width so
        that a narrow proxy quantises the same share of sites as the SD-1.5
        body. The captured completions are dropped: the next call captures
        the quantised program. Returns {module name: scheme}."""
        from ..convert.weights import p2g_unet_layer_paths
        from ..ops.quant import quantize_diffusion_modules

        ws = self.p2g_cfg.model_channels / 320.0
        done = quantize_diffusion_modules(
            self.p2g.unet, p2g_unet_layer_paths(self.p2g_cfg),
            weight_only=weight_only, bits=bits,
            min_conv_fan=max(64, int(512 * ws)),
            min_lin_dim=max(32, int(256 * ws)))
        self._completions.clear()
        return done

    def quantize_sam_int8(self, *, weight_only: bool = True,
                          bits: int = 8) -> dict:
        """Opt-in int8 for SAM's encoder and decoder linears and convs, in
        place (JAX `MaskHeuristics.quantize_sam_int8`): the JAX rule's sites
        with the decoder's transposed upscaling convs skipped. It shrinks a
        serving state's SAM bytes; SAM runs once a call. Returns {module
        name: scheme}."""
        from ..convert.weights import sam_layer_paths
        from ..ops.quant import quantize_diffusion_modules

        return quantize_diffusion_modules(
            self.sam, sam_layer_paths(self.sam_cfg), weight_only=weight_only,
            bits=bits, skip_suffixes=("upscale_conv1", "upscale_conv2"))

    # ------------------------------------------------------------ serving

    def save_serving(self, path: str) -> None:
        """Persist the ready-to-serve stack in the JAX package's serving
        format (kind "mask_heuristics"): the modules in their compute dtype
        and an RMBG hook made by `make_rmbg_matting_fn` (float32)."""
        from ..convert.weights import (p2g_params_to_jax, rmbg_params_to_jax,
                                       sam_params_to_jax)
        from ..pipeline.serving_ckpt import dtype_name, save_serving_state

        trees = {
            "sam": sam_params_to_jax(self.sam.state_dict(), self.sam_cfg,
                                     tensors=True),
            "p2g": p2g_params_to_jax(self.p2g.state_dict(), self.p2g.cfg,
                                     self.clip_cfg, self.vae_cfg,
                                     tensors=True),
        }
        meta = {
            "kind": "mask_heuristics",
            "sam_cfg": dataclasses.asdict(self.sam_cfg),
            "p2g_cfg": dataclasses.asdict(self.p2g_cfg),
            "clip_cfg": dataclasses.asdict(self.clip_cfg),
            "vae_cfg": dataclasses.asdict(self.vae_cfg),
            "max_points": self.max_points,
            "compute_dtype": dtype_name(self.compute_dtype),
        }
        rmbg = getattr(self.matting_fn, "rmbg_model", None)
        if self.matting_fn is not None and rmbg is None:
            # silently dropping a custom hook would make the restored stack
            # fall back to threshold matting
            raise ValueError(
                "matting_fn is not persistable (only make_rmbg_matting_fn "
                "hooks serialise); set matting_fn = None before "
                "save_serving and attach it again after load_serving")
        if rmbg is not None:
            fn = self.matting_fn
            trees["rmbg"] = rmbg_params_to_jax(rmbg.state_dict(), rmbg.cfg,
                                               tensors=True)
            meta.update(rmbg_cfg=dataclasses.asdict(rmbg.cfg),
                        rmbg_input_size=fn.rmbg_input_size,
                        rmbg_threshold=fn.rmbg_threshold)
        save_serving_state(path, trees, meta)

    @classmethod
    def load_serving(cls, path: str, *, device="cuda") -> "MaskHeuristics":
        """Restore a stack saved by `save_serving` of either package on
        `device`, every leaf in its saved dtype: quantised layers come back
        as `ops.quant` modules with their int8 codes and float32 scales (no
        re-quantisation)."""
        from ..convert.weights import (p2g_params_from_jax,
                                       rmbg_params_from_jax,
                                       sam_params_from_jax)
        from ..ops.quant import apply_quantized_
        from ..pipeline.serving_ckpt import (cfg_from_dict,
                                             restore_serving_state)

        trees, meta = restore_serving_state(
            path, expect_kind="mask_heuristics", device=device)
        sam_cfg = cfg_from_dict(SAMConfig, meta["sam_cfg"])
        p2g_cfg = cfg_from_dict(Pix2GestaltConfig, meta["p2g_cfg"])
        clip_cfg = cfg_from_dict(CLIPVisionConfig, meta["clip_cfg"])
        vae_cfg = cfg_from_dict(VAEConfig, meta["vae_cfg"])
        with torch.device("meta"):
            sam = SAM(sam_cfg)
            cc = trees["p2g"].get("cc_projection")
            p2g = Pix2Gestalt(p2g_cfg, clip_cfg, vae_cfg,
                              cc_in=0 if cc is None else cc["w"].shape[0],
                              cc_bias=cc is not None and "b" in cc)
        sam_sd = sam_params_from_jax(trees["sam"], sam_cfg)
        p2g_sd = p2g_params_from_jax(trees["p2g"], p2g_cfg, clip_cfg,
                                     vae_cfg)
        apply_quantized_(sam, sam_sd)
        apply_quantized_(p2g, p2g_sd)
        sam.load_state_dict(sam_sd, strict=True, assign=True)
        p2g.load_state_dict(p2g_sd, strict=True, assign=True)
        matting_fn = None
        if "rmbg" in trees:
            rmbg_cfg = cfg_from_dict(RMBGConfig, meta["rmbg_cfg"])
            with torch.device("meta"):
                rmbg = ISNet(rmbg_cfg)
            rmbg.load_state_dict(rmbg_params_from_jax(trees["rmbg"],
                                                      rmbg_cfg),
                                 strict=True, assign=True)
            matting_fn = make_rmbg_matting_fn(
                rmbg, input_size=int(meta["rmbg_input_size"]),
                threshold=float(meta["rmbg_threshold"]))
        return cls(sam, p2g, matting_fn=matting_fn,
                   max_points=int(meta["max_points"]))
