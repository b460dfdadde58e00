"""The heuristics stack's reference checkpoints, as the port's state dicts.

The port's own counterparts of the JAX package's `convert/sam_convert.py`,
`rmbg_convert.py` and `heuristics_convert.py`. The port's modules carry the
reference key names (`models.sam`, `models.clip_vit`, `models.rmbg`, the
LDM UNet), so each of these only picks, renames or folds what the file on
disk holds:

  * `sam_state_dict`: `sam_vit_h.pth` without the mask-prompt downscaling
    convolutions (point prompts only);
  * `clip_state_dict`: the HF `CLIPVisionModelWithProjection` keys, without
    the `position_ids` buffer;
  * `fold_rmbg_batchnorm`: briaai/RMBG-1.4 with each eval-mode BatchNorm
    folded to scale = gamma / sqrt(var + 1e-5), shift = beta - mean *
    scale, in float32 as the JAX package folds it;
  * `p2g_cfg_from_ckpt` and `pix2gestalt_unet_state_dict`: the pix2gestalt
    LDM checkpoint (`epoch=000005.ckpt`): its conditioning layout from
    conv-in's width (8: "image", 12: "image+mask"), its UNet width and
    context width, whether it has the zero123-style `cc_projection`, and
    the UNet under `model.diffusion_model.` with the prefix stripped.

Inputs are {key: tensor or numpy array}; outputs {key: tensor}, each in
its dtype (the folded BatchNorm in float32).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sam_state_dict", "clip_state_dict", "fold_rmbg_batchnorm",
           "p2g_cfg_from_ckpt", "pix2gestalt_unet_state_dict", "BN_EPS"]

BN_EPS = 1e-5
_DM = "model.diffusion_model."


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v


def sam_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """`segment_anything` SAM weights for `models.sam.SAM` (strict load)."""
    return {k: _tensor(v) for k, v in sd.items()
            if not k.startswith("prompt_encoder.mask_downscaling.")}


def clip_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """HF CLIP vision weights for `models.clip_vit.
    CLIPVisionModelWithProjection` (strict load)."""
    keep = ("vision_model.", "visual_projection.weight")
    return {k: _tensor(v) for k, v in sd.items()
            if k.startswith(keep) and not k.endswith("position_ids")}


def fold_rmbg_batchnorm(sd: dict) -> dict[str, torch.Tensor]:
    """briaai/RMBG-1.4 weights for `models.rmbg.ISNet` (strict load): every
    `<name>.bn_s1.{weight,bias,running_mean,running_var}` becomes
    `<name>.bn_s1.{scale,shift}`."""
    out, bns = {}, {}
    for k, v in sd.items():
        head, sep, tail = k.rpartition(".bn_s1.")
        if sep:
            bns.setdefault(head, {})[tail] = np.asarray(
                v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
        else:
            out[k] = _tensor(v)
    for head, bn in bns.items():
        scale = (bn["weight"] / np.sqrt(bn["running_var"] + BN_EPS)).astype(
            np.float32)
        out[f"{head}.bn_s1.scale"] = torch.from_numpy(scale)
        out[f"{head}.bn_s1.shift"] = torch.from_numpy(
            (bn["bias"] - bn["running_mean"] * scale).astype(np.float32))
    return out


def pix2gestalt_unet_state_dict(ckpt_sd: dict) -> dict[str, torch.Tensor]:
    """The UNet of a pix2gestalt LDM `state_dict` (keys under
    `model.diffusion_model.`, or already without it) for `models.unet_ldm.
    UNetModel`."""
    sd = {k[len(_DM):]: _tensor(v) for k, v in ckpt_sd.items()
          if k.startswith(_DM)}
    return sd or {k: _tensor(v) for k, v in ckpt_sd.items()
                  if not k.startswith("cc_projection.")}


def p2g_cfg_from_ckpt(ckpt_sd: dict):
    """(Pix2GestaltConfig, cc_projection {"weight"[, "bias"]} or None) read
    off a pix2gestalt LDM `state_dict`: conv-in's input width gives the
    conditioning layout (8: "image", 12: "image+mask"), its output width the
    UNet width; the cross-attention keys' width the context width."""
    from ..models.pix2gestalt import Pix2GestaltConfig

    sd = pix2gestalt_unet_state_dict(ckpt_sd)
    conv_in = sd["input_blocks.0.0.weight"]            # [C_out, C_in, 3, 3]
    in_ch = int(conv_in.shape[1])
    if in_ch not in (8, 12):
        raise ValueError(f"unexpected pix2gestalt conv-in channels {in_ch} "
                         f"(expected 8 or 12)")
    to_k = sd["input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"]
    cfg = Pix2GestaltConfig(
        cond_mode="image+mask" if in_ch == 12 else "image",
        model_channels=int(conv_in.shape[0]), context_dim=int(to_k.shape[1]))
    cc = None
    if "cc_projection.weight" in ckpt_sd:
        cc = {"weight": _tensor(ckpt_sd["cc_projection.weight"])}
        if "cc_projection.bias" in ckpt_sd:
            cc["bias"] = _tensor(ckpt_sd["cc_projection.bias"])
    return cfg, cc
