"""Checkpoints for the port: reference-layout state dicts and the JAX bridge.

The port's modules are named so that their `state_dict()` keys are exactly
the reference checkpoints' keys (HF `Zhyever/Amodal-Depth-Anything-DAV2`
`model.safetensors` under "encoder.", the raw base `.pth` with bare keys),
so loading a released checkpoint is a strict `load_state_dict`.

`params_from_jax` turns the JAX package's parameter pytree (numpy leaves:
blocks stacked [L, ...], linear weights [in, out], conv weights HWIO,
transposed-conv weights [C_in, k, k, C_out]) into that state dict; with
`load_params_npz` it reads the in-repo trained proxies
(`checkpoints/proxy/*.npz`, flat "/"-joined keys).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.amodal_dav2 import DAV2Config

__all__ = ["load_state_dict", "infer_dav2_config", "params_from_jax",
           "load_params_npz"]


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint as {key: tensor} (.pth or .safetensors)."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def infer_dav2_config(sd: dict, *, raw: bool | None = None,
                      guide_type: str | None = None,
                      loss_strategy: str = "entire_target_object"
                      ) -> DAV2Config:
    """Guess encoder size, rawness and guide type from state-dict shapes."""
    prefix = "encoder." if any(k.startswith("encoder.") for k in sd) else ""
    embed_dim = sd[f"{prefix}pretrained.cls_token"].shape[-1]
    by_width = {64: "vitt", 384: "vits", 768: "vitb", 1024: "vitl",
                1536: "vitg"}
    width_override = None
    if embed_dim in by_width:
        encoder = by_width[embed_dim]
    else:
        # a narrow variant of a named architecture: pick the encoder by
        # depth and ffn flavour, carry the width as an override
        bp = f"{prefix}pretrained.blocks."
        depth = 1 + max(int(k[len(bp):].split(".")[0]) for k in sd
                        if k.startswith(bp))
        swiglu = any(".mlp.w12." in k or ".mlp.w3." in k for k in sd)
        by_arch = {(12, False): "vits", (24, False): "vitl",
                   (40, True): "vitg", (4, False): "vitt"}
        if (depth, swiglu) not in by_arch:
            raise ValueError(
                f"cannot infer encoder for nonstandard width {embed_dim} "
                f"with depth {depth} / swiglu={swiglu}; construct a "
                f"DAV2Config explicitly")
        encoder = by_arch[(depth, swiglu)]
        width_override = embed_dim
    if raw is None:
        raw = not any("patch_embed_guidance" in k for k in sd)
    if not raw and guide_type is None:
        gc = sd[f"{prefix}pretrained.patch_embed_guidance.proj.weight"].shape[1]
        guide_type = {2: "mask+observation", 1: "mask", 4: "image+mask",
                      5: "image+mask+observation"}[gc]
    return DAV2Config(encoder=encoder, guide_type=guide_type or "none",
                      loss_strategy=loss_strategy, raw=raw,
                      embed_dim=width_override)


def load_params_npz(path: str) -> dict:
    """A flat "/"-keyed .npz (the JAX package's proxy format) as a nested
    dict of float32 numpy arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            val = z[key]
            if np.issubdtype(val.dtype, np.floating):
                val = val.astype(np.float32)
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return tree


def params_from_jax(params: dict, cfg: DAV2Config) -> dict[str, torch.Tensor]:
    """JAX-layout parameter pytree (numpy leaves) -> the port's state dict
    for `cfg` ("encoder." keys for AmodalDAv2, bare keys for the raw base)."""
    sd: dict[str, np.ndarray] = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def conv(name, p):  # HWIO -> OIHW
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def convt(name, p):  # [C_in, k, k, C_out] -> [C_in, C_out, k, k]
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(0, 3, 1, 2)
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def ln(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    prefix = "" if cfg.raw else "encoder."
    bb, p = params["backbone"], f"{prefix}pretrained."
    for key in ("cls_token", "pos_embed", "mask_token"):
        sd[f"{p}{key}"] = np.asarray(bb[key])
    conv(f"{p}patch_embed.proj", bb["patch_embed"]["proj"])
    if "patch_embed_guidance" in bb:
        conv(f"{p}patch_embed_guidance.proj",
             bb["patch_embed_guidance"]["proj"])
    ln(f"{p}norm", bb["norm"])
    blocks = bb["blocks"]
    for i in range(cfg.vit.depth):
        blk = _layer(blocks, i)
        b = f"{p}blocks.{i}."
        ln(f"{b}norm1", blk["norm1"])
        lin(f"{b}attn.qkv", blk["attn"]["qkv"])
        lin(f"{b}attn.proj", blk["attn"]["proj"])
        sd[f"{b}ls1.gamma"] = blk["ls1"]["gamma"]
        ln(f"{b}norm2", blk["norm2"])
        sd[f"{b}ls2.gamma"] = blk["ls2"]["gamma"]
        for name, sub in blk["mlp"].items():  # fc1/fc2 or w12/w3
            lin(f"{b}mlp.{name}", sub)

    hd, hp = params["depth_head"], f"{prefix}depth_head."
    for i in range(4):
        conv(f"{hp}projects.{i}", hd["projects"][str(i)])
    convt(f"{hp}resize_layers.0", hd["resize_layers"]["0"])
    convt(f"{hp}resize_layers.1", hd["resize_layers"]["1"])
    conv(f"{hp}resize_layers.3", hd["resize_layers"]["3"])
    if "input_projection" in hd:
        for i in range(4):
            ip = hd["input_projection"][str(i)]
            conv(f"{hp}input_projection.{i}.0", ip["conv"])
            ln(f"{hp}input_projection.{i}.1", ip["ln"])
    sc = hd["scratch"]
    for i in range(1, 5):
        conv(f"{hp}scratch.layer{i}_rn", sc[f"layer{i}_rn"])
        r, rr = sc[f"refinenet{i}"], f"{hp}scratch.refinenet{i}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            conv(f"{rr}{unit}.conv1", r[unit]["conv1"])
            conv(f"{rr}{unit}.conv2", r[unit]["conv2"])
        conv(f"{rr}out_conv", r["out_conv"])
    conv(f"{hp}scratch.output_conv1", sc["output_conv1"])
    conv(f"{hp}scratch.output_conv2.0", sc["output_conv2"]["conv1"])
    conv(f"{hp}scratch.output_conv2.2", sc["output_conv2"]["conv2"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


def _layer(tree, i: int):
    """Layer i of a stacked-[L, ...] block tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
