"""Checkpoints for the port: reference-layout state dicts and the JAX bridge.

The port's modules are named so that their `state_dict()` keys are exactly
the reference checkpoints' keys (HF `Zhyever/Amodal-Depth-Anything-DAV2`
`model.safetensors` under "encoder.", the raw base `.pth` with bare keys),
so loading a released checkpoint is a strict `load_state_dict`.

`params_from_jax` turns the JAX package's parameter pytree (numpy leaves:
blocks stacked [L, ...], linear weights [in, out], conv weights HWIO,
transposed-conv weights [C_in, k, k, C_out]) into that state dict; with
`load_params_npz` it reads the in-repo trained proxies
(`checkpoints/proxy/*.npz`, flat "/"-joined keys). `params_to_jax` is its
inverse, for parameters or for gradients under the parameters' names, so a
train step of the port can be held against the JAX package's leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.amodal_dav2 import DAV2Config

__all__ = ["load_state_dict", "infer_dav2_config", "params_from_jax",
           "params_to_jax", "load_params_npz"]


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


# torch layout <- JAX layout, per kind of leaf, and back
_TO_TORCH = {"same": lambda a: a,
             "linear": lambda a: a.T,                        # [in,out] -> [out,in]
             "conv": lambda a: a.transpose(3, 2, 0, 1),      # HWIO -> OIHW
             "convt": lambda a: a.transpose(0, 3, 1, 2)}     # [Ci,k,k,Co] -> [Ci,Co,k,k]
_TO_JAX = {"same": lambda a: a,
           "linear": lambda a: a.T,
           "conv": lambda a: a.transpose(2, 3, 1, 0),
           "convt": lambda a: a.transpose(0, 2, 3, 1)}


def _leaf_map(cfg: DAV2Config):
    """Every parameter of `cfg`'s model as (state-dict key, path in the JAX
    tree, kind of leaf, block index or None). Block leaves are stacked
    [L, ...] in the JAX tree, so they carry their layer index."""
    out = []

    def lin(name, path, layer=None, bias=True):
        out.append((f"{name}.weight", path + ("w",), "linear", layer))
        if bias:
            out.append((f"{name}.bias", path + ("b",), "same", layer))

    def conv(name, path, kind="conv", bias=True):
        out.append((f"{name}.weight", path + ("w",), kind, None))
        if bias:
            out.append((f"{name}.bias", path + ("b",), "same", None))

    def ln(name, path, layer=None):
        out.append((f"{name}.weight", path + ("scale",), "same", layer))
        out.append((f"{name}.bias", path + ("bias",), "same", layer))

    vit = cfg.vit
    prefix = "" if cfg.raw else "encoder."
    p, bb = f"{prefix}pretrained.", ("backbone",)
    for key in ("cls_token", "pos_embed", "mask_token"):
        out.append((f"{p}{key}", bb + (key,), "same", None))
    conv(f"{p}patch_embed.proj", bb + ("patch_embed", "proj"))
    if vit.guide_channels:
        conv(f"{p}patch_embed_guidance.proj",
             bb + ("patch_embed_guidance", "proj"))
    ln(f"{p}norm", bb + ("norm",))
    blk = bb + ("blocks",)
    ffn = ("fc1", "fc2") if vit.ffn == "mlp" else ("w12", "w3")
    for i in range(vit.depth):
        b = f"{p}blocks.{i}."
        ln(f"{b}norm1", blk + ("norm1",), i)
        lin(f"{b}attn.qkv", blk + ("attn", "qkv"), i)
        lin(f"{b}attn.proj", blk + ("attn", "proj"), i)
        out.append((f"{b}ls1.gamma", blk + ("ls1", "gamma"), "same", i))
        ln(f"{b}norm2", blk + ("norm2",), i)
        out.append((f"{b}ls2.gamma", blk + ("ls2", "gamma"), "same", i))
        for name in ffn:
            lin(f"{b}mlp.{name}", blk + ("mlp", name), i)

    hp, hd = f"{prefix}depth_head.", ("depth_head",)
    for i in range(4):
        conv(f"{hp}projects.{i}", hd + ("projects", str(i)))
    conv(f"{hp}resize_layers.0", hd + ("resize_layers", "0"), "convt")
    conv(f"{hp}resize_layers.1", hd + ("resize_layers", "1"), "convt")
    conv(f"{hp}resize_layers.3", hd + ("resize_layers", "3"))
    if cfg.dpt.use_input_projection:
        for i in range(4):
            ip = hd + ("input_projection", str(i))
            conv(f"{hp}input_projection.{i}.0", ip + ("conv",))
            ln(f"{hp}input_projection.{i}.1", ip + ("ln",))
    sc = hd + ("scratch",)
    for i in range(1, 5):
        conv(f"{hp}scratch.layer{i}_rn", sc + (f"layer{i}_rn",), bias=False)
        r, rr = sc + (f"refinenet{i}",), f"{hp}scratch.refinenet{i}."
        for unit in ("resConfUnit1", "resConfUnit2"):
            conv(f"{rr}{unit}.conv1", r + (unit, "conv1"))
            conv(f"{rr}{unit}.conv2", r + (unit, "conv2"))
        conv(f"{rr}out_conv", r + ("out_conv",))
    conv(f"{hp}scratch.output_conv1", sc + ("output_conv1",))
    conv(f"{hp}scratch.output_conv2.0", sc + ("output_conv2", "conv1"))
    conv(f"{hp}scratch.output_conv2.2", sc + ("output_conv2", "conv2"))
    return out


def params_from_jax(params: dict, cfg: DAV2Config) -> dict[str, torch.Tensor]:
    """JAX-layout parameter pytree (numpy leaves) -> the port's state dict
    for `cfg` ("encoder." keys for AmodalDAv2, bare keys for the raw base)."""
    sd = {}
    for key, path, kind, layer in _leaf_map(cfg):
        leaf = params
        for part in path:
            leaf = leaf[part]
        leaf = np.asarray(leaf)
        if layer is not None:
            leaf = leaf[layer]
        sd[key] = torch.from_numpy(np.ascontiguousarray(
            _TO_TORCH[kind](leaf), dtype=np.float32))
    return sd


def params_to_jax(sd: dict, cfg: DAV2Config) -> dict:
    """The inverse of `params_from_jax`: a {state-dict key: tensor} tree of
    the port (parameters, or gradients under the parameters' names) -> the
    JAX-layout pytree as float32 numpy arrays, blocks stacked [L, ...]."""
    tree: dict = {}
    stacks: dict[tuple, list] = {}
    for key, path, kind, layer in _leaf_map(cfg):
        leaf = _TO_JAX[kind](sd[key].detach().cpu().float().numpy())
        if layer is not None:
            stacks.setdefault(path, []).append(leaf)
            continue
        _set_path(tree, path, np.ascontiguousarray(leaf))
    for path, layers in stacks.items():
        _set_path(tree, path, np.stack(layers))
    return tree


def _set_path(tree: dict, path: tuple, leaf) -> None:
    *parents, last = path
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = leaf
