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

The DepthFM family has the same pair (`depthfm_params_from_jax`,
`depthfm_params_to_jax`: the UNet under "unet.", the VAE under "vae.", the
empty-text embedding), `load_depthfm_proxy` for the in-repo trained proxy
(`checkpoints/proxy/depthfm.npz` with the overrides of `depthfm_meta.json`),
and `load_depthfm_checkpoints` for the reference artifacts: the
`depthfm-v1.ckpt` layout (LDM UNet state dict, hparams, noising step,
empty-text embedding; conv-in widened with zeros for the guidance channels)
and a diffusers `AutoencoderKL` state dict whose topology is read off its
keys.

The heuristics stack has the same pairs (`sam_params_from_jax` /
`_to_jax`, `clip_params_*`, `rmbg_params_*`, `p2g_params_*`: the JAX trees
of `models/{sam,clip_vit,rmbg}.py` and the pix2gestalt tree {"unet",
"vae", "clip", "uncond_ctx"[, "cc_projection"]}) and `load_p2g_proxy` for
`checkpoints/proxy/p2g.npz`; the reference checkpoints are read by
`convert/heuristics.py`.

Quantised layers (`ops.quant`: W8A8, w8, w4, SmoothQuant) cross the bridge
leaf for leaf in both directions under their JAX leaf names (`w` int8,
`w_scale`, `act_scale`, `smooth`, `use_q`, `w_orig`, `w8`, `w4`,
`w4_scale`, `w4_group`); `dav2_layer_paths` / `depthfm_layer_paths` /
`sam_layer_paths` / `p2g_unet_layer_paths` name each layer's JAX tree path,
by which the JAX quantisers pick their sites.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.amodal_dav2 import DAV2Config
from ..models.depthfm import DepthFM, DepthFMConfig, build_depthfm
from ..models.unet_ldm import UNetConfig, build_plan

__all__ = ["load_state_dict", "infer_dav2_config", "params_from_jax",
           "params_to_jax", "load_params_npz", "jax_param_layout",
           "dav2_layer_paths",
           "depthfm_layer_paths", "depthfm_params_from_jax",
           "sam_layer_paths", "p2g_unet_layer_paths",
           "depthfm_params_to_jax", "load_depthfm_proxy",
           "load_depthfm_checkpoints", "sam_params_from_jax",
           "sam_params_to_jax", "clip_params_from_jax", "clip_params_to_jax",
           "rmbg_params_from_jax", "rmbg_params_to_jax",
           "p2g_params_from_jax", "p2g_params_to_jax", "load_p2g_proxy"]


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference checkpoint as {key: tensor} (.pth, or .safetensors read
    by the port's own reader, `convert/safetensors.py`)."""
    if str(path).endswith(".safetensors"):
        from .safetensors import load_file
        return load_file(path)
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


# torch layout <- JAX layout, per kind of leaf, as dimension orders (None:
# as it is); the way back is the inverse order
_TO_TORCH = {"same": None,
             "row": None,               # a table's row, kept [1, D]
             "linear": (1, 0),          # [in,out] -> [out,in]
             "conv": (3, 2, 0, 1),      # HWIO -> OIHW
             "convt": (0, 3, 1, 2)}     # [Ci,k,k,Co] -> [Ci,Co,k,k]
_TO_JAX = {kind: None if dims is None else tuple(int(i) for i in
                                                   np.argsort(dims))
           for kind, dims in _TO_TORCH.items()}


def _permuted(leaf, dims, layer=None) -> torch.Tensor:
    """`leaf` (numpy array or tensor; block `layer` of a stack) in the
    dimension order `dims`, in a fresh contiguous allocation of its own
    dtype and device."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.asarray(leaf))
    if layer is not None:
        leaf = leaf[layer]
    if dims is not None:
        leaf = leaf.permute(*dims)
    return leaf.detach().clone(memory_format=torch.contiguous_format)


def _jax_out(leaf: torch.Tensor, tensors: bool):
    """A JAX-layout leaf as the `*_to_jax` functions return it: float32
    numpy (an integer or bool leaf keeps its dtype), or with `tensors` the
    tensor itself (a bfloat16 leaf has no numpy dtype)."""
    if tensors:
        return leaf
    leaf = leaf.cpu()
    return (leaf.float() if leaf.is_floating_point() else leaf).numpy()


# The leaves of a quantised layer (`ops.quant`): the port's buffer name ->
# (the JAX leaf, its kind of layout; None: the layer's weight kind). W8A8:
# `w` int8, `w_scale`, `act_scale`, `smooth`, `use_q`, `w_orig`; w8: `w8`,
# `w_scale`; w4: `w4` (packed), `w4_scale` ([in/g, out] in JAX, [out,
# in/g] here), `w4_group`; a SmoothQuant-migrated float weight adds
# `smooth`. A stacked trunk's leaves are sliced per block like the rest.
_QUANT_LEAVES = {"weight": ("w", None), "w_scale": ("w_scale", "same"),
                 "act_scale": ("act_scale", "same"),
                 "smooth": ("smooth", "same"), "use_q": ("use_q", "same"),
                 "w_orig": ("w_orig", None), "w8": ("w8", None),
                 "w4": ("w4", None), "w4_scale": ("w4_scale", "linear"),
                 "w4_group": ("w4_group", "same")}
_WEIGHT_KINDS = ("linear", "conv", "convt")


def _expand_quant(entries: list, has) -> list:
    """`entries` of a leaf map with each quantised layer's weight entry
    replaced by the entries of the leaves it holds. `has(key, path)` says
    whether the source holds the leaf of state-dict `key` at JAX `path`."""
    out = []
    for key, path, kind, *rest in entries:
        if kind in _WEIGHT_KINDS and key.endswith(".weight"):
            name, parent = key[:-len(".weight")], path[:-1]
            held = [(f"{name}.{s}", parent + (jl,), k or kind)
                    for s, (jl, k) in _QUANT_LEAVES.items()
                    if has(f"{name}.{s}", parent + (jl,))]
            # a layer whose weight sits under another JAX name is left as
            # it is (the baselines' renamed leaves)
            if held and [h[0] for h in held] != [key]:
                out += [(k, p, kd, *rest) for k, p, kd in held]
                continue
        out.append((key, path, kind, *rest))
    return out


def _layer_paths(entries: list) -> dict:
    """{module name: "/"-joined JAX path of its parameter container} for
    every linear and conv of a leaf map."""
    return {key[:-len(".weight")]: "/".join(path[:-1])
            for key, path, kind, *_ in entries
            if kind in _WEIGHT_KINDS and key.endswith(".weight")}


def dav2_layer_paths(cfg: DAV2Config) -> dict:
    """Every linear and conv of `cfg`'s model: {state-dict module name:
    JAX tree path}, the names the JAX package's quantisers choose sites by
    (`ops.quant.quantize_diffusion_modules`)."""
    return _layer_paths(_leaf_map(cfg))


def depthfm_layer_paths(cfg: DepthFMConfig) -> dict:
    """`dav2_layer_paths` of a DepthFM model ("unet/...", "vae/...")."""
    return _layer_paths(_depthfm_leaf_map(cfg))


def _in_tree(tree: dict):
    def has(_key, path):
        node = tree
        for part in path:
            if not isinstance(node, dict) or part not in node:
                return False
            node = node[part]
        return True
    return has


def _in_sd(sd: dict):
    return lambda key, _path: key in sd


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
    """JAX-layout parameter pytree (numpy or tensor leaves) -> the port's
    state dict for `cfg` ("encoder." keys for AmodalDAv2, bare keys for the
    raw base); each leaf keeps its dtype and device."""
    sd = {}
    for key, path, kind, layer in _expand_quant(_leaf_map(cfg),
                                                _in_tree(params)):
        leaf = params
        for part in path:
            leaf = leaf[part]
        sd[key] = _permuted(leaf, _TO_TORCH[kind], layer)
    return sd


def params_to_jax(sd: dict, cfg: DAV2Config, *, tensors: bool = False) -> dict:
    """The inverse of `params_from_jax`: a {state-dict key: tensor} tree of
    the port (parameters, or gradients under the parameters' names) -> the
    JAX-layout pytree as float32 numpy arrays, blocks stacked [L, ...]; with
    `tensors`, as tensors of the state dict's dtypes and device."""
    tree: dict = {}
    stacks: dict[tuple, list] = {}
    for key, path, kind, layer in _expand_quant(_leaf_map(cfg), _in_sd(sd)):
        leaf = _permuted(sd[key], _TO_JAX[kind])
        if layer is not None:
            stacks.setdefault(path, []).append(leaf)
            continue
        _set_path(tree, path, _jax_out(leaf, tensors))
    for path, layers in stacks.items():
        _set_path(tree, path, _jax_out(torch.stack(layers), tensors))
    return tree


def jax_param_layout(model: torch.nn.Module) -> dict[str, tuple]:
    """{state-dict key: (dims, stack)} of `model`, as the JAX package lays
    the same parameter out: `dims` the dimension order that takes the
    port's tensor to the JAX leaf's layout (None: the same), `stack` the
    JAX path of the stacked leaf the tensor is one block of (None: a leaf
    of its own). The DAV2 family from its leaf map, PartialCompletion-
    ContentDPT from its bridge entries, any other model by the kind of each
    module (linear, conv, transposed conv). `train.state.Adafactor` factors
    and normalises per JAX leaf by it."""
    cfg = getattr(model, "cfg", None)
    if isinstance(cfg, DAV2Config):
        entries = _leaf_map(cfg)
    else:
        from ..models.jo_dpt import JoDPT
        kw = _baseline_spec("PartialCompletionContentDPT", cfg)[1] \
            if isinstance(model, JoDPT) else {}
        entries = [e[:4] for e in _baseline_entries(model, **kw)]
    return {key: (_TO_JAX[kind], path if layer is not None else None)
            for key, path, kind, layer in entries}


def _set_path(tree: dict, path: tuple, leaf) -> None:
    *parents, last = path
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = leaf


# ------------------------------------------------------------------ DepthFM

def _unet_leaf_map(cfg: UNetConfig, prefix: str, root: tuple) -> list:
    """(state-dict key, path in the JAX tree, kind) for every parameter of
    the LDM UNet, walking the plan both packages build it from."""
    out = []

    def lin(name, path, bias=True):
        out.append((f"{prefix}{name}.weight", root + path + ("w",), "linear"))
        if bias:
            out.append((f"{prefix}{name}.bias", root + path + ("b",), "same"))

    def conv(name, path):
        out.append((f"{prefix}{name}.weight", root + path + ("w",), "conv"))
        out.append((f"{prefix}{name}.bias", root + path + ("b",), "same"))

    def norm(name, path):
        out.append((f"{prefix}{name}.weight", root + path + ("scale",), "same"))
        out.append((f"{prefix}{name}.bias", root + path + ("bias",), "same"))

    def layer(kind, meta, name, path):
        if kind == "conv_in":
            conv(name, path)
        elif kind == "res":
            norm(f"{name}.in_layers.0", path + ("norm1",))
            conv(f"{name}.in_layers.2", path + ("conv1",))
            lin(f"{name}.emb_layers.1", path + ("emb",))
            norm(f"{name}.out_layers.0", path + ("norm2",))
            conv(f"{name}.out_layers.3", path + ("conv2",))
            if meta["in"] != meta["out"]:
                conv(f"{name}.skip_connection", path + ("skip",))
        elif kind == "attn":
            norm(f"{name}.norm", path + ("norm",))
            proj = lin if cfg.use_linear_in_transformer else conv
            proj(f"{name}.proj_in", path + ("proj_in",))
            proj(f"{name}.proj_out", path + ("proj_out",))
            for d in range(cfg.transformer_depth):
                b = f"{name}.transformer_blocks.{d}"
                bp = path + ("transformer_blocks", str(d))
                for attn in ("attn1", "attn2"):
                    for part in ("to_q", "to_k", "to_v"):
                        lin(f"{b}.{attn}.{part}", bp + (attn, part),
                            bias=False)
                    lin(f"{b}.{attn}.to_out.0", bp + (attn, "to_out"))
                lin(f"{b}.ff.net.0.proj", bp + ("ff", "geglu"))
                lin(f"{b}.ff.net.2", bp + ("ff", "out"))
                for n in ("norm1", "norm2", "norm3"):
                    norm(f"{b}.{n}", bp + (n,))
        elif kind == "down":
            conv(f"{name}.op", path)
        elif kind == "up":
            conv(f"{name}.conv", path)
        else:
            raise ValueError(kind)

    lin("time_embed.0", ("time_embed", "fc1"))
    lin("time_embed.2", ("time_embed", "fc2"))
    inp, mid, outp = build_plan(cfg)
    for i, layers in enumerate(inp):
        for j, (kind, meta) in enumerate(layers):
            layer(kind, meta, f"input_blocks.{i}.{j}",
                  ("input_blocks", str(i), str(j)))
    for j, (kind, meta) in enumerate(mid):
        layer(kind, meta, f"middle_block.{j}", ("middle_block", str(j)))
    for i, layers in enumerate(outp):
        for j, (kind, meta) in enumerate(layers):
            layer(kind, meta, f"output_blocks.{i}.{j}",
                  ("output_blocks", str(i), str(j)))
    norm("out.0", ("out", "norm"))
    conv("out.2", ("out", "conv"))
    return out


def _vae_leaf_map(cfg, prefix: str, root: tuple) -> list:
    """The same for the SD VAE, in the diffusers key layout."""
    out = []

    def lin(name, path):
        out.append((f"{prefix}{name}.weight", root + path + ("w",), "linear"))
        out.append((f"{prefix}{name}.bias", root + path + ("b",), "same"))

    def conv(name, path):
        out.append((f"{prefix}{name}.weight", root + path + ("w",), "conv"))
        out.append((f"{prefix}{name}.bias", root + path + ("b",), "same"))

    def norm(name, path):
        out.append((f"{prefix}{name}.weight", root + path + ("scale",), "same"))
        out.append((f"{prefix}{name}.bias", root + path + ("bias",), "same"))

    def resnet(name, path, c_in, c_out):
        norm(f"{name}.norm1", path + ("norm1",))
        conv(f"{name}.conv1", path + ("conv1",))
        norm(f"{name}.norm2", path + ("norm2",))
        conv(f"{name}.conv2", path + ("conv2",))
        if c_in != c_out:
            conv(f"{name}.conv_shortcut", path + ("conv_shortcut",))

    def mid(name, path, ch):
        resnet(f"{name}.resnets.0", path + ("resnets", "0"), ch, ch)
        resnet(f"{name}.resnets.1", path + ("resnets", "1"), ch, ch)
        a, ap = f"{name}.attentions.0", path + ("attentions", "0")
        norm(f"{a}.group_norm", ap + ("group_norm",))
        for part in ("to_q", "to_k", "to_v"):
            lin(f"{a}.{part}", ap + (part,))
        lin(f"{a}.to_out.0", ap + ("to_out",))

    chans = list(cfg.block_out_channels)
    last = len(chans) - 1
    conv("encoder.conv_in", ("encoder", "conv_in"))
    ch = chans[0]
    for i, c_out in enumerate(chans):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                   ("encoder", "down_blocks", str(i), "resnets", str(j)),
                   ch if j == 0 else c_out, c_out)
        ch = c_out
        if i != last:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                 ("encoder", "down_blocks", str(i), "downsampler"))
    mid("encoder.mid_block", ("encoder", "mid_block"), ch)
    norm("encoder.conv_norm_out", ("encoder", "conv_norm_out"))
    conv("encoder.conv_out", ("encoder", "conv_out"))

    conv("decoder.conv_in", ("decoder", "conv_in"))
    mid("decoder.mid_block", ("decoder", "mid_block"), chans[-1])
    ch = chans[-1]
    for i, c_out in enumerate(reversed(chans)):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                   ("decoder", "up_blocks", str(i), "resnets", str(j)),
                   ch if j == 0 else c_out, c_out)
        ch = c_out
        if i != last:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                 ("decoder", "up_blocks", str(i), "upsampler"))
    norm("decoder.conv_norm_out", ("decoder", "conv_norm_out"))
    conv("decoder.conv_out", ("decoder", "conv_out"))
    conv("quant_conv", ("quant_conv",))
    conv("post_quant_conv", ("post_quant_conv",))
    return out


def _depthfm_leaf_map(cfg: DepthFMConfig) -> list:
    return (_unet_leaf_map(cfg.unet, "unet.", ("unet",))
            + _vae_leaf_map(cfg.vae, "vae.", ("vae",))
            + [("empty_text_embed", ("empty_text_embed",), "same")])


def depthfm_params_from_jax(params: dict,
                            cfg: DepthFMConfig) -> dict[str, torch.Tensor]:
    """The JAX package's DepthFM parameter pytree (numpy or tensor leaves:
    linears [in, out], convs HWIO) -> the state dict of
    `models.depthfm.DepthFM`; each leaf keeps its dtype and device."""
    sd = {}
    for key, path, kind in _expand_quant(_depthfm_leaf_map(cfg),
                                         _in_tree(params)):
        leaf = params
        for part in path:
            leaf = leaf[part]
        sd[key] = _permuted(leaf, _TO_TORCH[kind])
    return sd


def depthfm_params_to_jax(sd: dict, cfg: DepthFMConfig, *,
                          tensors: bool = False) -> dict:
    """The inverse of `depthfm_params_from_jax`, as float32 numpy arrays
    (`tensors` as in `params_to_jax`)."""
    tree: dict = {}
    for key, path, kind in _expand_quant(_depthfm_leaf_map(cfg),
                                         _in_sd(sd)):
        _set_path(tree, path, _jax_out(_permuted(sd[key], _TO_JAX[kind]),
                                       tensors))
    return tree


def load_depthfm_proxy(npz_path: str, meta_path: str | None = None, *,
                       guide_type: str = "mask+observation",
                       device="cuda") -> DepthFM:
    """The trained in-repo DepthFM proxy as a module on `device`: the
    parameters of `npz_path` under the config overrides that the JSON next
    to it (`<name>_meta.json`) records."""
    import json

    if meta_path is None:
        meta_path = str(npz_path)[:-len(".npz")] + "_meta.json"
    with open(meta_path) as f:
        over = json.load(f)["overrides"]
    over = {k: tuple(v) if isinstance(v, list) else v for k, v in over.items()}
    cfg = DepthFMConfig(guide_type=guide_type, **over)
    model = build_depthfm(cfg, device=device)
    model.load_state_dict(
        depthfm_params_from_jax(load_params_npz(npz_path), cfg), strict=True)
    return model


def _depthfm_config_from_ckpt(ckpt: dict, guide_type: str) -> DepthFMConfig:
    """The config a `depthfm-v1.ckpt`-layout dict describes (its
    `ldm_hparams`, `noising_step` and empty-text embedding)."""
    hp = ckpt["ldm_hparams"]
    empty = torch.as_tensor(np.asarray(ckpt["empty_text_embedding"]))
    return DepthFMConfig(guide_type=guide_type,
                         noising_step=int(ckpt["noising_step"]),
                         context_dim=int(hp["context_dim"]),
                         context_len=int(empty.shape[-2]),
                         model_channels=int(hp["model_channels"]),
                         channel_mult=tuple(hp["channel_mult"]),
                         num_heads=int(hp["num_heads"]))


def _infer_vae_topology(vae_sd: dict) -> dict:
    """`vae_channels` and `vae_layers` read off a diffusers AutoencoderKL
    state dict's keys and shapes."""
    n_down = 1 + max(int(k.split(".")[2]) for k in vae_sd
                     if k.startswith("encoder.down_blocks."))
    layers = 1 + max(int(k.split(".")[4]) for k in vae_sd
                     if k.startswith("encoder.down_blocks.0.resnets."))
    chans = tuple(
        int(vae_sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"]
            .shape[0]) for i in range(n_down))
    return {"vae_channels": chans, "vae_layers": layers}


def load_depthfm_checkpoints(depthfm_ckpt, vae_ckpt, *,
                             guide_type: str = "mask+observation",
                             cfg_overrides: dict | None = None,
                             device="cuda") -> DepthFM:
    """A DepthFM module on `device` from the reference artifacts.

    `depthfm_ckpt`: a path to (or the loaded dict of) `depthfm-v1.ckpt`:
    `state_dict` (LDM UNet, reference keys), `ldm_hparams`, `noising_step`,
    `empty_text_embedding`. Its conv-in holds the 8 pretrained input
    channels; the `additional_dim` guidance channels are appended as zeros
    (reference dfm_amodal.py:70-83). `vae_ckpt`: a path to (or the state
    dict of) the diffusers SD-1.5 AutoencoderKL (.safetensors or .bin),
    which ships apart. `cfg_overrides` patches DepthFMConfig fields neither
    artifact carries."""
    import dataclasses

    ckpt = depthfm_ckpt
    if not isinstance(ckpt, dict):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=False)
    vae_sd = vae_ckpt if isinstance(vae_ckpt, dict) \
        else load_state_dict(vae_ckpt)
    vae_sd = {k: torch.as_tensor(np.asarray(v)) for k, v in vae_sd.items()}
    cfg = _depthfm_config_from_ckpt(ckpt, guide_type)
    cfg = dataclasses.replace(cfg, **{**_infer_vae_topology(vae_sd),
                                      **(cfg_overrides or {})})
    unet_sd = {k: torch.as_tensor(np.asarray(v)).float()
               for k, v in ckpt["state_dict"].items()}
    w = unet_sd["input_blocks.0.0.weight"]      # OIHW
    if cfg.additional_dim and w.shape[1] == 8:
        pad = w.new_zeros(w.shape[0], cfg.additional_dim, *w.shape[2:])
        unet_sd["input_blocks.0.0.weight"] = torch.cat([w, pad], dim=1)
    empty = torch.as_tensor(np.asarray(ckpt["empty_text_embedding"])).float()
    if empty.dim() == 2:
        empty = empty[None]
    model = build_depthfm(cfg, device=device)
    model.unet.load_state_dict(unet_sd, strict=True)
    model.vae.load_state_dict({k: v.float() for k, v in vae_sd.items()},
                              strict=True)
    with torch.no_grad():
        model.empty_text_embed.copy_(empty)
    return model


# ------------------------------------------------------------- heuristics
#
# Entries (state-dict key, path in the JAX tree, kind, index, part): `index`
# takes block `index` of a stacked JAX leaf (None: the leaf itself); `part`
# = (j, n) takes the j-th of n equal slices of the JAX leaf's last axis (the
# CLIP tower's fused qkv against HF's q/k/v projections); kind "row" is one
# row of a JAX table kept [1, D] on the torch side (SAM's point
# embeddings).

def _entries_lin(out, key, path, *, bias=True, index=None, part=None):
    out.append((f"{key}.weight", path + ("w",), "linear", index, part))
    if bias:
        out.append((f"{key}.bias", path + ("b",), "same", index, part))


def _entries_conv(out, key, path, *, kind="conv", bias=True):
    out.append((f"{key}.weight", path + ("w",), kind, None, None))
    if bias:
        out.append((f"{key}.bias", path + ("b",), "same", None, None))


def _entries_ln(out, key, path, index=None):
    out.append((f"{key}.weight", path + ("scale",), "same", index, None))
    out.append((f"{key}.bias", path + ("bias",), "same", index, None))


def _sam_entries(cfg) -> list:
    out = []
    e, ep = "image_encoder.", ("encoder",)
    _entries_conv(out, f"{e}patch_embed.proj", ep + ("patch_embed", "proj"))
    out.append((f"{e}pos_embed", ep + ("pos_embed",), "same", None, None))
    for i in range(cfg.depth):
        b, bp = f"{e}blocks.{i}.", ep + ("blocks", str(i))
        _entries_ln(out, f"{b}norm1", bp + ("norm1",))
        _entries_lin(out, f"{b}attn.qkv", bp + ("attn", "qkv"))
        _entries_lin(out, f"{b}attn.proj", bp + ("attn", "proj"))
        for axis in ("h", "w"):
            out.append((f"{b}attn.rel_pos_{axis}",
                        bp + ("attn", f"rel_pos_{axis}"), "same", None, None))
        _entries_ln(out, f"{b}norm2", bp + ("norm2",))
        _entries_lin(out, f"{b}mlp.lin1", bp + ("mlp", "fc1"))
        _entries_lin(out, f"{b}mlp.lin2", bp + ("mlp", "fc2"))
    neck = ep + ("neck",)
    _entries_conv(out, f"{e}neck.0", neck + ("conv1",), bias=False)
    _entries_ln(out, f"{e}neck.1", neck + ("ln1",))
    _entries_conv(out, f"{e}neck.2", neck + ("conv2",), bias=False)
    _entries_ln(out, f"{e}neck.3", neck + ("ln2",))

    p, pp = "prompt_encoder.", ("prompt",)
    out.append((f"{p}pe_layer.positional_encoding_gaussian_matrix",
                pp + ("pe_gaussian",), "same", None, None))
    for i in range(4):
        out.append((f"{p}point_embeddings.{i}.weight",
                    pp + ("point_embeddings",), "row", i, None))
    out.append((f"{p}not_a_point_embed.weight", pp + ("not_a_point",),
                "same", None, None))
    out.append((f"{p}no_mask_embed.weight", pp + ("no_mask",), "same", None,
                None))

    d, dp = "mask_decoder.", ("decoder",)
    out.append((f"{d}iou_token.weight", dp + ("iou_token",), "same", None,
                None))
    out.append((f"{d}mask_tokens.weight", dp + ("mask_tokens",), "same",
                None, None))

    def attn4(key, path):
        for name, jname in (("q_proj", "q"), ("k_proj", "k"),
                            ("v_proj", "v"), ("out_proj", "out")):
            _entries_lin(out, f"{key}.{name}", path + (jname,))

    t = f"{d}transformer."
    for i in range(cfg.decoder_layers):
        lk, lp = f"{t}layers.{i}.", dp + ("layers", str(i))
        attn4(f"{lk}self_attn", lp + ("self_attn",))
        attn4(f"{lk}cross_attn_token_to_image", lp + ("cross_t2i",))
        attn4(f"{lk}cross_attn_image_to_token", lp + ("cross_i2t",))
        for n in range(1, 5):
            _entries_ln(out, f"{lk}norm{n}", lp + (f"norm{n}",))
        _entries_lin(out, f"{lk}mlp.lin1", lp + ("mlp", "fc1"))
        _entries_lin(out, f"{lk}mlp.lin2", lp + ("mlp", "fc2"))
    attn4(f"{t}final_attn_token_to_image", dp + ("final_attn",))
    _entries_ln(out, f"{t}norm_final_attn", dp + ("norm_final",))
    _entries_conv(out, f"{d}output_upscaling.0", dp + ("upscale_conv1",),
                  kind="convt")
    _entries_ln(out, f"{d}output_upscaling.1", dp + ("upscale_ln",))
    _entries_conv(out, f"{d}output_upscaling.3", dp + ("upscale_conv2",),
                  kind="convt")
    for i in range(cfg.num_multimask + 1):
        for j in range(3):
            _entries_lin(out, f"{d}output_hypernetworks_mlps.{i}.layers.{j}",
                         dp + ("hyper_mlps", str(i), str(j)))
    for j in range(3):
        _entries_lin(out, f"{d}iou_prediction_head.layers.{j}",
                     dp + ("iou_head", str(j)))
    return out


def _clip_entries(cfg, prefix: str = "", root: tuple = ()) -> list:
    out = []
    v, e = f"{prefix}vision_model.", f"{prefix}vision_model.embeddings."
    out.append((f"{e}patch_embedding.weight", root + ("patch_embed", "w"),
                "conv", None, None))
    out.append((f"{e}class_embedding", root + ("class_embedding",), "same",
                None, None))
    out.append((f"{e}position_embedding.weight", root + ("pos_embed",),
                "same", None, None))
    _entries_ln(out, f"{v}pre_layrnorm", root + ("pre_ln",))
    blk = root + ("blocks",)
    for i in range(cfg.depth):
        b = f"{v}encoder.layers.{i}."
        _entries_ln(out, f"{b}layer_norm1", blk + ("ln1",), i)
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            _entries_lin(out, f"{b}self_attn.{name}", blk + ("attn", "qkv"),
                         index=i, part=(j, 3))
        _entries_lin(out, f"{b}self_attn.out_proj", blk + ("attn", "proj"),
                     index=i)
        _entries_ln(out, f"{b}layer_norm2", blk + ("ln2",), i)
        _entries_lin(out, f"{b}mlp.fc1", blk + ("mlp", "fc1"), index=i)
        _entries_lin(out, f"{b}mlp.fc2", blk + ("mlp", "fc2"), index=i)
    _entries_ln(out, f"{v}post_layernorm", root + ("post_ln",))
    out.append((f"{prefix}visual_projection.weight", root + ("proj", "w"),
                "linear", None, None))
    return out


def _rmbg_entries(cfg) -> list:
    out = []

    def rebn(key, path):
        _entries_conv(out, f"{key}.conv_s1", path)
        out.append((f"{key}.bn_s1.scale", path + ("bn_scale",), "same", None,
                    None))
        out.append((f"{key}.bn_s1.shift", path + ("bn_bias",), "same", None,
                    None))

    def rsu(key, path, height):
        rebn(f"{key}.rebnconvin", path + ("in",))
        for i in range(1, height + 1):
            rebn(f"{key}.rebnconv{i}", path + (f"enc{i}",))
        for i in range(height - 1, 0, -1):
            rebn(f"{key}.rebnconv{i}d", path + (f"dec{i}",))

    _entries_conv(out, "conv_in", ("conv_in",))
    for s in range(1, 7):
        rsu(f"stage{s}", (f"stage{s}",), cfg.heights[s - 1])
    for s in range(5, 0, -1):
        rsu(f"stage{s}d", (f"stage{s}d",), cfg.heights[s - 1])
    for i in range(1, 7):
        _entries_conv(out, f"side{i}", (f"side{i}",))
    return out


def _p2g_entries(cfg, clip_cfg, vae_cfg, cc_bias: bool | None) -> list:
    out = [(k, p, kind, None, None) for k, p, kind in
           _unet_leaf_map(cfg.unet, "unet.", ("unet",))
           + _vae_leaf_map(vae_cfg, "vae.", ("vae",))]
    out += _clip_entries(clip_cfg, "clip.", ("clip",))
    out.append(("uncond_ctx", ("uncond_ctx",), "same", None, None))
    if cc_bias is not None:
        _entries_lin(out, "cc_projection", ("cc_projection",), bias=cc_bias)
    return out


def _get_path(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _from_jax(tree: dict, entries: list) -> dict[str, torch.Tensor]:
    sd = {}
    for key, path, kind, index, part in _expand_quant(entries,
                                                      _in_tree(tree)):
        leaf = _get_path(tree, path)
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.asarray(leaf))
        if index is not None:
            leaf = leaf[index]
        if part is not None:
            j, n = part
            size = leaf.shape[-1] // n
            leaf = leaf[..., j * size:(j + 1) * size]
        if kind == "row":
            leaf = leaf[None]
        sd[key] = _permuted(leaf, _TO_TORCH[kind])
    return sd


def _to_jax(sd: dict, entries: list, tensors: bool) -> dict:
    # path -> {index: {part: leaf}}; parts join on the last axis, indices
    # stack on a new first one
    groups: dict[tuple, dict] = {}
    for key, path, kind, index, part in _expand_quant(entries, _in_sd(sd)):
        leaf = sd[key]
        leaf = leaf[0] if kind == "row" else _permuted(leaf, _TO_JAX[kind])
        groups.setdefault(path, {}).setdefault(index, {})[
            0 if part is None else part[0]] = leaf
    tree: dict = {}
    for path, by_index in groups.items():
        joined = {i: torch.cat([parts[j] for j in sorted(parts)], dim=-1)
                  if len(parts) > 1 else parts[0]
                  for i, parts in by_index.items()}
        leaf = (joined[None] if None in joined else
                torch.stack([joined[i] for i in sorted(joined)]))
        _set_path(tree, path, _jax_out(leaf, tensors))
    return tree


def sam_layer_paths(cfg) -> dict:
    """Every linear and conv of `models.sam.SAM`: {state-dict module name:
    JAX tree path}, by which `MaskHeuristics.quantize_sam_int8` picks the
    JAX package's sites."""
    return _layer_paths(_sam_entries(cfg))


def p2g_unet_layer_paths(cfg) -> dict:
    """`sam_layer_paths` of the pix2gestalt UNet (names under
    `Pix2Gestalt.unet`, paths in the JAX package's "unet" tree, which its
    `quantize_p2g_int8` walks)."""
    return _layer_paths(_unet_leaf_map(cfg.unet, "", ()))


def sam_params_from_jax(params: dict, cfg) -> dict[str, torch.Tensor]:
    """The JAX package's SAM tree (`models/sam.py::init_sam` layout, numpy
    or tensor leaves) -> the state dict of `models.sam.SAM`."""
    return _from_jax(params, _sam_entries(cfg))


def sam_params_to_jax(sd: dict, cfg, *, tensors: bool = False) -> dict:
    """The inverse of `sam_params_from_jax` (`tensors` as in
    `params_to_jax`)."""
    return _to_jax(sd, _sam_entries(cfg), tensors)


def clip_params_from_jax(params: dict, cfg) -> dict[str, torch.Tensor]:
    """The JAX package's CLIP vision tree (blocks stacked [L, ...], qkv
    fused) -> the state dict of `models.clip_vit.
    CLIPVisionModelWithProjection` (HF keys, q/k/v apart)."""
    return _from_jax(params, _clip_entries(cfg))


def clip_params_to_jax(sd: dict, cfg, *, tensors: bool = False) -> dict:
    return _to_jax(sd, _clip_entries(cfg), tensors)


def rmbg_params_from_jax(params: dict, cfg) -> dict[str, torch.Tensor]:
    """The JAX package's RMBG tree (BatchNorm folded into `bn_scale` /
    `bn_bias`) -> the state dict of `models.rmbg.ISNet`."""
    return _from_jax(params, _rmbg_entries(cfg))


def rmbg_params_to_jax(sd: dict, cfg, *, tensors: bool = False) -> dict:
    return _to_jax(sd, _rmbg_entries(cfg), tensors)


def _cc_bias(tree_or_sd: dict, jax_side: bool) -> bool | None:
    if jax_side:
        cc = tree_or_sd.get("cc_projection")
        return None if cc is None else "b" in cc
    if "cc_projection.weight" not in tree_or_sd:
        return None
    return "cc_projection.bias" in tree_or_sd


def p2g_params_from_jax(params: dict, cfg, clip_cfg,
                        vae_cfg) -> dict[str, torch.Tensor]:
    """The JAX package's pix2gestalt tree {"unet", "vae", "clip",
    "uncond_ctx"[, "cc_projection"]} -> the state dict of
    `models.pix2gestalt.Pix2Gestalt`."""
    return _from_jax(params, _p2g_entries(cfg, clip_cfg, vae_cfg,
                                          _cc_bias(params, True)))


def p2g_params_to_jax(sd: dict, cfg, clip_cfg, vae_cfg, *,
                      tensors: bool = False) -> dict:
    return _to_jax(sd, _p2g_entries(cfg, clip_cfg, vae_cfg,
                                    _cc_bias(sd, False)), tensors)


def load_p2g_proxy(npz_path: str, meta_path: str | None = None, *,
                   device="cuda"):
    """The trained in-repo pix2gestalt proxy (`checkpoints/proxy/p2g.npz`
    with `p2g_meta.json`: UNet 48 channels, 4 heads, CLIP 64 wide, VAE
    (32, 64, 96, 96)) as a `Pix2Gestalt` module on `device`, its configs
    those the meta records."""
    import json

    from ..models.clip_vit import CLIPVisionConfig
    from ..models.pix2gestalt import Pix2Gestalt, Pix2GestaltConfig
    from ..models.vae import VAEConfig
    from ..pipeline.serving_ckpt import cfg_from_dict

    if meta_path is None:
        meta_path = str(npz_path)[:-len(".npz")] + "_meta.json"
    with open(meta_path) as f:
        meta = json.load(f)
    cfg = cfg_from_dict(Pix2GestaltConfig, meta["p2g_cfg"])
    clip_cfg = cfg_from_dict(CLIPVisionConfig, meta["clip_cfg"])
    vae_cfg = cfg_from_dict(VAEConfig, meta["vae_cfg"])
    params = load_params_npz(npz_path)
    cc = params.get("cc_projection")
    with torch.device("meta"):
        model = Pix2Gestalt(cfg, clip_cfg, vae_cfg,
                            cc_in=0 if cc is None else cc["w"].shape[0],
                            cc_bias=cc is not None and "b" in cc)
    model = model.to_empty(device=device)
    model.load_state_dict(p2g_params_from_jax(params, cfg, clip_cfg, vae_cfg),
                          strict=True)
    return model


# ------------------------------------------------------------- baselines
# The baselines' modules are named after the JAX trees (ADDeepLab,
# PartialCompletionContentDPT, InvisibleStitch, JoUNet), so their entries
# are read off the module: the module path is the tree path, the leaf name
# follows the module's kind (linear / conv / transposed-conv weights "w"
# in the JAX layout, biases "b", norm scales and shifts "scale" / "bias",
# running statistics "mean" / "var"), stacked blocks carry their index, and
# the trees with BatchNorm state are {"params": ..., "bn": ...}.

_NORM_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}


def _baseline_entries(model: torch.nn.Module, *, stacked: tuple = (),
                      bn_root: tuple | None = None, rename=None) -> list:
    """(key, path, kind, index, None) for every state-dict entry of
    `model`. `stacked`: module-path prefixes whose next part is a block
    index stacked on the JAX leaf's first axis. `bn_root`: the path prefix
    the running statistics drop when they move under "bn" (the parameters
    then go under "params"); None for a tree without BatchNorm state.
    `rename(path)`: a last per-model rewrite of a path."""
    mods = dict(model.named_modules())
    out = []
    for key in model.state_dict():
        mod_name, _, leaf = key.rpartition(".")
        mod = mods[mod_name]
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d,
                            torch.nn.ConvTranspose2d)):
            kind = "same" if leaf == "bias" else (
                "linear" if isinstance(mod, torch.nn.Linear) else
                "convt" if isinstance(mod, torch.nn.ConvTranspose2d)
                else "conv")
            jleaf = "b" if leaf == "bias" else "w"
        else:
            kind, jleaf = "same", _NORM_LEAVES.get(leaf, leaf)
        parts = mod_name.split(".") if mod_name else []
        index = None
        for prefix in stacked:
            n = len(prefix)
            if tuple(parts[:n]) == prefix and len(parts) > n:
                index = int(parts[n])
                parts = parts[:n] + parts[n + 1:]
        path = tuple(parts) + (jleaf,)
        if rename is not None:
            path = rename(path)
        if bn_root is not None:
            if jleaf in ("mean", "var"):
                path = ("bn",) + path[len(bn_root):]
            else:
                path = ("params",) + path
        out.append((key, path, kind, index, None))
    return out


def _resnet_rename(path: tuple) -> tuple:
    # torchvision's downsample.0 / .1 are the JAX tree's downsample /
    # downsample_bn
    if "downsample" in path:
        i = path.index("downsample")
        sub = path[i + 1]
        path = path[:i] + ("downsample" if sub == "0" else "downsample_bn",) \
            + path[i + 2:]
    return path


def _jo_dpt_rename(path: tuple) -> tuple:
    # spade.N.param_free_norm.{mean,var} -> bn state N; the JAX tree keeps
    # the refinenets and the output convs under "scratch" as the port does
    if path[0] == "spade" and path[2] == "param_free_norm":
        return ("spade", path[1]) + path[3:]
    return path


def _zoe_rename(path: tuple) -> tuple:
    # BEiT's fused qkv has no bias: the JAX leaf is attn.qkv_w
    if path[-2:] == ("qkv", "w"):
        return path[:-2] + ("qkv_w",)
    if path[-1] == "relative_position_bias_table":
        return path[:-1] + ("rel_pos_table",)
    return path


def _baseline_spec(name: str, cfg):
    """(module class, entries kwargs) of a baseline by registry name."""
    from ..models.deeplab import ADDeepLab
    from ..models.jo_dpt import JoDPT
    from ..models.jo_unet import JoUNet
    from ..models.zoedepth import InvisibleStitch
    if name == "ADDeepLab":
        return ADDeepLab, dict(bn_root=("encoder",), rename=_resnet_rename)
    if name == "PartialCompletionContentDPT":
        return JoDPT, dict(stacked=(("blocks",),), bn_root=("spade",),
                           rename=_jo_dpt_rename)
    if name == "InvisibleStitch":
        return InvisibleStitch, dict(rename=_zoe_rename)
    if name == "JoUNet":
        return JoUNet, dict(bn_root=())
    raise ValueError(f"not a baseline: {name!r}")


def baseline_entries(name: str, cfg) -> list:
    """The bridge entries of baseline `name` ("ADDeepLab",
    "PartialCompletionContentDPT", "InvisibleStitch", "JoUNet") at `cfg`."""
    cls, kw = _baseline_spec(name, cfg)
    with torch.device("meta"):
        model = cls(cfg)
    return _baseline_entries(model, **kw)


def baseline_params_from_jax(name: str, tree: dict, cfg
                             ) -> dict[str, torch.Tensor]:
    """The JAX registry's tree of baseline `name` (`Model.init`: {"params",
    "bn"} for the three with BatchNorm state, the bare parameters for
    InvisibleStitch) -> the port module's state dict, running statistics
    included."""
    return _from_jax(tree, baseline_entries(name, cfg))


def baseline_params_to_jax(name: str, sd: dict, cfg, *,
                           tensors: bool = False) -> dict:
    """The inverse of `baseline_params_from_jax` (`tensors` as in
    `params_to_jax`; gradients under the parameters' names map too)."""
    entries = [e for e in baseline_entries(name, cfg) if e[0] in sd]
    return _to_jax(sd, entries, tensors)
