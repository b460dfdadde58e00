"""PartialCompletionContentDPT checkpoint loading (reference layout ->
the port's `models.jo_dpt.JoDPT` state dict).

The port's counterpart of the JAX package's `convert/jo_dpt_convert.py`:
the jo_amodal DPT checkpoint (`amodal_depth.pth.tar` state_dict, reference
`PartialCompletionContentDPT.py:43`, keys under `model.`) holds the timm
ViT-L/16 trunk (4-channel patch embed) under `pretrained.model.`, the
`act_postprocess` readout / reassemble stacks, the scratch refinenets, the
SPADE fusion blocks (param-free BN running stats) and the MiDaS output
head. The port's module names follow the JAX tree, so loading is a renaming
of keys; the auxiliary `d_feat` 256->80 feature conv (reference
`dpt/models.py:102`, unused by the training / eval path) is dropped.
"""

from __future__ import annotations

import re

import torch

__all__ = ["jo_dpt_state_dict", "rename_reference_keys"]

_RULES = (
    (r"^pretrained\.model\.", ""),
    (r"^pretrained\.act_postprocess(\d)\.0\.project\.0\.",
     lambda m: f"readout.{int(m[1]) - 1}."),
    (r"^pretrained\.act_postprocess(\d)\.3\.",
     lambda m: f"reassemble.{int(m[1]) - 1}.project."),
    (r"^pretrained\.act_postprocess([124])\.4\.",
     lambda m: f"reassemble.{int(m[1]) - 1}.resize."),
    (r"^scratch\.output_conv\.([024])\.",
     lambda m: f"scratch.output_conv.conv{int(m[1]) // 2 + 1}."),
    (r"^spade_fusion(\d)\.mlp_shared\.0\.", r"spade.\1.mlp_shared."),
    (r"^spade_fusion(\d)\.", r"spade.\1."),
)


def rename_reference_keys(sd: dict, rules, keys) -> dict[str, torch.Tensor]:
    """The entries of reference state dict `sd` renamed by `rules` (the
    first matching (pattern, replacement) applies; an unmatched key keeps
    its name), as float32 tensors, restricted to the port's `keys`."""
    out = {}
    for key, val in sd.items():
        for pattern, repl in rules:
            new, n = re.subn(pattern, repl, key, count=1)
            if n:
                key = new
                break
        if key in keys:
            out[key] = torch.as_tensor(val).float()
    return out


def jo_dpt_state_dict(sd: dict, model: torch.nn.Module
                      ) -> dict[str, torch.Tensor]:
    """A reference jo_amodal DPT state dict as `model`'s (a `JoDPT`) state
    dict, for a strict `load_state_dict`. The trunk's final LayerNorm, which
    the DPT path never reads, is ones / zeros where the checkpoint has
    none."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    keys = set(model.state_dict())
    out = rename_reference_keys(sd, _RULES, keys)
    d = model.cfg.embed_dim
    out.setdefault("norm.weight", torch.ones(d))
    out.setdefault("norm.bias", torch.zeros(d))
    missing = keys - set(out)
    if missing:
        raise KeyError(f"reference checkpoint lacks {sorted(missing)[:8]}")
    return out
