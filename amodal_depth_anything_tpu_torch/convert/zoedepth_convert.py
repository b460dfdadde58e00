"""ZoeDepth / InvisibleStitch checkpoint loading (reference layout -> the
port's `models.zoedepth.InvisibleStitch` state dict).

The port's counterpart of the JAX package's `convert/zoedepth_convert.py`:
the `invisible-stitch.pt` / ZoeDepth-N layout (reference
`invisible_stitch.py:77-110`; ZoeDepth `models/model_io.py:27-56` strips
optional `model` / `module.` wrappers, as `strip_zoe_prefixes` does):

  core.core.pretrained.model.*         BEiT-L timm backbone
  core.core.pretrained.act_postprocess{1..4}   readout + reassemble
  core.core.scratch.layer{1..4}_rn / refinenet{1..4} / output_conv
  conv2, seed_bin_regressor._net.{0,2}, seed_projector._net.{0,2},
  projectors.{i}._net.{0,2}, attractors.{i}._net.{0,2},
  conditional_log_binomial.mlp.{0,2}

The port's module names follow the JAX tree, so loading is a renaming of
keys; entries the model does not hold (timm's relative_position_index
buffers, heads the forward never reads) are dropped.
"""

from __future__ import annotations

import torch

from .jo_dpt_convert import rename_reference_keys

__all__ = ["strip_zoe_prefixes", "zoedepth_state_dict"]

_RULES = (
    (r"^core\.core\.pretrained\.model\.", "backbone."),
    (r"^core\.core\.pretrained\.act_postprocess(\d)\.0\.project\.0\.",
     lambda m: f"readout.{int(m[1]) - 1}."),
    (r"^core\.core\.pretrained\.act_postprocess(\d)\.3\.",
     lambda m: f"reassemble.{int(m[1]) - 1}.project."),
    (r"^core\.core\.pretrained\.act_postprocess([124])\.4\.",
     lambda m: f"reassemble.{int(m[1]) - 1}.resize."),
    (r"^core\.core\.scratch\.output_conv\.([024])\.",
     lambda m: f"scratch.output_conv.conv{int(m[1]) // 2 + 1}."),
    (r"^core\.core\.scratch\.", "scratch."),
    (r"^(.*)\._net\.([02])\.", lambda m: f"{m[1]}.conv{int(m[2]) // 2 + 1}."),
    (r"^conditional_log_binomial\.mlp\.([02])\.",
     lambda m: f"conditional_log_binomial.conv{int(m[1]) // 2 + 1}."),
)


def strip_zoe_prefixes(sd: dict) -> dict:
    """Handle the 'model' / 'module.' wrapping zoe's model_io strips."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def zoedepth_state_dict(sd: dict, model: torch.nn.Module
                        ) -> dict[str, torch.Tensor]:
    """A reference ZoeDepth / InvisibleStitch state dict as `model`'s state
    dict, for a strict `load_state_dict`."""
    keys = set(model.state_dict())
    out = rename_reference_keys(strip_zoe_prefixes(sd), _RULES, keys)
    missing = keys - set(out)
    if missing:
        raise KeyError(f"reference checkpoint lacks {sorted(missing)[:8]}")
    return out
