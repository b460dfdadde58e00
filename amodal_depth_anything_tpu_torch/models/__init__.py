"""DINOv2 trunk, DPT head and the AmodalDAv2 / raw DAV2 models as torch
modules, and the model registry (reference `src/models/__init__.py:13-31`
equivalent) that the training CLI reads model names from."""

from __future__ import annotations

import torch

from .amodal_dav2 import DAV2Config, build_model

__all__ = ["get_model", "MODEL_REGISTRY"]


def _build_amodal_dav2(*, encoder: str = "vitl",
                       guide_type: str = "mask+observation",
                       loss_stategy: str | None = None,
                       loss_strategy: str | None = None,
                       embed_dim: int | None = None,
                       depth: int | None = None, device=None,
                       **_ignored) -> torch.nn.Module:
    # Accept both the reference's (misspelled, load-bearing) config key
    # `loss_stategy` (dav2.py:22, yaml files) and the corrected spelling.
    strategy = loss_strategy or loss_stategy or "entire_target_object"
    return build_model(DAV2Config(
        encoder=encoder, guide_type=guide_type, loss_strategy=strategy,
        raw=False, embed_dim=embed_dim, depth=depth), device=device)


def _build_raw_dav2(*, encoder: str = "vitg", device=None,
                    **_ignored) -> torch.nn.Module:
    return build_model(DAV2Config(encoder=encoder, guide_type="none",
                                  raw=True), device=device)


MODEL_REGISTRY = {
    "AmodalDAv2": _build_amodal_dav2,
    "DepthAnythingV2Raw": _build_raw_dav2,
}


def get_model(name: str, **kwargs) -> torch.nn.Module:
    """The module a config names, allocated on `device` (default CPU) with
    uninitialised float32 parameters; the trainer draws or loads them."""
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
