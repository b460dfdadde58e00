"""DINOv2 trunk, DPT head and the AmodalDAv2 / raw DAV2 models, the LDM
UNet, SD VAE and DepthFM as torch modules, and the model registry
(reference `src/models/__init__.py:13-31` equivalent) that the training CLI
reads model names from."""

from __future__ import annotations

import dataclasses

import torch

from .amodal_dav2 import DAV2Config, build_model
from .depthfm import DepthFMConfig, build_depthfm

__all__ = ["get_model", "MODEL_REGISTRY"]


def _build_amodal_dav2(*, encoder: str = "vitl",
                       guide_type: str = "mask+observation",
                       loss_stategy: str | None = None,
                       loss_strategy: str | None = None,
                       embed_dim: int | None = None,
                       depth: int | None = None, device="cuda",
                       **_ignored) -> torch.nn.Module:
    # Accept both the reference's (misspelled, load-bearing) config key
    # `loss_stategy` (dav2.py:22, yaml files) and the corrected spelling.
    strategy = loss_strategy or loss_stategy or "entire_target_object"
    return build_model(DAV2Config(
        encoder=encoder, guide_type=guide_type, loss_strategy=strategy,
        raw=False, embed_dim=embed_dim, depth=depth), device=device)


def _build_raw_dav2(*, encoder: str = "vitg", device="cuda",
                    **_ignored) -> torch.nn.Module:
    return build_model(DAV2Config(encoder=encoder, guide_type="none",
                                  raw=True), device=device)


def _build_depthfm(*, guide_type: str = "mask+observation",
                   tiny: bool = False, cfg_overrides: dict | None = None,
                   device="cuda", **_ignored) -> torch.nn.Module:
    """DepthFMAmodal (reference `dfm_amodal.py:34`). `tiny=True` shrinks
    the UNet and the VAE for tests; `cfg_overrides` patches DepthFMConfig
    fields on top. Allocated on the card unless `device` says otherwise."""
    if tiny:
        cfg = DepthFMConfig(guide_type=guide_type, model_channels=32,
                            channel_mult=(1, 2), num_heads=2, context_dim=32,
                            context_len=7, vae_channels=(16, 32), vae_layers=1)
    else:
        cfg = DepthFMConfig(guide_type=guide_type)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    return build_depthfm(cfg, device=device)


def _build_plain_depthfm(**kwargs) -> torch.nn.Module:
    return _build_depthfm(**{**kwargs,
                             "guide_type": kwargs.get("guide_type", "none")})


MODEL_REGISTRY = {
    "AmodalDAv2": _build_amodal_dav2,
    "DepthAnythingV2Raw": _build_raw_dav2,
    "DepthFMAmodal": _build_depthfm,
    "DepthFM": _build_plain_depthfm,
}


def get_model(name: str, **kwargs) -> torch.nn.Module:
    """The module a config names, allocated on `device` with uninitialised
    float32 parameters; the trainer or the pipeline draws or loads them.
    Every model is allocated on the card unless `device` says otherwise
    (`device="cpu"` for the CPU)."""
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)
