"""DINOv2 trunk, DPT head and the AmodalDAv2 / raw DAV2 models, the LDM
UNet, SD VAE and DepthFM, the baselines (ADDeepLab, the jo_dpt
PartialCompletionContentDPT, InvisibleStitch, JoUNet) as torch modules,
and the model registry
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


def _built(module_cls, cfg, device) -> torch.nn.Module:
    """`module_cls(cfg)` with float32 parameters allocated on `device` and
    left uninitialised (the trainer draws or loads them)."""
    with torch.device("meta"):
        model = module_cls(cfg)
    model = model.to_empty(device=device).float()
    if hasattr(model, "reset_constants_"):
        model.reset_constants_()
    return model


def _build_addeeplab(*, encoder_name: str = "resnet50",
                     channels=(256, 512, 1024, 2048),
                     up_sample_channels=(128, 256, 512, 1024),
                     tiny: bool = False, device="cuda",
                     **_ignored) -> torch.nn.Module:
    """ADDeepLab baseline (reference `deeplab.py:203`). `tiny=True`: the
    JAX tests' miniature (ResNet width 8, one block a stage, one mViT
    layer at 2 heads)."""
    from .deeplab import ADDeepLab, ADDeepLabConfig
    from .resnet import ResNetConfig

    if encoder_name != "resnet50":
        raise ValueError("only resnet50 encoder is implemented "
                         f"(got {encoder_name!r})")
    if tiny:
        cfg = ADDeepLabConfig(
            channels=(32, 64, 128, 256), up_sample_channels=(16, 32, 64, 128),
            aspp_channels=32, mvit_heads=2, mvit_layers=1, mvit_ff=32,
            resnet=ResNetConfig(in_channels=4, width=8, layers=(1, 1, 1, 1)))
    else:
        cfg = ADDeepLabConfig(channels=tuple(channels),
                              up_sample_channels=tuple(up_sample_channels))
    return _built(ADDeepLab, cfg, device)


def _build_jo_dpt(*, tiny: bool = False, device="cuda",
                  **_ignored) -> torch.nn.Module:
    """PartialCompletionContentDPT baseline (reference
    `jo_amodal/PartialCompletionContentDPT.py:26`); the loss-strategy keys
    of its config are ignored (its head is always a sigmoid)."""
    from .jo_dpt import JoDPT, JoDPTConfig

    cfg = JoDPTConfig(embed_dim=64, depth=4, num_heads=2, hooks=(0, 1, 2, 3),
                      tap_channels=(8, 16, 32, 32), features=16,
                      spade_hidden=8, img_size=64) if tiny else JoDPTConfig()
    return _built(JoDPT, cfg, device)


def _build_invisible_stitch(*, tiny: bool = False, device="cuda",
                            **_ignored) -> torch.nn.Module:
    """InvisibleStitch baseline (reference `invisible_stitch.py:77-110`):
    ZoeDepth-N (MiDaS DPT_BEiT_L_384) with depth-completion channels; its
    forward takes `invisible_mask=` and `observation=`."""
    from .beit import BEiTConfig
    from .zoedepth import InvisibleStitch, ZoeDepthConfig

    if tiny:
        cfg = ZoeDepthConfig(
            backbone=BEiTConfig(embed_dim=64, depth=4, num_heads=2,
                                img_size=64, in_chans=5),
            hooks=(0, 1, 2, 3), tap_channels=(8, 16, 32, 32), features=16,
            n_bins=8, bin_embedding_dim=16, n_attractors=(4, 2, 2, 1),
            midas_out=8)
    else:
        cfg = ZoeDepthConfig()
    return _built(InvisibleStitch, cfg, device)


def _build_jo_unet(*, w: float = 4.0, depth: int = 4, in_channels: int = 3,
                   n_classes: int = 2, tiny: bool = False, device="cuda",
                   **_ignored) -> torch.nn.Module:
    """jo_amodal plain U-Net family (reference `jo_amodal/unet/
    unet_model.py` UNet/UNetD2/UNetD3 and the `unet025..unet4` width
    factories, here `w`)."""
    from .jo_unet import JoUNet, JoUNetConfig

    if tiny:
        w, depth = 0.25, 2
    return _built(JoUNet, JoUNetConfig(in_channels=in_channels,
                                       n_classes=n_classes, w=w, depth=depth),
                  device)


MODEL_REGISTRY = {
    "AmodalDAv2": _build_amodal_dav2,
    "DepthAnythingV2Raw": _build_raw_dav2,
    "DepthFMAmodal": _build_depthfm,
    "DepthFM": _build_plain_depthfm,
    "ADDeepLab": _build_addeeplab,
    "PartialCompletionContentDPT": _build_jo_dpt,
    "InvisibleStitch": _build_invisible_stitch,
    "JoUNet": _build_jo_unet,
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
