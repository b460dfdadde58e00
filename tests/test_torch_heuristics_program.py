"""The port's pix2gestalt program, `MaskHeuristics.amodal_mask_from_points`
and RMBG vs the JAX package, on the noisy tiny stack of
tests/test_torch_heuristics.py and on the trained in-repo proxy
(`checkpoints/proxy/p2g.npz`). The DDIM noise is `jax.random.normal`'s,
handed to the port. float32 on both sides, plain attention on the CPU; max
abs <= 1e-4; the masks equal, a pixel within 1e-4 of its threshold counted
and reported."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.heuristics import mask_heuristics as jmh
from amodal_depth_anything_tpu.models import clip_vit as jclip
from amodal_depth_anything_tpu.models import rmbg as jrmbg
from amodal_depth_anything_tpu_torch.convert.weights import (
    load_p2g_proxy, p2g_params_from_jax)
from amodal_depth_anything_tpu_torch.heuristics import MaskHeuristics
from amodal_depth_anything_tpu_torch.models.clip_vit import CLIPVisionConfig
from amodal_depth_anything_tpu_torch.models.pix2gestalt import (
    Pix2Gestalt, Pix2GestaltConfig)
from amodal_depth_anything_tpu_torch.models.sam import SAM, SAMConfig
from amodal_depth_anything_tpu_torch.models.vae import VAEConfig
from tests.test_torch_heuristics import (  # noqa: F401 (the fixture)
    PROXY, TINY_RMBG, TOL, _cfg, _jax_completion, _jax_noise, _module, _scene,
    _t, noisy, stack)
from tests.test_torch_models import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("cond_mode,deep_cache", [
    ("image+mask", None), ("image+mask", (2, 1)), ("image", None)])
def test_p2g_completion_matches_jax(stack, cond_mode, deep_cache):
    """Two guided DDIM steps through the joint batch-2B UNet call, both
    conditioning layouts, with and without DeepCache."""
    jh, th, _ = stack
    base = jh.p2g_cfg
    cfg = dataclasses.replace(base, cond_mode=cond_mode, ddim_steps=2,
                              ddim_deep_cache=deep_cache)
    image, _ = _scene(15)
    visible = np.random.default_rng(16).random(image.shape[:2]) > 0.5
    try:
        if cond_mode == base.cond_mode:
            ref = _jax_completion(jh, cfg, image, visible, seed=3)
            th.p2g_cfg = _cfg(Pix2GestaltConfig, cfg)
            got = th.pix2gestalt_completion(
                image, visible, noise=_jax_noise(3, cfg.image_size))
        else:
            ref, got = _other_layout(jh, cfg, image, visible)
    finally:
        jh.p2g_cfg = base
        jh.__dict__.pop("_p2g_jit", None)
        th.p2g_cfg = _cfg(Pix2GestaltConfig, base)
    assert got.shape == ref.shape == (32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


def _other_layout(jh, cfg, image, visible):
    """The "image" layout (conv-in 8) on its own noisy UNet."""
    unet = noisy(jmh.init_unet(
        jax.random.PRNGKey(17), cfg.unet), 18)
    params = dict(jh.p2g_params, unet=unet)
    saved = jh.p2g_params
    jh.p2g_params = params
    try:
        ref = _jax_completion(jh, cfg, image, visible, seed=4)
    finally:
        jh.p2g_params = saved
    tcfg = _cfg(Pix2GestaltConfig, cfg)
    clip_cfg, vae_cfg = (_cfg(CLIPVisionConfig, jh.clip_cfg),
                         _cfg(VAEConfig, jh.vae_cfg))
    p2g = _module(Pix2Gestalt, tcfg, p2g_params_from_jax(
        params, tcfg, clip_cfg, vae_cfg), clip_cfg=clip_cfg, vae_cfg=vae_cfg)
    th = MaskHeuristics(SAM(SAMConfig(img_size=64, embed_dim=32, depth=2,
                                      num_heads=2, window_size=2,
                                      global_blocks=(1,), out_chans=32,
                                      decoder_dim=32, decoder_heads=2)), p2g)
    got = th.pix2gestalt_completion(image, visible,
                                    noise=_jax_noise(4, cfg.image_size))
    return ref, got


def test_clip_input_must_be_known(stack):
    _, th, _ = stack
    img = torch.zeros(1, 32, 32, 3)
    with pytest.raises(ValueError, match="clip_input"):
        th.p2g.context(img, img[..., :1], dataclasses.replace(
            th.p2g_cfg, clip_input="masked"))


@pytest.mark.parametrize("matting", ["rmbg", "threshold"])
def test_amodal_mask_from_points_matches_jax(stack, matting):
    """The whole path at the tiny size: host point selection, SAM, the
    completion, the matting, the union. A pixel whose value before its
    threshold lies within 1e-4 of it may flip; such pixels are counted,
    and none may differ otherwise."""
    jh, th, _ = stack
    image, hint = _scene(19)
    saved = (jh.matting_fn, th.matting_fn)
    if matting == "threshold":
        jh.matting_fn = th.matting_fn = None
    try:
        ref = jh.amodal_mask_from_points(image, hint)
        got = th.amodal_mask_from_points(
            image, hint, noise=_jax_noise(0, th.p2g_cfg.image_size))
        # the values the port thresholds, for the pixels that differ
        pts = jmh.get_points_from_components(
            (hint > 0).astype(np.uint8) * 255)
        visible = th.sam_visible_mask(image, pts)
        completion = th.pix2gestalt_completion(
            image, visible, noise=_jax_noise(0, th.p2g_cfg.image_size))
    finally:
        jh.matting_fn, th.matting_fn = saved
    assert got.shape == ref.shape == image.shape[:2]
    assert got.dtype == np.float32
    assert (got >= visible).all()
    differ = got != np.asarray(ref)
    near = 0
    if differ.any():
        from amodal_depth_anything_tpu_torch.heuristics import host_ops
        h, w = image.shape[:2]
        if matting == "threshold":
            score = host_ops.resize_nearest(completion.mean(-1), (w, h))
            margin = np.abs(score - 0.95)
        else:
            margin = np.full(differ.shape, np.inf)   # no alpha to read
        near = int((differ & (margin <= 1e-4)).sum())
    print(f"amodal mask ({matting}): {int(differ.sum())} pixels differ, "
          f"{near} of them within 1e-4 of the threshold")
    assert int(differ.sum()) == near


def test_p2g_proxy_matches_jax():
    """The trained in-repo proxy at 64 px, three DDIM steps."""
    import json

    from amodal_depth_anything_tpu.scripts.train_proxy import load_params_npz
    from amodal_depth_anything_tpu.pipeline.serving_ckpt import cfg_from_dict

    with open(PROXY[:-4] + "_meta.json") as f:
        meta = json.load(f)
    jcfg = dataclasses.replace(
        cfg_from_dict(jmh.Pix2GestaltConfig, meta["p2g_cfg"]),
        image_size=64, ddim_steps=3)
    jh = jmh.MaskHeuristics.init_random(jax.random.PRNGKey(0), tiny=True)
    jh.clip_cfg = cfg_from_dict(jclip.CLIPVisionConfig, meta["clip_cfg"])
    jh.vae_cfg = cfg_from_dict(jmh.VAEConfig, meta["vae_cfg"])
    jh.p2g_params = jax.tree.map(jnp.asarray, load_params_npz(PROXY))
    image, _ = _scene(20, 48, 72)
    visible = np.zeros(image.shape[:2], bool)
    visible[10:40, 20:50] = True
    ref = _jax_completion(jh, jcfg, image, visible, seed=5)

    p2g = load_p2g_proxy(PROXY, device="cpu").eval()
    tiny = MaskHeuristics.init_random(0, tiny=True, device="cpu")
    th = MaskHeuristics(tiny.sam, p2g)
    th.p2g_cfg = _cfg(Pix2GestaltConfig, jcfg)
    got = th.pix2gestalt_completion(image, visible,
                                    noise=_jax_noise(5, 64, 4))
    assert got.shape == (64, 64, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL)


# ------------------------------------------------------------------ RMBG

@pytest.mark.parametrize("hw", [(64, 64), (37, 45)])
def test_rmbg_matches_jax(stack, hw):
    _, th, rparams = stack
    x = np.random.default_rng(9).random((1, *hw, 3)).astype(np.float32)
    ref = jrmbg.apply_rmbg(rparams, jrmbg.RMBGConfig(**TINY_RMBG),
                           jnp.asarray(x))
    with torch.no_grad():
        got = th.matting_fn.rmbg_model(_t(x))
    assert tuple(got.shape) == ref.shape == (1, *hw, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
