"""The port's heuristics stack (CLIP, SAM, RMBG, the pix2gestalt program,
`MaskHeuristics`) vs the JAX package on the same weights and inputs.

The JAX package's tiny presets give the parameter trees; seeded numpy noise
on every leaf makes the layers it starts at zero (SAM's upscaling, the
UNet's output convs, the relative positions) carry signal; the weight
bridge (`convert.weights.*_params_from_jax`) carries them across. The DDIM
noise is drawn by `jax.random.normal` and handed to the port. float32 on
both sides, plain attention on the CPU. Bars: models and programs max abs
<= 1e-4 (sums in another order), one attention <= 1e-5, the weight
bridge and the checkpoint loaders exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.convert import emit_torch
from amodal_depth_anything_tpu.convert.heuristics_convert import (
    convert_clip_vision, p2g_cfg_from_ckpt as jax_p2g_cfg_from_ckpt)
from amodal_depth_anything_tpu.convert.rmbg_convert import convert_rmbg
from amodal_depth_anything_tpu.heuristics import mask_heuristics as jmh
from amodal_depth_anything_tpu.models import clip_vit as jclip
from amodal_depth_anything_tpu.models import rmbg as jrmbg
from amodal_depth_anything_tpu.models import sam as jsam
from amodal_depth_anything_tpu_torch.convert import heuristics as ch
from amodal_depth_anything_tpu_torch.convert.weights import (
    clip_params_from_jax, clip_params_to_jax, p2g_params_from_jax,
    rmbg_params_from_jax, rmbg_params_to_jax, sam_params_from_jax,
    sam_params_to_jax)
from amodal_depth_anything_tpu_torch.heuristics import (
    MaskHeuristics, make_rmbg_matting_fn)
from amodal_depth_anything_tpu_torch.models.clip_vit import (
    CLIPVisionConfig, CLIPVisionModelWithProjection)
from amodal_depth_anything_tpu_torch.models.pix2gestalt import (
    Pix2Gestalt, Pix2GestaltConfig)
from amodal_depth_anything_tpu_torch.models.rmbg import (ISNet, RMBGConfig,
                                                         maxpool2)
from amodal_depth_anything_tpu_torch.models.sam import SAM, SAMConfig
from amodal_depth_anything_tpu_torch.models.vae import VAEConfig
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-4
ATTN_TOL = 1e-5
TINY_RMBG = dict(width=8, stage_mid=(4, 4, 4, 8, 8, 8),
                 stage_out=(8, 8, 16, 16, 16, 16), dec_mid=(4, 4, 4, 8, 8))
PROXY = "checkpoints/proxy/p2g.npz"


def noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 *
                        rng.standard_normal(np.shape(a)).astype(np.float32),
                        tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfg(cls, jax_cfg):
    """The port's config dataclass with the JAX one's fields."""
    return cls(**dataclasses.asdict(jax_cfg))


def _module(cls, cfg, sd, **kw):
    m = cls(cfg, **kw)
    m.load_state_dict(sd, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def stack():
    """(JAX MaskHeuristics, port MaskHeuristics) on the same noisy tiny
    weights, each with a tiny RMBG hook on the same weights (input 64)."""
    jh = jmh.MaskHeuristics.init_random(jax.random.PRNGKey(0), tiny=True)
    jh.sam_params = noisy(jh.sam_params, 1)
    jh.p2g_params = noisy(jh.p2g_params, 2)
    rcfg = jrmbg.RMBGConfig(**TINY_RMBG)
    rparams = noisy(jrmbg.init_rmbg(jax.random.PRNGKey(3), rcfg), 4)
    jh.matting_fn = jmh.make_rmbg_matting_fn(rparams, rcfg, input_size=64)

    sam_cfg = _cfg(SAMConfig, jh.sam_cfg)
    p2g_cfg = _cfg(Pix2GestaltConfig, jh.p2g_cfg)
    clip_cfg = _cfg(CLIPVisionConfig, jh.clip_cfg)
    vae_cfg = _cfg(VAEConfig, jh.vae_cfg)
    sam = _module(SAM, sam_cfg, sam_params_from_jax(jh.sam_params, sam_cfg))
    p2g = _module(Pix2Gestalt, p2g_cfg, p2g_params_from_jax(
        jh.p2g_params, p2g_cfg, clip_cfg, vae_cfg), clip_cfg=clip_cfg,
        vae_cfg=vae_cfg)
    rmbg = _module(ISNet, RMBGConfig(**TINY_RMBG),
                   rmbg_params_from_jax(rparams, RMBGConfig(**TINY_RMBG)))
    th = MaskHeuristics(sam, p2g, matting_fn=make_rmbg_matting_fn(
        rmbg, input_size=64))
    return jh, th, rparams


def _scene(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    hint = np.zeros((h, w), np.float32)
    hint[8:12, 30:33] = 1.0          # a small component: its centroid
    hint[18:34, 6:28] = 1.0          # a large one: a 10 px grid
    return img, hint


# ------------------------------------------------------------------ CLIP

def test_clip_tower_matches_jax(stack):
    jh, th, _ = stack
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = jclip.clip_image_embed(jh.p2g_params["clip"], jh.clip_cfg,
                                 jnp.asarray(x))
    with torch.no_grad():
        got = th.p2g.clip(_t(x))
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_clip_bridge_round_trips(stack):
    jh, _, _ = stack
    cfg = _cfg(CLIPVisionConfig, jh.clip_cfg)
    back = clip_params_to_jax(clip_params_from_jax(jh.p2g_params["clip"],
                                                   cfg), cfg)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, jh.p2g_params["clip"]))


# ------------------------------------------------------------------- SAM

def test_sam_encoder_and_decoder_match_jax(stack):
    jh, th, _ = stack
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    pts = rng.random((1, 5, 2)).astype(np.float32)
    lbl = np.asarray([[1, 0, 1, -1, -1]], np.float32)
    emb = jsam.sam_encode_image(jh.sam_params, jh.sam_cfg, jnp.asarray(x))
    masks, iou = jsam.sam_predict_masks(jh.sam_params, jh.sam_cfg, emb,
                                        jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        t_emb = th.sam.encode_image(_t(x))
        t_masks, t_iou = th.sam.predict_masks(t_emb, _t(pts), _t(lbl))
    for got, ref in ((t_emb, emb), (t_masks, masks), (t_iou, iou)):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("grid", [2, 4])
def test_sam_windowed_attention_matches_jax(stack, grid):
    """One encoder attention with the relative-position bias (a 2 x 2
    window, and the global block's 4 x 4 grid)."""
    jh, th, _ = stack
    block = 0 if grid == 2 else 1
    p = jh.sam_params["encoder"]["blocks"][str(block)]["attn"]
    x = np.random.default_rng(7).standard_normal((3, grid, grid, 32)).astype(
        np.float32)
    ref = jsam._windowed_attention(p, jnp.asarray(x), 2)
    with torch.no_grad():
        got = th.sam.image_encoder.blocks[block].attn(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATTN_TOL)


def test_sam_decoder_attention_matches_jax(stack):
    jh, th, _ = stack
    p = jh.sam_params["decoder"]["layers"]["0"]["cross_t2i"]
    rng = np.random.default_rng(8)
    q, k = (rng.standard_normal((2, n, 32)).astype(np.float32)
            for n in (7, 16))
    ref = jsam._decoder_attn(p, jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(k), 2)
    attn = th.sam.mask_decoder.transformer.layers[0].cross_attn_token_to_image
    with torch.no_grad():
        got = attn(_t(q), _t(k), _t(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=ATTN_TOL)


def test_sam_bridge_and_reference_loader(stack):
    """`segment_anything` keys (as the JAX emitter writes them, with the
    mask-prompt downscaling keys a released file holds) load strictly, and
    equal the bridged tree; the bridge inverts exactly."""
    jh, th, _ = stack
    sd = emit_torch.emit_sam_sd(jh.sam_params)
    sd["prompt_encoder.mask_downscaling.0.weight"] = np.zeros((4, 1, 2, 2))
    sam = SAM(th.sam_cfg)
    sam.load_state_dict(ch.sam_state_dict(sd), strict=True)
    for k, v in th.sam.state_dict().items():
        np.testing.assert_array_equal(sam.state_dict()[k].numpy(), v.numpy())
    back = sam_params_to_jax(th.sam.state_dict(), th.sam_cfg)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, jh.sam_params))


# ------------------------------------------------------------------ RMBG

@pytest.mark.parametrize("hw", [(7, 7), (8, 5), (13, 2), (1, 1)])
def test_maxpool2_equals_jax_same_padding(hw):
    x = np.random.default_rng(10).standard_normal((2, *hw, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(maxpool2(_t(x)).numpy(),
                                  np.asarray(jrmbg._maxpool2(jnp.asarray(x))))


def test_rmbg_reference_loader_folds_batchnorm(stack):
    """briaai keys with non-trivial BatchNorm statistics fold to exactly
    what the JAX converter folds."""
    _, _, rparams = stack
    jcfg = jrmbg.RMBGConfig(**TINY_RMBG)
    sd = emit_torch.emit_rmbg_sd(rparams, jcfg,
                                 bn_stats=np.random.default_rng(11))
    folded = ch.fold_rmbg_batchnorm(sd)
    ref = rmbg_params_from_jax(convert_rmbg(sd, jcfg), RMBGConfig(**TINY_RMBG))
    assert sorted(folded) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(folded[k].numpy(), ref[k].numpy())
    rmbg = ISNet(RMBGConfig(**TINY_RMBG))
    rmbg.load_state_dict(folded, strict=True)
    back = rmbg_params_to_jax(rmbg.state_dict(), rmbg.cfg)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, convert_rmbg(sd, jcfg)))


# ----------------------------------------------------- checkpoint loaders

@pytest.mark.parametrize("cond_mode,cc", [("image+mask", False),
                                          ("image", True)])
def test_p2g_cfg_and_unet_from_ldm_checkpoint(stack, cond_mode, cc):
    jh, _, _ = stack
    jcfg = dataclasses.replace(jh.p2g_cfg, cond_mode=cond_mode)
    unet = noisy(jmh.init_unet(
        jax.random.PRNGKey(12), jcfg.unet), 13)
    rng = np.random.default_rng(14)
    cc_tree = ({"w": rng.standard_normal((36, 32)).astype(np.float32),
                "b": rng.standard_normal(32).astype(np.float32)}
               if cc else None)
    sd = emit_torch.emit_pix2gestalt_ckpt_sd(unet, jcfg.unet, cc_tree)
    ref_cfg, ref_cc = jax_p2g_cfg_from_ckpt(sd)
    cfg, got_cc = ch.p2g_cfg_from_ckpt(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.cond_mode == cond_mode
    assert (got_cc is None) == (ref_cc is None) == (not cc)
    if cc:
        np.testing.assert_array_equal(got_cc["weight"].numpy().T, ref_cc["w"])
        np.testing.assert_array_equal(got_cc["bias"].numpy(), ref_cc["b"])
    # the file says nothing of the depth or the heads: the tiny preset's
    cfg = dataclasses.replace(cfg, channel_mult=tuple(jcfg.channel_mult),
                              num_heads=jcfg.num_heads)
    p2g = Pix2Gestalt(cfg, _cfg(CLIPVisionConfig, jh.clip_cfg),
                      _cfg(VAEConfig, jh.vae_cfg), cc_in=36 if cc else 0)
    p2g.unet.load_state_dict(ch.pix2gestalt_unet_state_dict(sd), strict=True)
    if cc:
        p2g.cc_projection.load_state_dict(got_cc, strict=True)
    bridged = p2g_params_from_jax(
        {"unet": unet, "vae": jh.p2g_params["vae"],
         "clip": jh.p2g_params["clip"], "uncond_ctx": np.zeros((1, 1, 32)),
         **({"cc_projection": cc_tree} if cc else {})},
        cfg, p2g.clip_cfg, p2g.vae_cfg)
    for k, v in p2g.state_dict().items():
        if k.startswith(("unet.", "cc_projection.")):
            np.testing.assert_array_equal(v.numpy(), bridged[k].numpy())


def test_clip_reference_loader(stack):
    jh, th, _ = stack
    sd = emit_torch.emit_clip_vision_sd(jh.p2g_params["clip"], jh.clip_cfg)
    sd["vision_model.embeddings.position_ids"] = np.arange(17)[None]
    clip = CLIPVisionModelWithProjection(th.clip_cfg)
    clip.load_state_dict(ch.clip_state_dict(sd), strict=True)
    ref = clip_params_from_jax(convert_clip_vision(sd, jh.clip_cfg),
                               th.clip_cfg)
    for k, v in clip.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy())


# ------------------------------------------------- shared helpers

def _jax_completion(jh, cfg, image, visible, seed):
    jh.p2g_cfg = cfg
    jh.__dict__.pop("_p2g_jit", None)
    return jh.pix2gestalt_completion(image, visible, seed=seed)


def _jax_noise(seed, size, vae_blocks=2):
    """The JAX package's initial DDIM latents for `seed` (its key goes to
    `jax.random.normal` as it is) at latent size size / 2^(blocks - 1)."""
    hw = size // 2 ** (vae_blocks - 1)
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (1, hw, hw, 4), jnp.float32))


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_state_written_by_jax_restores_in_port(stack, tmp_path,
                                                       dtype):
    jh, th, _ = stack
    path = str(tmp_path / "jax_state")
    saved = (jh.sam_params, jh.p2g_params)
    try:
        if dtype == "bfloat16":
            jh.cast_to(jnp.bfloat16)
        jh.save_serving(path)
        sam_ref, p2g_ref = (jax.tree.map(lambda a: np.asarray(a, np.float32),
                                         t)
                            for t in (jh.sam_params, jh.p2g_params))
    finally:
        jh.sam_params, jh.p2g_params = saved
        jh.compute_dtype = jnp.float32
        jh.__dict__.pop("_sam_jit", None)
        jh.__dict__.pop("_p2g_jit", None)
    got = MaskHeuristics.load_serving(path, device="cpu")
    assert got.compute_dtype == getattr(torch, dtype)
    assert got.p2g_cfg == th.p2g_cfg and got.sam_cfg == th.sam_cfg
    assert got.max_points == jh.max_points
    want_sam = sam_params_from_jax(sam_ref, th.sam_cfg)
    for k, v in got.sam.state_dict().items():
        assert v.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(v.float().numpy(),
                                      want_sam[k].float().numpy())
    want_p2g = p2g_params_from_jax(p2g_ref, th.p2g_cfg, th.clip_cfg,
                                   th.vae_cfg)
    for k, v in got.p2g.state_dict().items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      want_p2g[k].float().numpy())
    rmbg = got.matting_fn.rmbg_model
    assert got.matting_fn.rmbg_input_size == 64
    for k, v in rmbg.state_dict().items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(
            v.numpy(), th.matting_fn.rmbg_model.state_dict()[k].numpy())


def test_serving_state_written_by_port_restores_in_jax(stack, tmp_path):
    jh, th, _ = stack
    path = str(tmp_path / "port_state")
    th.save_serving(path)
    got = jmh.MaskHeuristics.load_serving(path)
    assert got.p2g_cfg == jh.p2g_cfg and got.sam_cfg == jh.sam_cfg
    assert jnp.dtype(got.compute_dtype) == jnp.float32
    for mine, ref in ((got.sam_params, jh.sam_params),
                      (got.p2g_params, jh.p2g_params),
                      (got.matting_fn.rmbg_params, stack[2])):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)), mine, ref)
    # a restored port state gives the port's own completion back
    image, _ = _scene(21)
    visible = np.random.default_rng(22).random(image.shape[:2]) > 0.5
    again = MaskHeuristics.load_serving(path, device="cpu")
    noise = _jax_noise(1, th.p2g_cfg.image_size)
    np.testing.assert_array_equal(
        again.pix2gestalt_completion(image, visible, noise=noise),
        th.pix2gestalt_completion(image, visible, noise=noise))


def test_unpersistable_matting_hook_is_refused(stack, tmp_path):
    _, th, _ = stack
    saved = th.matting_fn
    th.matting_fn = lambda completion: completion[..., 0]
    try:
        with pytest.raises(ValueError, match="not persistable"):
            th.save_serving(str(tmp_path / "x"))
    finally:
        th.matting_fn = saved


def test_no_prompts_raise(stack):
    _, th, _ = stack
    image, _ = _scene(23)
    with pytest.raises(ValueError, match="no point prompts"):
        th.amodal_mask_from_points(image, np.zeros(image.shape[:2]))
