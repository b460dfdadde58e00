"""Port DepthFM (UNet, VAE, flow-matching inference) vs the JAX package.

The same seeded numpy weights (every leaf of the JAX tree, the layers it
starts at zero included) and inputs go to both packages through the weight
bridge; the q_sample noise is drawn with jax.random and handed to the port.
float32 on both sides, plain attention on the CPU; max abs <= 1e-4 for the
models (sums in another order), <= 1e-5 for the ops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import depthfm as jfm
from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.models import unet_ldm as junet
from amodal_depth_anything_tpu.models import vae as jvae
from amodal_depth_anything_tpu.ops import conv as jconv
from amodal_depth_anything_tpu.ops.ddim import \
    parse_deep_cache as jax_parse_deep_cache
from amodal_depth_anything_tpu_torch.convert.weights import \
    depthfm_params_from_jax
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.models import depthfm as tfm
from amodal_depth_anything_tpu_torch.models import unet_ldm as tunet
from amodal_depth_anything_tpu_torch.ops.conv import (conv2d,
                                                      fused_upsample2x_conv)
from amodal_depth_anything_tpu_torch.ops.ddim import parse_deep_cache
from amodal_depth_anything_tpu_torch.ops.resize import resize_nearest
from tests.test_torch_models import eager, few_torch_threads  # noqa: F401

TOL = 1e-4
OP_TOL = 1e-5


def seeded_tree(jmodel, seed=0):
    """The JAX init plus seeded numpy noise on every leaf, so that the
    zero-initialised layers carry signal too."""
    rng = np.random.default_rng(seed)
    init = eager(jmodel.init)(jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), init)


def bridged(name, seed=0):
    jmodel = jax_get_model(name, tiny=True)
    params = seeded_tree(jmodel, seed)
    model = get_model(name, tiny=True, device="cpu")
    model.load_state_dict(depthfm_params_from_jax(params, model.cfg),
                          strict=True)
    return jmodel.config, jax.tree.map(jnp.asarray, params), model.eval()


@pytest.fixture(scope="module")
def amodal():
    return bridged("DepthFMAmodal")


@pytest.fixture(scope="module")
def plain():
    return bridged("DepthFM", seed=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(seed, b=2, hw=32):
    rng = np.random.default_rng(seed)
    ims = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    mask = (rng.random((b, hw, hw, 1)) > 0.5).astype(np.float32)
    obs = rng.random((b, hw, hw, 1)).astype(np.float32)
    return ims, mask, obs


# ----------------------------------------------------------------------- ops

@pytest.mark.parametrize("c_in,c_out,hw", [(5, 7, (6, 9)), (16, 8, (4, 4))])
def test_fused_upsample2x_conv(c_in, c_out, hw):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, *hw, c_in), dtype=np.float32)
    w = rng.standard_normal((3, 3, c_in, c_out), dtype=np.float32) * 0.2
    b = rng.standard_normal((c_out,), dtype=np.float32)
    ref = np.asarray(jconv.fused_upsample2x_conv(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    w_oihw = _t(w.transpose(3, 2, 0, 1))
    ours = fused_upsample2x_conv(_t(x), w_oihw, _t(b))
    assert ours.shape == (2, 2 * hw[0], 2 * hw[1], c_out)
    assert np.abs(ours.numpy() - ref).max() <= OP_TOL
    # and the pair it replaces: nearest 2x, then the 3x3 SAME conv
    unfused = conv2d(resize_nearest(_t(x), scale_factor=2.0), w_oihw, _t(b),
                     padding=1)
    assert (ours - unfused).abs().max() <= OP_TOL
    with pytest.raises(ValueError, match="3x3"):
        fused_upsample2x_conv(_t(x), w_oihw[..., :2, :2])


def test_conv2d_vae_downsampler_padding():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    w = rng.standard_normal((3, 3, 4, 6), dtype=np.float32)
    p = {"w": jnp.asarray(w)}
    ref = np.asarray(jconv.conv2d(
        p, jnp.pad(jnp.asarray(x), ((0, 0), (0, 1), (0, 1), (0, 0))),
        stride=2, padding="VALID"))
    ours = conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), stride=2,
                  padding=((0, 1), (0, 1))).numpy()
    assert ours.shape == ref.shape == (1, 4, 4, 6)
    assert np.abs(ours - ref).max() <= OP_TOL


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)  # flow time
    ref = np.asarray(junet.timestep_embedding(jnp.asarray(t), dim))
    ours = tunet.timestep_embedding(_t(t), dim).numpy()
    assert ours.shape == (5, dim)
    assert np.abs(ours - ref).max() <= OP_TOL


@pytest.mark.parametrize("kw", [
    {}, {"model_channels": 32, "channel_mult": (1, 2), "num_heads": 2},
    {"channel_mult": (1, 2, 4), "attention_resolutions": (2,),
     "num_res_blocks": 1}])
def test_build_plan(kw):
    assert tunet.build_plan(tunet.UNetConfig(**kw)) == \
        junet.build_plan(junet.UNetConfig(**kw))


@pytest.mark.parametrize("spec", [None, "", 0, "0", 2, "2", "2,2", (4, 1),
                                  [2, 3], "0,2"])
def test_parse_deep_cache_accepts_what_the_jax_one_does(spec):
    assert parse_deep_cache(spec) == jax_parse_deep_cache(spec)


@pytest.mark.parametrize("spec", ["x", "2,y", "1.5", "2,2,2", (1, 2, 3),
                                  -1, "-2", "2,0", (2, -1), "-1,2"])
def test_parse_deep_cache_rejects_malformed_and_non_positive(spec):
    with pytest.raises(ValueError):
        parse_deep_cache(spec)


@pytest.mark.parametrize("t", [0.0, 400.0, 999.0])
def test_q_sample(t):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 4), dtype=np.float32)
    noise = rng.standard_normal((2, 4, 4, 4), dtype=np.float32)
    ref = np.asarray(jfm.q_sample(jnp.asarray(x), t, jnp.asarray(noise)))
    ours = tfm.q_sample(_t(x), t, _t(noise)).numpy()
    assert np.abs(ours - ref).max() <= OP_TOL
    ab = tfm.cosine_alpha_bar(torch.tensor(t / 1000.0)).item()
    assert abs(ab - float(jfm.cosine_alpha_bar(jnp.float32(t / 1000.0)))) \
        <= OP_TOL


# -------------------------------------------------------------------- models

def _unet_inputs(cfg, seed=5, b=2, hw=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 4), dtype=np.float32)
    context = rng.standard_normal(
        (b, hw, hw, cfg.unet.in_channels - 4), dtype=np.float32)
    ca = rng.standard_normal((b, cfg.context_len, cfg.context_dim),
                             dtype=np.float32)
    t = np.array([0.25, 0.75], np.float32)[:b]
    return x, t, context, ca


@pytest.mark.parametrize("rescale", [False, True])
def test_unet_forward(amodal, rescale):
    cfg, params, model = amodal
    x, t, context, ca = _unet_inputs(cfg)
    jcfg = dataclasses.replace(cfg.unet, rescale_self_attention=rescale)
    ref = np.asarray(junet.apply_unet(
        params["unet"], jcfg, jnp.asarray(x), jnp.asarray(t),
        context=jnp.asarray(context), context_ca=jnp.asarray(ca),
        attn_impl="xla"))
    unet = tunet.UNetModel(dataclasses.replace(
        model.cfg.unet, rescale_self_attention=rescale))
    unet.load_state_dict(model.unet.state_dict(), strict=True)
    with torch.no_grad():
        ours = unet(_t(x), _t(t), context=_t(context),
                    context_ca=_t(ca)).numpy()
    assert ours.shape == ref.shape == (2, 8, 8, 4)
    assert ref.std() > 0.05
    assert np.abs(ours - ref).max() <= TOL


def test_unet_rescaled_self_attention_differs(amodal):
    cfg, _, model = amodal
    x, t, context, ca = _unet_inputs(cfg)
    unet = tunet.UNetModel(dataclasses.replace(
        model.cfg.unet, rescale_self_attention=True))
    unet.load_state_dict(model.unet.state_dict(), strict=True)
    with torch.no_grad():
        args = (_t(x), _t(t))
        kw = {"context": _t(context), "context_ca": _t(ca)}
        assert (unet(*args, **kw) - model.unet(*args, **kw)).abs().max() > 1e-4


@pytest.mark.parametrize("groups", [1, 2])
def test_unet_deep_cache_groups(amodal, groups):
    cfg, params, model = amodal
    x, t, context, ca = _unet_inputs(cfg, seed=6)
    jkw = dict(context=jnp.asarray(context), context_ca=jnp.asarray(ca),
               attn_impl="xla", deep_cache_groups=groups)
    ref_y, ref_deep = junet.apply_unet(params["unet"], cfg.unet,
                                       jnp.asarray(x), jnp.asarray(t), **jkw)
    kw = dict(context=_t(context), context_ca=_t(ca),
              deep_cache_groups=groups)
    with torch.no_grad():
        y, deep = model.unet(_t(x), _t(t), **kw)
        assert np.abs(y.numpy() - np.asarray(ref_y)).max() <= TOL
        assert np.abs(deep.numpy() - np.asarray(ref_deep)).max() <= TOL
        # the spliced pass on the same (x, t) reproduces the full pass
        again = model.unet(_t(x), _t(t), cached_deep=deep, **kw)
        assert (again - y).abs().max() <= 1e-6
        # and on a later step it follows the JAX package's spliced pass
        x2 = x + 0.1
        t2 = t + 0.25
        ref2 = np.asarray(junet.apply_unet(
            params["unet"], cfg.unet, jnp.asarray(x2), jnp.asarray(t2),
            cached_deep=ref_deep, **jkw))
        ours2 = model.unet(_t(x2), _t(t2), cached_deep=deep, **kw).numpy()
    assert np.abs(ours2 - ref2).max() <= TOL


def test_unet_rejects_bad_deep_cache_groups_and_left_out_options(amodal):
    cfg, params, model = amodal
    x, t, context, ca = map(_t, _unet_inputs(cfg))
    kw = {"context": context, "context_ca": ca}
    for groups in (0, 6):
        with pytest.raises(ValueError, match="deep_cache_groups"):
            model.unet(x, t, deep_cache_groups=groups, **kw)
    # token merging (ToMe-SD) is ported: the JAX UNet's output under the
    # same (ratio, min_tokens), at both levels (64 and 16 tokens), and
    # an approximation of the plain output
    tome = (0.5, 16)
    ref = np.asarray(jax.jit(lambda p, *a: junet.apply_unet(
        p, cfg.unet, a[0], a[1], context=a[2], context_ca=a[3],
        attn_impl="xla", tome=tome))(
            params["unet"], *(jnp.asarray(v.numpy())
                              for v in (x, t, context, ca))))
    with torch.no_grad():
        ours = model.unet(x, t, tome=tome, **kw).numpy()
        plain = model.unet(x, t, **kw).numpy()
    assert np.abs(ours - ref).max() <= TOL
    assert np.abs(ours - plain).max() > TOL
    # remat (per-level recompute) runs: the same output, and under grad the
    # same gradients as without it
    with torch.no_grad():
        torch.testing.assert_close(model.unet(x, t, remat=True, **kw),
                                   model.unet(x, t, **kw), rtol=0, atol=0)
    grads = []
    for remat in (False, True):
        model.unet.zero_grad()
        model.unet(x, t, remat=remat, **kw).square().sum().backward()
        grads.append(model.unet.out[2].weight.grad.clone())
    model.unet.zero_grad(set_to_none=True)
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-6)


def test_group_norm_gcd_rule():
    rng = np.random.default_rng(7)
    for c in (48, 20, 64):
        x = rng.standard_normal((2, 3, 5, c), dtype=np.float32) * 3 + 1
        scale = rng.standard_normal((c,), dtype=np.float32)
        bias = rng.standard_normal((c,), dtype=np.float32)
        ref = np.asarray(junet.group_norm(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            jnp.asarray(x)))
        ours = tunet.group_norm(_t(x), _t(scale), _t(bias)).numpy()
        assert np.abs(ours - ref).max() <= OP_TOL


def test_vae_encode_and_decode(amodal):
    cfg, params, model = amodal
    ims, _, _ = _scene(8)
    ref_lat = np.asarray(jvae.vae_encode_mode(params["vae"], jnp.asarray(ims),
                                              cfg.vae))
    with torch.no_grad():
        lat = model.vae.encode_mode(_t(ims)).numpy()
    assert lat.shape == ref_lat.shape == (2, 16, 16, 4)
    assert np.abs(lat - ref_lat).max() <= TOL
    ref_img = np.asarray(jvae.vae_decode(params["vae"], jnp.asarray(ref_lat),
                                         cfg.vae))
    with torch.no_grad():
        img = model.vae.decode(_t(ref_lat)).numpy()
    assert img.shape == ref_img.shape == (2, 32, 32, 3)
    assert ref_img.std() > 0.05
    assert np.abs(img - ref_img).max() <= TOL


@pytest.mark.parametrize("deep_cache", [None, (2, 1)])
def test_depthfm_generate(amodal, deep_cache):
    cfg, params, model = amodal
    ims, mask, obs = _scene(9)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jfm.depthfm_generate(
        params, cfg, key, jnp.asarray(ims), num_steps=2,
        guide_mask=jnp.asarray(mask), observation=jnp.asarray(obs),
        attn_impl="xla", deep_cache=deep_cache))
    noise = np.asarray(jax.random.normal(key, (2, 16, 16, 4), jnp.float32))
    with torch.no_grad():
        ours = tfm.depthfm_generate(
            model, _t(noise), _t(ims), num_steps=2, guide_mask=_t(mask),
            observation=_t(obs), deep_cache=deep_cache).numpy()
    assert ours.shape == ref.shape == (2, 32, 32, 1)
    assert ref.std() > 0.01 and ours.min() >= 0.0 and ours.max() <= 1.0
    assert np.abs(ours - ref).max() <= TOL


def test_depthfm_generate_through_the_registry_entry(amodal):
    _, _, model = amodal
    ims, mask, obs = map(_t, _scene(9))
    noise = torch.randn(2, 16, 16, 4,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(ims, noise, guide_mask=mask, observation=obs, num_steps=2)
        b = tfm.depthfm_generate(model, noise, ims, num_steps=2,
                                 guide_mask=mask, observation=obs)
        # a CPU generator with the same seed draws that same noise
        c = model(ims, torch.Generator().manual_seed(0), guide_mask=mask,
                  observation=obs, num_steps=2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode='train' needs the target"):
        model(ims, noise, mode="train")
    with pytest.raises(ValueError, match="guide_mask required"):
        model(ims, noise, observation=obs)
    with pytest.raises(ValueError, match="observation required"):
        model(ims, noise, guide_mask=mask)
    with pytest.raises(ValueError, match="deep_cache interval"):
        model(ims, noise, guide_mask=mask, observation=obs, num_steps=3,
              deep_cache=(2, 1))
    with pytest.raises(ValueError, match="latents' shape"):
        model(ims, noise[:1], guide_mask=mask, observation=obs)


@pytest.mark.parametrize("ensemble", [1, 2])
def test_depthfm_predict_depth(plain, ensemble):
    cfg, params, model = plain
    ims, _, _ = _scene(10, b=1)
    key = jax.random.PRNGKey(12)
    ref = np.asarray(jfm.depthfm_predict_depth(
        params, cfg, key, jnp.asarray(ims), num_steps=2,
        ensemble_size=ensemble, attn_impl="xla"))
    noise = np.asarray(jax.random.normal(key, (ensemble, 16, 16, 4),
                                         jnp.float32))
    with torch.no_grad():
        ours = tfm.depthfm_predict_depth(
            model, _t(noise), _t(ims), num_steps=2,
            ensemble_size=ensemble).numpy()
    assert ours.shape == ref.shape == (1, 32, 32, 1)
    assert ours.min() == 0.0 and abs(ours.max() - 1.0) <= 1e-6
    assert np.abs(ours - ref).max() <= TOL


def test_predict_depth_needs_the_unguided_model(amodal):
    _, _, model = amodal
    ims, _, _ = _scene(10, b=1)
    with pytest.raises(ValueError, match="unguided"):
        tfm.depthfm_predict_depth(model, torch.Generator().manual_seed(0),
                                  _t(ims))


def test_get_model_names_configs_and_device():
    for name, guide, in_ch in (("DepthFMAmodal", "mask+observation", 10),
                               ("DepthFM", "none", 8)):
        model = get_model(name, tiny=True, device="cpu")
        jcfg = jax_get_model(name, tiny=True).config
        assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jcfg)
        assert model.cfg.guide_type == guide
        assert model.unet.input_blocks[0][0].weight.shape[1] == in_ch
        assert all(p.device.type == "cpu" for p in model.parameters())
    over = get_model("DepthFMAmodal", tiny=True, device="cpu",
                     cfg_overrides={"num_heads": 4, "guide_type": "mask"})
    assert over.cfg.num_heads == 4 and over.cfg.additional_dim == 1
    full = tfm.DepthFMConfig()
    assert dataclasses.asdict(full) == dataclasses.asdict(jfm.DepthFMConfig())
    assert tfm.GUIDE_LATENT_DIMS == jfm.GUIDE_LATENT_DIMS
