"""Port DepthFMPipeline vs the JAX package's, and the DepthFM weight bridge.

Host arrays in and out on both sides; the JAX pipeline draws its q_sample
noise from PRNGKey(seed), so the test draws the same array and hands it to
the port (`noise=`). float32, plain attention on the CPU, max abs <= 1e-4:
on the tiny model with seeded numpy weights and once on the trained in-repo
proxy (`checkpoints/proxy/depthfm.npz`)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.convert.emit_torch import (emit_unet_sd,
                                                          emit_vae_sd)
from amodal_depth_anything_tpu.models import depthfm as jfm
from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.pipeline import \
    DepthFMPipeline as JaxDepthFMPipeline
from amodal_depth_anything_tpu.scripts.train_proxy import \
    load_params_npz as jax_load_params_npz
from amodal_depth_anything_tpu_torch.convert.weights import (
    depthfm_params_from_jax, depthfm_params_to_jax, load_depthfm_checkpoints,
    load_depthfm_proxy)
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
    DepthFMPipeline
from tests.test_torch_depthfm import seeded_tree
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-4
SEED = 7
PROXY_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "checkpoints",
                         "proxy")


def _inputs(seed, hw=(40, 48), batch=None):
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    img = (rng.random((*lead, *hw, 3)) * 255).astype(np.uint8)
    mask = (rng.random((*lead, *hw)) > 0.5).astype(np.float32)
    obs = rng.random((*lead, *hw)).astype(np.float32)
    return img, mask, obs


def _noise(*shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(SEED), shape,
                                        jnp.float32))


def _pair(name, seed=0, **kw):
    jmodel = jax_get_model(name, tiny=True)
    params = seeded_tree(jmodel, seed)
    model = get_model(name, tiny=True, device="cpu")
    model.load_state_dict(depthfm_params_from_jax(params, model.cfg))
    jpipe = JaxDepthFMPipeline(params, jmodel.config, size=32, num_steps=2,
                               attn_impl="xla", seed=SEED, **kw)
    pipe = DepthFMPipeline(model, size=32, num_steps=2, seed=SEED,
                           device="cpu", **kw)
    return params, jpipe, pipe


@pytest.fixture(scope="module")
def amodal_pair():
    return _pair("DepthFMAmodal")


def test_call_matches_jax_pipeline(amodal_pair):
    _, jpipe, pipe = amodal_pair
    img, mask, obs = _inputs(0, batch=2)
    ref = jpipe(img, mask, obs)
    ours = pipe(img, mask, obs, noise=_noise(2, 16, 16, 4))
    assert ours.shape == ref.shape == (2, 32, 32)
    assert ours.dtype == np.float32 and ref.std() > 0.01
    assert ours.min() >= 0.0 and ours.max() <= 1.0
    assert np.abs(ours - ref).max() <= TOL
    # unbatched in, unbatched out
    one = pipe(img[0], mask[0], obs[0], noise=_noise(2, 16, 16, 4)[:1])
    assert one.shape == (32, 32)
    assert np.abs(one - ours[0]).max() <= 1e-5


def test_call_with_deep_cache_matches_jax_pipeline():
    _, jpipe, pipe = _pair("DepthFMAmodal", seed=2, deep_cache="2,1")
    assert pipe.deep_cache == jpipe.deep_cache == (2, 1)
    img, mask, obs = _inputs(1)
    ref = jpipe(img, mask, obs)
    ours = pipe(img, mask, obs, noise=_noise(1, 16, 16, 4))
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("ensemble", [1, 2])
def test_predict_depth_matches_jax_pipeline(ensemble):
    _, jpipe, pipe = _pair("DepthFM", seed=1)
    img, _, _ = _inputs(2)
    ref = jpipe.predict_depth(img, ensemble_size=ensemble, num_steps=2)
    ours = pipe.predict_depth(img, ensemble_size=ensemble, num_steps=2,
                              noise=_noise(ensemble, 16, 16, 4))
    assert ours.shape == ref.shape == (32, 32)
    assert ours.min() == 0.0 and abs(ours.max() - 1.0) <= 1e-6
    assert np.abs(ours - ref).max() <= TOL


def test_trained_proxy_matches_jax_pipeline():
    with open(os.path.join(PROXY_DIR, "depthfm_meta.json")) as f:
        meta = json.load(f)
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in meta["overrides"].items()}
    jcfg = jfm.DepthFMConfig(guide_type="mask+observation", **over)
    params = jax_load_params_npz(os.path.join(PROXY_DIR, "depthfm.npz"))
    jpipe = JaxDepthFMPipeline(params, jcfg, size=meta["size"], num_steps=2,
                               attn_impl="xla", seed=SEED)
    model = load_depthfm_proxy(os.path.join(PROXY_DIR, "depthfm.npz"),
                               device="cpu")
    assert model.cfg.model_channels == 48 and model.cfg.num_heads == 4
    pipe = DepthFMPipeline(model, size=meta["size"], num_steps=2, seed=SEED,
                           device="cpu")
    img, mask, obs = _inputs(3, hw=(50, 70))
    ref = jpipe(img, mask, obs)
    ours = pipe(img, mask, obs, noise=_noise(1, 8, 8, 4))
    assert ours.shape == ref.shape == (64, 64)
    assert ref.std() > 0.01
    assert np.abs(ours - ref).max() <= TOL


def test_seed_fixes_the_noise_and_differs_between_seeds(amodal_pair):
    _, _, pipe = amodal_pair
    img, mask, obs = _inputs(4)
    a, b = pipe(img, mask, obs), pipe(img, mask, obs)
    np.testing.assert_array_equal(a, b)
    other = DepthFMPipeline(pipe.model, size=32, num_steps=2, seed=SEED + 1,
                            device="cpu")
    assert np.abs(other(img, mask, obs) - a).max() > 1e-4


def test_weight_bridge_round_trip(amodal_pair):
    params, _, pipe = amodal_pair
    cfg = pipe.cfg
    sd = depthfm_params_from_jax(params, cfg)
    assert set(sd) == set(pipe.model.state_dict())
    back = depthfm_params_to_jax(sd, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_reference_layout_checkpoints_load(tmp_path, amodal_pair):
    """A depthfm-v1.ckpt-layout file (8-channel conv-in) and a diffusers VAE
    state dict, as the JAX package's emitters write them."""
    params, _, pipe = amodal_pair
    jcfg = jax_get_model("DepthFMAmodal", tiny=True).config
    unet_sd = emit_unet_sd(params["unet"], jcfg.unet)
    conv_in = unet_sd["input_blocks.0.0.weight"]
    unet_sd["input_blocks.0.0.weight"] = conv_in[:, :8]   # as released
    ckpt = {"state_dict": {k: torch.from_numpy(np.array(v))
                           for k, v in unet_sd.items()},
            "ldm_hparams": {"context_dim": jcfg.context_dim,
                            "model_channels": jcfg.model_channels,
                            "channel_mult": list(jcfg.channel_mult),
                            "num_heads": jcfg.num_heads},
            "noising_step": jcfg.noising_step,
            "empty_text_embedding": torch.from_numpy(
                np.array(params["empty_text_embed"][0]))}
    vae_sd = {k: torch.from_numpy(np.array(v))
              for k, v in emit_vae_sd(params["vae"]).items()}
    ckpt_path, vae_path = tmp_path / "depthfm.ckpt", tmp_path / "vae.bin"
    torch.save(ckpt, ckpt_path)
    torch.save(vae_sd, vae_path)

    loaded = DepthFMPipeline.from_checkpoints(
        str(ckpt_path), str(vae_path), size=32, num_steps=2, seed=SEED,
        device="cpu")
    assert loaded.cfg == pipe.cfg      # VAE topology and context_len inferred
    want = depthfm_params_from_jax(params, pipe.cfg)
    want["unet.input_blocks.0.0.weight"][:, 8:] = 0.0   # zero-widened
    got = loaded.model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)
    # the dict forms load too, and the pipeline runs on what was loaded
    again = load_depthfm_checkpoints(ckpt, vae_sd, device="cpu")
    torch.testing.assert_close(again.vae.quant_conv.weight,
                               got["vae.quant_conv.weight"], rtol=0, atol=0)
    img, mask, obs = _inputs(5)
    assert np.isfinite(loaded(img, mask, obs)).all()


def test_missing_guides_raise(amodal_pair):
    _, _, pipe = amodal_pair
    img, mask, obs = _inputs(6)
    with pytest.raises(ValueError, match="requires mask"):
        pipe(img, None, obs)
    with pytest.raises(ValueError, match="requires observation"):
        pipe(img, mask, None)
    image_guided = DepthFMPipeline.init_random(
        0, guide_type="image+mask", device="cpu")
    with pytest.raises(ValueError, match="requires guide_rgb"):
        image_guided(img, mask)
    out = image_guided(img, mask, guide_rgb=img)
    assert out.shape == (32, 32) and np.isfinite(out).all()


def test_device_cpu_is_honoured_and_bf16_runs():
    pipe = DepthFMPipeline.init_random(3, device="cpu",
                                       dtype=torch.bfloat16)
    assert pipe.device == torch.device("cpu")
    assert all(p.device.type == "cpu" and p.dtype == torch.bfloat16
               for p in pipe.model.parameters())
    img, mask, obs = _inputs(7, batch=2)
    out = pipe(img, mask, obs)
    assert out.shape == (2, 32, 32) and out.dtype == np.float32
    assert np.isfinite(out).all() and out.std() > 0


@pytest.mark.parametrize("option", ["tome", "mesh", "quantize_int8",
                                    "save_serving", "load_serving"])
def test_left_out_options_raise_not_implemented(amodal_pair, option,
                                                tmp_path):
    """These options all run in the port now (the name is that of the
    test that held the mesh's refusal). A one-rank `mesh` gives the call
    without one, bit for bit (data parallelism over ranks:
    tests/test_torch_parallel_ranks.py). ToMe-SD (`tome`) matches the JAX
    pipeline; `quantize_int8` runs (its
    parity is held in tests/test_torch_quant.py); a state saved with ToMe
    on ("save_serving") restores it, and a weight-only int8 state the JAX
    package writes ("load_serving") holds the port's own w8 codes and
    serves its result (<= 1e-4; the JAX package quantises under jit, whose
    scales can differ from an eager division in the last bit)."""
    import copy
    import functools
    import json

    from amodal_depth_anything_tpu.ops.quant import quantize_diffusion_int8
    from amodal_depth_anything_tpu.pipeline.serving_ckpt import \
        save_serving_state as jax_save_serving_state
    params, jpipe, pipe = amodal_pair
    img, mask, obs = _inputs(4, batch=2)
    noise = _noise(2, 16, 16, 4)

    def port(model=None, **kw):
        return DepthFMPipeline(copy.deepcopy(model or pipe.model), size=32,
                               num_steps=2, seed=SEED, device="cpu", **kw)

    if option == "mesh":
        from amodal_depth_anything_tpu_torch.parallel import make_mesh
        ours = port(mesh=make_mesh())
        assert np.array_equal(ours(img, mask, obs, noise=noise),
                              pipe(img, mask, obs, noise=noise))
    elif option == "tome":
        jp = JaxDepthFMPipeline(params, jpipe.cfg, size=32, num_steps=2,
                                attn_impl="xla", seed=SEED, tome=(0.5, 16))
        ours = port(tome=(0.5, 16))
        assert ours.tome == jp.tome == (0.5, 16)
        ref = jp(img, mask, obs)
        out = ours(img, mask, obs, noise=noise)
        assert np.abs(out - ref).max() <= TOL
        assert np.abs(out - pipe(img, mask, obs, noise=noise)).max() > TOL
    elif option == "quantize_int8":
        ours = port()
        ours.quantize_int8()
        kinds = {type(m).__name__ for m in ours.model.modules()}
        assert "QuantConv2d" in kinds   # the tiny widths have no wide linear
        out = ours(img, mask, obs, noise=noise)
        assert np.isfinite(out).all() and out.shape == (2, 32, 32)
    elif option == "save_serving":
        ours = port(tome=0.5)
        assert ours.tome == (0.5, 4096)
        ours.tome = (0.5, 16)
        ours.save_serving(str(tmp_path / "state"))
        meta = json.loads((tmp_path / "state" / "serving_meta.json")
                          .read_text())
        assert meta["tome"] == [0.5, 16]
        back = DepthFMPipeline.load_serving(str(tmp_path / "state"),
                                            device="cpu")
        assert back.tome == (0.5, 16)
        np.testing.assert_array_equal(back(img, mask, obs, noise=noise),
                                      ours(img, mask, obs, noise=noise))
    else:   # a weight-only int8 state as the JAX package writes it
        state = tmp_path / "state"
        pipe.save_serving(str(state))
        meta = json.loads((state / "serving_meta.json").read_text())
        tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
            quantize_diffusion_int8, weight_only=True))(params))
        jax_save_serving_state(str(state), {"params": tree}, meta)
        back = DepthFMPipeline.load_serving(str(state), device="cpu")
        own = port()
        own.quantize_int8(weight_only=True)
        codes = {k: v for k, v in back.model.state_dict().items()
                 if v.dtype == torch.int8}
        assert codes and all(torch.equal(v, own.model.state_dict()[k])
                             for k, v in codes.items())
        assert np.abs(back(img, mask, obs, noise=noise)
                      - own(img, mask, obs, noise=noise)).max() <= TOL
