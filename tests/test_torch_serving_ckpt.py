"""Port serving-state checkpoints (`pipeline/serving_ckpt.py`) against the
JAX package's.

One serving state feeds both packages: a state the JAX `save_serving`
writes serves in the port's `load_serving`, and one the port writes serves
in the JAX `load_serving` (through its flat sidecar), outputs within 1e-4
of the other package's pipeline on the same weights (tiny vitt pipelines at
56 px, the tiny DepthFM preset at 32 px, float32, plain attention on the
CPU; the DepthFM noise is JAX's draw, handed to the port). A port round trip
is bit-exact on every tensor, bfloat16 included, and keeps each dtype.
Wrong-kind, int8 and ToMe states are refused."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.pipeline import \
    AmodalDepthPipeline as JaxAmodalDepthPipeline
from amodal_depth_anything_tpu.pipeline import \
    DepthFMPipeline as JaxDepthFMPipeline
from amodal_depth_anything_tpu.pipeline.serving_ckpt import \
    save_serving_state as jax_save_serving_state
from amodal_depth_anything_tpu_torch.convert.weights import (
    depthfm_params_from_jax, depthfm_params_to_jax, params_from_jax,
    params_to_jax)
from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
    DAV2Config, build_model, init_weights_)
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
    DepthFMPipeline
from amodal_depth_anything_tpu_torch.pipeline.serving_ckpt import (
    flatten_tree, restore_serving_state, save_serving_state)
from tests.test_torch_depthfm_pipeline import SEED, _inputs
from tests.test_torch_depthfm_pipeline import _noise as jax_noise
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_pipeline import _jcfg

TOL = 1e-4
SIZE = 56
RAW_CFG = DAV2Config(encoder="vitt", guide_type="none", raw=True)
AMODAL_CFG = DAV2Config(encoder="vitt", guide_type="mask+observation")
HW = (40, 48)


def amodal_params(seed=0):
    """Seeded JAX-layout trees (numpy) of the tiny raw base and AmodalDAv2:
    the port's init with numpy noise on every leaf, so the zero-initialised
    layers carry signal too (cheaper than the JAX init's compile)."""
    return tuple(
        _noisy(params_to_jax(init_weights_(
            build_model(cfg), torch.Generator().manual_seed(seed)
        ).state_dict(), cfg), seed + i)
        for i, cfg in enumerate((RAW_CFG, AMODAL_CFG)))


def port_amodal(params, dtype=torch.float32, attn_impl="plain"):
    """The port's tiny amodal pipeline on the CPU with `params`."""
    models = []
    for cfg, p in zip((RAW_CFG, AMODAL_CFG), params):
        model = build_model(cfg)
        model.load_state_dict(params_from_jax(p, cfg), strict=True)
        models.append(model)
    return AmodalDepthPipeline(*models, size=SIZE, device="cpu", dtype=dtype,
                               attn_impl=attn_impl)


def jax_amodal(params, dtype=jnp.float32):
    return JaxAmodalDepthPipeline(params[0], _jcfg(RAW_CFG), params[1],
                                  _jcfg(AMODAL_CFG), size=SIZE,
                                  attn_impl="xla", dtype=dtype)


def amodal_inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((batch, *HW, 3)) * 255).astype(np.float32)
    msk = (rng.random((batch, *HW)) > 0.5).astype(np.float32)
    return img, msk


@pytest.fixture(scope="module")
def amodal_pipes():
    params = amodal_params()
    return params, jax_amodal(params), port_amodal(params)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), tree)


def depthfm_pair(seed=3):
    """The tiny DepthFMAmodal of both packages on one seeded JAX-layout
    tree (the port's init with numpy noise), 32 px, 2 steps, seed SEED."""
    model = DepthFMPipeline.init_random(seed, device="cpu").model
    params = _noisy(depthfm_params_to_jax(model.state_dict(), model.cfg),
                    seed)
    model.load_state_dict(depthfm_params_from_jax(params, model.cfg),
                          strict=True)
    jpipe = JaxDepthFMPipeline(
        params, jax_get_model("DepthFMAmodal", tiny=True).config, size=32,
        num_steps=2, attn_impl="xla", seed=SEED)
    pipe = DepthFMPipeline(model, size=32, num_steps=2, seed=SEED,
                           device="cpu", attn_impl="plain")
    return params, jpipe, pipe


@pytest.fixture(scope="module")
def depthfm_pipes():
    return depthfm_pair()


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    assert np.abs(ours - ref).max() <= TOL, np.abs(ours - ref).max()


def _run(kind, pipe, *, port: bool) -> tuple:
    """A pipeline's outputs on fixed inputs, as a tuple; the port's DepthFM
    gets JAX's noise."""
    if kind == "amodal":
        return tuple(pipe(*amodal_inputs()))
    img, mask, obs = _inputs(0, batch=2)
    if port:
        return (pipe(img, mask, obs, noise=jax_noise(2, 16, 16, 4)),)
    return (pipe(img, mask, obs),)


@pytest.mark.parametrize("kind", ["amodal", "depthfm"])
def test_jax_state_serves_in_the_port(kind, amodal_pipes, depthfm_pipes,
                                      tmp_path):
    _, jpipe, _ = amodal_pipes if kind == "amodal" else depthfm_pipes
    path = str(tmp_path / "state")
    jpipe.save_serving(path)
    cls = AmodalDepthPipeline if kind == "amodal" else DepthFMPipeline
    pipe = cls.load_serving(path, device="cpu")
    assert pipe.attn_impl == "plain" and pipe.dtype == torch.float32
    assert pipe.device == torch.device("cpu")
    if kind == "depthfm":
        assert (pipe.seed, pipe.num_steps, pipe.size) == (SEED, 2, 32)
    for ours, ref in zip(_run(kind, pipe, port=True),
                         _run(kind, jpipe, port=False)):
        _close(ours, ref)


@pytest.mark.parametrize("kind", ["amodal", "depthfm"])
def test_port_state_serves_in_jax(kind, amodal_pipes, depthfm_pipes,
                                  tmp_path):
    _, jpipe, pipe = amodal_pipes if kind == "amodal" else depthfm_pipes
    path = str(tmp_path / "state")
    pipe.save_serving(path)
    assert not os.path.exists(os.path.join(path, "params"))  # flat only
    cls = JaxAmodalDepthPipeline if kind == "amodal" else JaxDepthFMPipeline
    loaded = cls.load_serving(path)
    assert loaded.attn_impl == "xla"
    # the JAX pipeline on the port's state is the one the weights came
    # from, bit for bit, and within 1e-4 of the port
    for ours, theirs, want in zip(_run(kind, pipe, port=True),
                                  _run(kind, loaded, port=False),
                                  _run(kind, jpipe, port=False)):
        _close(ours, theirs)
        np.testing.assert_array_equal(theirs, want)


def _assert_same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_port_round_trip_is_bit_exact(dtype, tmp_path):
    params = amodal_params(seed=4)
    pipe = port_amodal(params, dtype=dtype, attn_impl=None)
    pipe.save_serving(str(tmp_path / "amodal"))
    back = AmodalDepthPipeline.load_serving(str(tmp_path / "amodal"),
                                            device="cpu")
    assert back.dtype == dtype and back.attn_impl is None
    _assert_same_state(pipe.raw_model.state_dict(),
                       back.raw_model.state_dict())
    _assert_same_state(pipe.amodal_model.state_dict(),
                       back.amodal_model.state_dict())
    for a, b in zip(pipe(*amodal_inputs(seed=2)),
                    back(*amodal_inputs(seed=2))):
        np.testing.assert_array_equal(a, b)

    model = DepthFMPipeline.init_random(5, device="cpu").model
    dfm = DepthFMPipeline(model, size=32, num_steps=2, device="cpu",
                          dtype=dtype, deep_cache="2,1", seed=11)
    dfm.save_serving(str(tmp_path / "depthfm"))
    back = DepthFMPipeline.load_serving(str(tmp_path / "depthfm"),
                                        device="cpu")
    assert (back.dtype, back.deep_cache, back.seed, back.cfg) == \
        (dtype, (2, 1), 11, model.cfg)
    _assert_same_state(dfm.model.state_dict(), back.model.state_dict())
    img, mask, obs = _inputs(3, batch=2)
    np.testing.assert_array_equal(dfm(img, mask, obs), back(img, mask, obs))


def test_jax_bfloat16_state_keeps_its_bits_in_the_port(amodal_pipes,
                                                       tmp_path):
    params, _, _ = amodal_pipes
    jpipe = jax_amodal(params, dtype=jnp.bfloat16)
    jpipe.save_serving(str(tmp_path / "state"))
    pipe = AmodalDepthPipeline.load_serving(str(tmp_path / "state"),
                                            device="cpu")
    assert pipe.dtype == torch.bfloat16
    for model, cfg, jtree in ((pipe.raw_model, RAW_CFG, jpipe.params_raw),
                              (pipe.amodal_model, AMODAL_CFG,
                               jpipe.params_amodal)):
        ours = flatten_tree(params_to_jax(model.state_dict(), cfg,
                                          tensors=True))
        theirs = flatten_tree(jax.tree.map(np.asarray, jtree))
        assert ours.keys() == theirs.keys()
        for key, leaf in ours.items():
            assert leaf.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          theirs[key].astype(np.float32))


def test_restore_gives_the_saved_leaves_and_dtypes(tmp_path):
    trees = {"params": {"a": {"w": torch.arange(6.0).reshape(2, 3)},
                        "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
                        "c": torch.arange(4, dtype=torch.float16)}}
    save_serving_state(str(tmp_path), trees, {"kind": "test"})
    back, meta = restore_serving_state(str(tmp_path), expect_kind="test",
                                       device="cpu")
    assert meta == {"kind": "test"}
    _assert_same_state(flatten_tree(trees), flatten_tree(back))
    plan = json.loads((tmp_path / "flat" / "plan.json").read_text())
    assert [c["dtype"] for c in plan["chunks"]] == \
        ["float32", "bfloat16", "float16"]


def test_wrong_kind_int8_and_tome_states_are_refused(amodal_pipes, tmp_path):
    _, _, pipe = amodal_pipes
    path = str(tmp_path / "amodal")
    pipe.save_serving(path)
    with pytest.raises(ValueError, match="expected 'depthfm'"):
        DepthFMPipeline.load_serving(path, device="cpu")

    meta_path = os.path.join(path, "serving_meta.json")
    meta = json.load(open(meta_path))
    for knob, value in (("base_token_merge", [2, 8]), ("head_batch_tile", 2)):
        json.dump(dict(meta, **{knob: value}), open(meta_path, "w"))
        with pytest.raises(NotImplementedError, match="ToMe"):
            AmodalDepthPipeline.load_serving(path, device="cpu")

    int8 = str(tmp_path / "int8")   # as the JAX package writes a W8A8 state
    jax_save_serving_state(int8, {"raw": {"w": np.zeros(4, np.int8),
                                          "s": np.ones(1, np.float32)}}, meta)
    with pytest.raises(NotImplementedError, match="int8"):
        AmodalDepthPipeline.load_serving(int8, device="cpu")


def test_bridge_keeps_dtype_and_round_trips():
    params = amodal_params(seed=6)[1]
    sd = params_from_jax(params, AMODAL_CFG)
    bf16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    tree = params_to_jax(bf16, AMODAL_CFG, tensors=True)
    back = params_from_jax(tree, AMODAL_CFG)
    _assert_same_state(bf16, back)
    # float32 numpy leaves in, float32 tensors out, and the numpy result of
    # `params_to_jax` is the tensor result, bit for bit
    assert all(v.dtype == torch.float32 for v in sd.values())
    tensors = flatten_tree(params_to_jax(sd, AMODAL_CFG, tensors=True))
    for key, leaf in flatten_tree(params_to_jax(sd, AMODAL_CFG)).items():
        assert leaf.dtype == np.float32, key
        np.testing.assert_array_equal(leaf, tensors[key].numpy())
    model = DepthFMPipeline.init_random(7, device="cpu").model
    sd = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    back = depthfm_params_from_jax(
        depthfm_params_to_jax(sd, model.cfg, tensors=True), model.cfg)
    _assert_same_state(sd, back)
