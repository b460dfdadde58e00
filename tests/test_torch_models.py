"""Port models (block, trunk, DPT head, AmodalDAv2 / raw DAV2) vs the JAX
package on the same weights and inputs.

The JAX package's init gives the parameter tree; seeded numpy noise on
every leaf makes biases, norms, layer scales, the guidance embed and the
transposed convs non-trivial; `params_from_jax` carries the tree across.
Max abs <= 1e-4, the bar of tests/test_full_model_parity.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.convert.emit_torch import emit_dav2_sd
from amodal_depth_anything_tpu.convert.torch_to_jax import \
    infer_dav2_config as jax_infer_dav2_config
from amodal_depth_anything_tpu.models import amodal_dav2 as jdav2
from amodal_depth_anything_tpu.models.dinov2 import (
    dinov2_intermediate_layers, init_dinov2)
from amodal_depth_anything_tpu.models.dpt import dpt_head, init_dpt_head
from amodal_depth_anything_tpu.models.layers import vit_block
from amodal_depth_anything_tpu_torch.convert.weights import (
    infer_dav2_config, params_from_jax)
from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
    DAV2Config, build_model, init_weights_)
from amodal_depth_anything_tpu_torch.models.dinov2 import \
    DinoVisionTransformer
from amodal_depth_anything_tpu_torch.models.layers import Block

TOL = 1e-4
RAW = dict(guide_type="none", raw=True)
GUIDED = dict(guide_type="mask+observation")


def eager(fn):
    """`fn` without its `jax.jit` (the function it wraps): a JAX init run
    op by op draws the same threefry bits as the jitted one and skips a
    compile that costs the CPU tests seconds (the tests compare the port
    with the JAX package on whichever values it gives)."""
    return getattr(fn, "__wrapped__", fn)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes,
    and torch's default of one thread per core oversubscribes the CPU.
    One parallel op then brings those threads up before any test computes:
    on a loaded machine the first parallel op of a process can compute one
    thread's share with other bits (seen on `torch.logsumexp` inside
    `mha_reference`: half the rows off by up to 4.2e-5, in about one fresh
    process in seven), enough to fail a 1e-5 parity check."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    torch.ones(1 << 17).exp_().sum()
    yield
    torch.set_num_threads(n)


def _jax_cfg(cfg: DAV2Config):
    return jdav2.DAV2Config(**dataclasses.asdict(cfg))


def _params(cfg: DAV2Config, seed=0, *, head: bool = True):
    """JAX-layout params (numpy leaves) with noise on every leaf.

    `head=False` swaps the DPT head for a narrow one (same keys, vitt
    widths): tests of the trunk or of key layout then skip the 1536-channel
    vitg head."""
    rng = np.random.default_rng(seed)
    jcfg = _jax_cfg(cfg)
    key = jax.random.PRNGKey(seed)
    tree = {"backbone": init_dinov2(key, jcfg.vit),
            "depth_head": init_dpt_head(key, jcfg.dpt if head else
                                        dataclasses.replace(
                                            jcfg.dpt, features=16,
                                            out_channels=(8, 16, 32, 32)))}
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), tree)


def _model(cfg: DAV2Config, params):
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model.eval()


def _inputs(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((b, h, w, 3), dtype=np.float32)
    m = (rng.random((b, h, w, 1)) > 0.5).astype(np.float32) * 2 - 1
    o = rng.random((b, h, w, 1), dtype=np.float32) * 2 - 1
    return x, m, o


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, tol=TOL):
    ours, ref = ours.detach().numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.isfinite(ours).all()
    assert np.abs(ours - ref).max() <= tol, np.abs(ours - ref).max()


@pytest.mark.parametrize("cfg", [
    DAV2Config(encoder="vitt", **RAW),                        # mlp block
    # vitg-shaped SwiGLU block, narrowed (4 heads of 32)
    DAV2Config(encoder="vitg", embed_dim=128, depth=4, **RAW),
], ids=["mlp", "swiglufused"])
def test_vit_block_matches_jax(cfg):
    params = _params(cfg, seed=1, head=False)
    p0 = jax.tree.map(lambda a: a[0], params["backbone"]["blocks"])
    vit = cfg.vit
    blk = Block(vit.embed_dim, vit.num_heads, ffn=vit.ffn)
    prefix = "pretrained.blocks.0."
    blk.load_state_dict({k[len(prefix):]: v for k, v in
                         params_from_jax(params, cfg).items()
                         if k.startswith(prefix)}, strict=True)
    x = np.random.default_rng(2).standard_normal((2, 17, vit.embed_dim),
                                                 dtype=np.float32)
    ref = vit_block(jax.tree.map(jnp.asarray, p0), jnp.asarray(x),
                    num_heads=vit.num_heads, ffn=vit.ffn, attn_impl="xla")
    with torch.no_grad():
        _close(blk(_t(x)), ref)


@pytest.mark.parametrize("cfg,hw", [
    (DAV2Config(encoder="vitt", **RAW), (56, 56)),
    (DAV2Config(encoder="vitt", **GUIDED), (56, 84)),   # non-square grid
    # narrowed vitg trunk: SwiGLU blocks, taps remapped onto depth 4
    (DAV2Config(encoder="vitg", embed_dim=64, depth=4, **RAW), (42, 42)),
], ids=["vitt-raw", "vitt-guided", "vitg-narrow"])
def test_dinov2_intermediate_layers_match_jax(cfg, hw):
    params = _params(cfg, seed=3, head=False)
    trunk = DinoVisionTransformer(cfg.vit)
    prefix = "pretrained." if cfg.raw else "encoder.pretrained."
    trunk.load_state_dict({k[len(prefix):]: v for k, v in
                           params_from_jax(params, cfg).items()
                           if k.startswith(prefix)}, strict=True)
    x, m, o = _inputs(2, *hw, seed=4)
    guide = np.concatenate([m, o], -1) if not cfg.raw else None
    ref = dinov2_intermediate_layers(
        jax.tree.map(jnp.asarray, params["backbone"]), _jax_cfg(cfg).vit,
        jnp.asarray(x),
        None if guide is None else jnp.asarray(guide), cfg.taps,
        attn_impl="xla")
    with torch.no_grad():
        ours = trunk.get_intermediate_layers(
            _t(x), None if guide is None else _t(guide), cfg.taps)
    assert len(ours) == len(ref) == 4
    for (tok, cls), (rtok, rcls) in zip(ours, ref):
        _close(tok, rtok)
        _close(cls, rcls)


@pytest.mark.parametrize("cfg", [DAV2Config(encoder="vitt", **RAW),
                                 DAV2Config(encoder="vitt", **GUIDED)],
                         ids=["raw-relu", "guided-sigmoid"])
def test_dpt_head_matches_jax(cfg):
    params = _params(cfg, seed=5)
    model = _model(cfg, params)
    rng = np.random.default_rng(6)
    d, ph, pw = cfg.vit.embed_dim, 4, 5
    feats = [(rng.standard_normal((2, ph * pw, d), dtype=np.float32),
              rng.standard_normal((2, d), dtype=np.float32))
             for _ in range(4)]
    ref = dpt_head(jax.tree.map(jnp.asarray, params["depth_head"]),
                   _jax_cfg(cfg).dpt,
                   [(jnp.asarray(t), jnp.asarray(c)) for t, c in feats],
                   (ph, pw))
    head = model.depth_head if cfg.raw else model.encoder.depth_head
    with torch.no_grad():
        ours = head([(_t(t), _t(c)) for t, c in feats], (ph, pw))
    assert ours.shape == (2, 14 * ph, 14 * pw, 1)
    _close(ours, ref)


@pytest.mark.parametrize("guided", [False, True], ids=["raw", "guided"])
def test_full_model_matches_jax(guided):
    cfg = DAV2Config(encoder="vitt", **(GUIDED if guided else RAW))
    params = _params(cfg, seed=7)
    model = _model(cfg, params)
    x, m, o = _inputs(2, 56, 56, seed=8)
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        if guided:
            ref = jdav2.apply_amodal_dav2(
                jp, _jax_cfg(cfg), jnp.asarray(x), guide_mask=jnp.asarray(m),
                observation=jnp.asarray(o), attn_impl="xla")
            ours = model(_t(x), guide_mask=_t(m), observation=_t(o))
        else:
            ref = jdav2.apply_raw_dav2(jp, _jax_cfg(cfg), jnp.asarray(x),
                                       attn_impl="xla")
            ours = model(_t(x))
    _close(ours, ref)


@pytest.mark.parametrize("cfg", [
    DAV2Config(encoder="vitt", **RAW),
    DAV2Config(encoder="vitt", **GUIDED),
    DAV2Config(encoder="vitg", embed_dim=64, depth=4, **RAW),
], ids=["vitt-raw", "vitt-guided", "vitg-narrow"])
def test_params_from_jax_matches_reference_layout(cfg):
    """The bridge writes exactly the reference checkpoint layout (the JAX
    package's own emitter), and the port's modules hold exactly its keys."""
    params = _params(cfg, seed=9, head=False)
    ours = params_from_jax(params, cfg)
    ref = emit_dav2_sd(params, _jax_cfg(cfg))
    assert set(ours) == set(ref)
    for key, val in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), val, err_msg=key)
    assert set(build_model(cfg).state_dict()) == set(ref)


@pytest.mark.parametrize("cfg", [
    DAV2Config(encoder="vitt", **RAW),
    DAV2Config(encoder="vitt", **GUIDED),
    DAV2Config(encoder="vitp", **GUIDED),     # the proxies' width 128
    DAV2Config(encoder="vitt", guide_type="mask"),
])
def test_infer_dav2_config_matches_jax(cfg):
    sd = emit_dav2_sd(_params(cfg, head=False), _jax_cfg(cfg))
    ours = infer_dav2_config(sd)
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        jax_infer_dav2_config(sd))


@pytest.mark.parametrize("encoder,depth", [("vitg", 4), ("vitg", 7),
                                           ("vitl", 5), ("vitl", None)])
def test_taps_match_jax(encoder, depth):
    cfg = DAV2Config(encoder=encoder, depth=depth, **GUIDED)
    assert cfg.taps == _jax_cfg(cfg).taps


def test_init_weights_is_seeded():
    cfg = DAV2Config(encoder="vitt", **GUIDED)

    def init(seed):
        return init_weights_(build_model(cfg),
                             torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = init(3), init(3), init(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    qkv = "encoder.pretrained.blocks.0.attn.qkv.weight"
    assert not torch.equal(a[qkv], c[qkv])
    assert a[qkv].abs().max() <= 0.04          # trunc-normal(0.02) at 2 std
    guidance = "encoder.pretrained.patch_embed_guidance.proj.weight"
    assert not a[guidance].any()               # zero-init guidance embed
    assert torch.equal(a["encoder.pretrained.blocks.0.ls1.gamma"],
                       torch.ones(cfg.vit.embed_dim))


@pytest.mark.parametrize("name", ["AmodalDAv2", "DepthAnythingV2Raw"])
def test_registry_builds_on_the_card_unless_asked_for_the_cpu(name):
    """The discriminative builders default to "cuda", as DepthFM's does;
    `device="cpu"` puts every parameter on the CPU."""
    import inspect

    from amodal_depth_anything_tpu_torch.models import (MODEL_REGISTRY,
                                                        get_model)

    default = inspect.signature(MODEL_REGISTRY[name]).parameters["device"]
    assert default.default == "cuda"
    model = get_model(name, encoder="vitt", device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
