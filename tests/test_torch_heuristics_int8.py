"""The port's heuristics int8 paths against the JAX package: the
pix2gestalt UNet and SAM quantised by both packages (codes, scales, the
one-step flips of the jitted walk counted), a quantised heuristics serving
state written by JAX and restored by the port, and the captured
completions dropped by quantisation. The tiny stack and its bars are
`tests/test_torch_heuristics.py`'s (split from it so that the test workers
share the load)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.heuristics import mask_heuristics as jmh
from amodal_depth_anything_tpu.models import clip_vit as jclip
from amodal_depth_anything_tpu.models import sam as jsam
from amodal_depth_anything_tpu_torch.convert.weights import (
    p2g_params_from_jax, p2g_params_to_jax, sam_params_to_jax)
from amodal_depth_anything_tpu_torch.heuristics import MaskHeuristics
from amodal_depth_anything_tpu_torch.models.pix2gestalt import (
    Pix2Gestalt, Pix2GestaltConfig)
from amodal_depth_anything_tpu_torch.pipeline.serving_ckpt import \
    flatten_tree
from tests.test_torch_heuristics import (PROXY, TOL, _cfg, _jax_completion,
                                         _jax_noise, _scene, _t, stack)
from tests.test_torch_models import few_torch_threads  # noqa: F401

__all__ = ["stack"]


# ------------------------------------------------------------------ int8
#
# `quantize_p2g_int8` / `quantize_sam_int8` against the JAX package's: the
# same sites with the same int8 codes and scales (the JAX layout through the
# bridge), and the completion on the trained proxy at 64 px, three DDIM
# steps, the JAX noise handed over. The JAX methods jit their walk, and XLA
# computes amax / 127 as amax x (1/127): a scale may sit one ulp off the
# eager value, which the port computes, and a weight on a .5 boundary then
# gets a code one step away. So each layer kind is held exact against the
# JAX quantiser run eagerly, the whole trees code for code against the
# jitted walk with such flips counted, and the outputs run on the JAX tree
# carried over the bridge. W8A8 replays the JAX package's activation codes
# (`tests/test_torch_quant.py`).

P2G_INT8 = {"w8": dict(weight_only=True, bits=8),
            "w4": dict(weight_only=True, bits=4),
            "int8": dict(weight_only=False)}


@pytest.fixture(scope="module")
def p2g_proxy_pair(stack):
    """(JAX MaskHeuristics, its completion config, port MaskHeuristics): the
    trained pix2gestalt proxy at 64 px, three DDIM steps, beside the tiny
    stack's SAM."""
    import json

    from amodal_depth_anything_tpu.pipeline.serving_ckpt import cfg_from_dict
    from amodal_depth_anything_tpu.scripts.train_proxy import load_params_npz
    from amodal_depth_anything_tpu_torch.convert.weights import \
        load_p2g_proxy

    j0, t0, _ = stack
    with open(PROXY[:-4] + "_meta.json") as f:
        meta = json.load(f)
    jcfg = dataclasses.replace(
        cfg_from_dict(jmh.Pix2GestaltConfig, meta["p2g_cfg"]),
        image_size=64, ddim_steps=3)
    jh = jmh.MaskHeuristics(
        j0.sam_params, j0.sam_cfg,
        jax.tree.map(jnp.asarray, load_params_npz(PROXY)), jcfg,
        clip_cfg=cfg_from_dict(jclip.CLIPVisionConfig, meta["clip_cfg"]),
        vae_cfg=cfg_from_dict(jmh.VAEConfig, meta["vae_cfg"]))
    th = MaskHeuristics(t0.sam, load_p2g_proxy(PROXY, device="cpu"))
    th.p2g_cfg = _cfg(Pix2GestaltConfig, jcfg)
    return jh, jcfg, th


def _same_codes(mine: dict, ref: dict, record_property=None):
    """Two quantised JAX-layout trees: the same leaves and dtypes, int8
    codes at most one step apart (the flips counted, at most 1e-3 of the
    codes), everything else within 1e-6 of its max abs."""
    mine = flatten_tree(mine)
    ref = flatten_tree(jax.tree.map(np.asarray, ref))
    assert sorted(mine) == sorted(ref)
    flips = codes = 0
    for key, leaf in ref.items():
        assert mine[key].dtype == leaf.dtype, key
        if leaf.dtype == np.int8:
            a, b = mine[key].astype(np.int16), leaf.astype(np.int16)
            if key.endswith("w4"):   # two signed nibbles a byte
                a = np.stack([((a & 15) ^ 8) - 8, a >> 4])
                b = np.stack([((b & 15) ^ 8) - 8, b >> 4])
            diff = np.abs(a - b)
            assert int(diff.max(initial=0)) <= 1, key
            flips += int((diff > 0).sum())
            codes += leaf.size
        else:
            np.testing.assert_allclose(
                mine[key], leaf, rtol=0,
                atol=1e-6 * max(float(np.abs(leaf).max(initial=0)), 1e-30),
                err_msg=key)
    if record_property is not None:
        record_property("weight_code_flips", f"{flips} of {codes}")
    assert flips <= 1e-3 * codes, (flips, codes)


def _p2g_from_tree(th, tree) -> Pix2Gestalt:
    """The port's pix2gestalt module holding a JAX tree (quantised layers
    swapped in through the bridge)."""
    from amodal_depth_anything_tpu_torch.ops.quant import apply_quantized_

    sd = p2g_params_from_jax(tree, th.p2g_cfg, th.clip_cfg, th.vae_cfg)
    cc = th.p2g.cc_projection
    p2g = Pix2Gestalt(th.p2g_cfg, th.clip_cfg, th.vae_cfg,
                      cc_in=0 if cc is None else cc.in_features,
                      cc_bias=cc is not None and cc.bias is not None)
    apply_quantized_(p2g, sd)
    p2g.load_state_dict(sd, strict=True)
    return p2g.eval()


@pytest.mark.parametrize("mode", list(P2G_INT8))
def test_quantize_p2g_int8_matches_jax(p2g_proxy_pair, mode,
                                       record_property):
    """The proxy UNet quantised by both packages: one conv and one linear
    exactly as the JAX quantiser codes them eagerly, the trees code for
    code, and the JAX tree's completion in the port within 1e-4."""
    import copy

    from amodal_depth_anything_tpu.ops import quant as jq_ops
    from tests.test_torch_quant import _report, jax_code_tape, replayed

    jh, jcfg, th = p2g_proxy_pair
    tq = MaskHeuristics(th.sam, copy.deepcopy(th.p2g))
    tq.p2g_cfg = th.p2g_cfg
    done = tq.quantize_p2g_int8(**P2G_INT8[mode])
    assert set(done.values()) == {mode}
    assert len(done) > 100   # the proxy's 48 channels scale the thresholds
    mine = p2g_params_to_jax(tq.p2g.state_dict(), tq.p2g_cfg, tq.clip_cfg,
                             tq.vae_cfg)["unet"]
    # one layer of each kind, eagerly: the same codes and scales
    quantiser = {"w8": ("quantize_conv_w8", "quantize_linear_w8"),
                 "w4": ("quantize_conv_w4", "quantize_linear_w4"),
                 "int8": ("quantize_conv_int8", "quantize_linear_int8")}
    for path, fn in zip(("input_blocks/1/0/conv1", "time_embed/fc2"),
                        quantiser[mode]):
        node, ours = jh.p2g_params["unet"], mine
        for part in path.split("/"):
            node, ours = node[part], ours[part]
        args = (node,) if mode != "int8" or "conv" in fn else (node, None)
        ref = getattr(jq_ops, fn)(*args)
        for leaf in ("w8", "w4", "w", "w_scale", "w4_scale"):
            if leaf in ref:
                np.testing.assert_array_equal(ours[leaf],
                                              np.asarray(ref[leaf]),
                                              err_msg=f"{path}/{leaf}")

    jq = copy.copy(jh)
    jq.p2g_params = dict(jh.p2g_params)
    jq.quantize_p2g_int8(**P2G_INT8[mode])
    _same_codes(mine, jq.p2g_params["unet"], record_property)
    image, _ = _scene(20, 48, 72)
    visible = np.zeros(image.shape[:2], bool)
    visible[10:40, 20:50] = True
    with jax_code_tape() as tape:
        ref_out = _jax_completion(jq, jcfg, image, visible, seed=5)
    bridged = MaskHeuristics(th.sam, _p2g_from_tree(
        th, jax.tree.map(np.asarray, jq.p2g_params)))
    bridged.p2g_cfg = th.p2g_cfg
    noise = _jax_noise(5, 64, 4)
    if mode == "int8":
        with replayed(tape) as flips:
            got = bridged.pix2gestalt_completion(image, visible, noise=noise)
        _report(record_property, flips, tape)
    else:
        assert not tape
        got = bridged.pix2gestalt_completion(image, visible, noise=noise)
    np.testing.assert_allclose(got, np.asarray(ref_out), rtol=0, atol=TOL)
    # the float stack the copies came from is untouched
    assert not any(type(m).__name__.startswith("Quant")
                   for m in th.p2g.modules())


@pytest.mark.parametrize("thresholds", ["released", "narrow"])
def test_quantize_sam_int8_matches_jax(stack, thresholds, record_property):
    """SAM's sites and codes against the JAX walk, and SAM's embedding and
    masks with them (<= 1e-4). "released": `quantize_sam_int8` against the
    JAX method (the tiny preset's few wide layers); "narrow": both walks at
    thresholds the tiny widths reach (every linear and conv but the skipped
    upscaling convs)."""
    import copy

    from amodal_depth_anything_tpu.ops.quant import quantize_diffusion_int8
    from amodal_depth_anything_tpu_torch.convert.weights import \
        sam_layer_paths
    from amodal_depth_anything_tpu_torch.ops.quant import \
        quantize_diffusion_modules

    jh, th, _ = stack
    sam = copy.deepcopy(th.sam)
    if thresholds == "released":
        done = MaskHeuristics(sam, th.p2g).quantize_sam_int8()
        jq = copy.copy(jh)
        jq.quantize_sam_int8()
        ref_tree = jq.sam_params
    else:
        kw = dict(weight_only=True, min_conv_fan=16, min_lin_dim=16,
                  skip_suffixes=("upscale_conv1", "upscale_conv2"))
        done = quantize_diffusion_modules(sam, sam_layer_paths(th.sam_cfg),
                                          **kw)
        ref_tree = jax.jit(functools.partial(quantize_diffusion_int8,
                                             **kw))(jh.sam_params)
    assert done and set(done.values()) == {"w8"}
    assert (len(done) > 20) == (thresholds == "narrow")
    _same_codes(sam_params_to_jax(sam.state_dict(), th.sam_cfg), ref_tree,
                record_property)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    pts = rng.random((1, 5, 2)).astype(np.float32)
    lbl = np.asarray([[1, 0, 1, -1, -1]], np.float32)
    emb = jsam.sam_encode_image(ref_tree, jh.sam_cfg, jnp.asarray(x))
    masks, _ = jsam.sam_predict_masks(ref_tree, jh.sam_cfg, emb,
                                      jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        t_emb = sam.encode_image(_t(x))
        t_masks, _ = sam.predict_masks(t_emb, _t(pts), _t(lbl))
    for got, want in ((t_emb, emb), (t_masks, masks)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)


def test_int8_serving_state_written_by_jax_restores_in_port(
        p2g_proxy_pair, stack, tmp_path):
    """A JAX stack with a w4 pix2gestalt UNet and a w8 SAM, saved by the
    JAX package, restores in the port with the same int8 codes and scales
    in their saved dtypes, gives the completion of the port's own
    quantisation, and saves again bit for bit."""
    import copy

    jh, jcfg, th = p2g_proxy_pair
    jq = copy.copy(jh)
    jq.p2g_params = dict(jh.p2g_params)
    jq.sam_params = stack[0].sam_params
    jq.sam_cfg = stack[0].sam_cfg
    jq.matting_fn = None
    jq.quantize_p2g_int8(bits=4)
    jq.quantize_sam_int8()
    path = str(tmp_path / "jax_int8")
    jq.save_serving(path)
    got = MaskHeuristics.load_serving(path, device="cpu")
    for module, want in ((got.p2g.unet, {"w4"}), (got.sam, {"w8"})):
        assert {m.mode for m in module.modules()
                if type(m).__name__.startswith("Quant")} == want
    for mine, ref in ((p2g_params_to_jax(got.p2g.state_dict(), got.p2g_cfg,
                                         got.clip_cfg, got.vae_cfg),
                       jq.p2g_params),
                      (sam_params_to_jax(got.sam.state_dict(), got.sam_cfg),
                       jq.sam_params)):
        mine, ref = flatten_tree(mine), flatten_tree(
            jax.tree.map(np.asarray, ref))
        assert sorted(mine) == sorted(ref)
        for k, v in ref.items():
            assert mine[k].dtype == v.dtype, k
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
    # the restored stack completes as the JAX stack that wrote it
    image, _ = _scene(24, 48, 72)
    visible = np.zeros(image.shape[:2], bool)
    visible[8:30, 10:60] = True
    np.testing.assert_allclose(
        got.pix2gestalt_completion(image, visible,
                                   noise=_jax_noise(2, 64, 4)),
        np.asarray(_jax_completion(jq, jcfg, image, visible, seed=2)),
        rtol=0, atol=TOL)
    # the port writes the same state back
    again = str(tmp_path / "port_int8")
    got.save_serving(again)
    back = MaskHeuristics.load_serving(again, device="cpu")
    for a, b in ((got.p2g, back.p2g), (got.sam, back.sam)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype, k
            assert torch.equal(sa[k], sb[k]), k


def test_quantize_p2g_int8_drops_the_captured_completions(stack):
    """A completion captured before the quantisation reads the float
    weights: `quantize_p2g_int8` drops every captured one, and a second
    quantisation is refused."""
    import copy

    _, th, _ = stack
    tq = MaskHeuristics(th.sam, copy.deepcopy(th.p2g))
    tq._completions[("stale",)] = object()
    tq.quantize_p2g_int8()
    assert tq._completions == {}
    with pytest.raises(ValueError, match="already quantised"):
        tq.quantize_p2g_int8(bits=4)
