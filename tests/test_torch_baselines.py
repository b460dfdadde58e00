"""The port's baselines (ADDeepLab, PartialCompletionContentDPT,
InvisibleStitch, JoUNet) on the CPU against the JAX package's models at
their tiny presets, f32, on the same weights (the port's seeded init with seeded noise
on every leaf, carried by the weight bridge) and the same numpy-seeded
inputs: forward in eval and in train mode, the BatchNorm running statistics
after a train-mode forward against the JAX `new_bn`, the bridge both ways,
and the reference-layout loaders on state dicts built as the JAX package's
converter tests build them.

Tolerance: max abs <= 1e-4 of max(1, the output's max abs) (sums in
another order; ZoeDepth's metric depth is a sum of bin centres of a few
metres), running statistics <= 1e-5; the bridge and the loaders are exact.
Plain attention on both sides (the JAX "xla" path)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.convert.emit_torch import emit_zoedepth_sd
from amodal_depth_anything_tpu.models import beit as jbeit
from amodal_depth_anything_tpu.models import deeplab as jdeeplab
from amodal_depth_anything_tpu.models import jo_dpt as jjo_dpt
from amodal_depth_anything_tpu.models import jo_unet as jjo_unet
from amodal_depth_anything_tpu.models import resnet as jresnet
from amodal_depth_anything_tpu.models import zoedepth as jzoe
from amodal_depth_anything_tpu.models.resnet import _bn as jax_bn
from amodal_depth_anything_tpu_torch.convert.jo_dpt_convert import \
    jo_dpt_state_dict
from amodal_depth_anything_tpu_torch.convert.weights import (
    baseline_params_from_jax, baseline_params_to_jax)
from amodal_depth_anything_tpu_torch.convert.zoedepth_convert import \
    zoedepth_state_dict
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.models.resnet import BatchNorm2d
from tests.test_torch_models import few_torch_threads  # noqa: F401

NAMES = ("ADDeepLab", "PartialCompletionContentDPT", "InvisibleStitch",
         "JoUNet")
BN_NAMES = ("ADDeepLab", "JoUNet")


def _jax_cfg(port_cfg, jax_cls, **nested):
    d = {f.name: getattr(port_cfg, f.name)
         for f in dataclasses.fields(port_cfg)}
    for key, cls in nested.items():
        d[key] = _jax_cfg(d[key], cls)
    return jax_cls(**d)


def jax_side(name, cfg):
    """(init(key) -> tree, apply(tree, inputs, train) -> (out, new_bn))
    of the JAX package at the port's config `cfg`."""
    if name == "ADDeepLab":
        jc = _jax_cfg(cfg, jdeeplab.ADDeepLabConfig,
                      resnet=jresnet.ResNetConfig)

        def init(key):
            p, bn = jdeeplab.init_addeeplab(key, jc)
            return {"params": p, "bn": bn}

        def apply(tree, inp, train):
            return jdeeplab.apply_addeeplab(
                tree["params"], tree["bn"], jc, inp["x"],
                guide_mask=inp["mask"], train=train, attn_impl="xla")
    elif name == "PartialCompletionContentDPT":
        jc = _jax_cfg(cfg, jjo_dpt.JoDPTConfig)

        def init(key):
            p, bn = jjo_dpt.init_jo_dpt(key, jc)
            return {"params": p, "bn": bn}

        def apply(tree, inp, train):
            return jjo_dpt.apply_jo_dpt(tree["params"], tree["bn"], jc,
                                        inp["x"], inp["mask"], train=train,
                                        attn_impl="xla")
    elif name == "InvisibleStitch":
        jc = _jax_cfg(cfg, jzoe.ZoeDepthConfig, backbone=jbeit.BEiTConfig)

        def init(key):
            return jzoe.init_invisible_stitch(key, jc)

        def apply(tree, inp, train):
            return jzoe.apply_invisible_stitch(
                tree, jc, inp["x"], invisible_mask=inp["mask"],
                observation=inp["obs"]), None
    else:
        jc = _jax_cfg(cfg, jjo_unet.JoUNetConfig)

        def init(key):
            p, bn = jjo_unet.init_jo_unet(key, jc)
            return {"params": p, "bn": bn}

        def apply(tree, inp, train):
            return jjo_unet.apply_jo_unet(tree["params"], tree["bn"], jc,
                                          inp["x"], train=train)
    return init, jax.jit(apply, static_argnums=2)


def noisy_tree(tree, seed=0):
    """The JAX init with seeded noise on every leaf (zero-initialised
    layers then carry signal); running variances stay positive."""
    rng = np.random.default_rng(seed)

    def walk(node, in_bn):
        if isinstance(node, dict):
            return {k: walk(v, in_bn or k == "bn") for k, v in node.items()}
        a = np.asarray(node, np.float32)
        n = rng.standard_normal(a.shape).astype(np.float32)
        if in_bn and a.ndim == 1 and np.all(a == 1.0):
            return (a * np.exp(0.2 * n)).astype(np.float32)
        return (a + (0.1 if in_bn else 0.05) * n).astype(np.float32)
    return walk(tree, False)


def port_call(name, model, inp, train):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    if name == "ADDeepLab":
        return model(t["x"], t["mask"], train=train, attn_impl="plain")
    if name == "PartialCompletionContentDPT":
        return model(t["x"], guide_mask=t["mask"], train=train,
                     attn_impl="plain")
    if name == "InvisibleStitch":
        return model(t["x"], invisible_mask=t["mask"], observation=t["obs"])
    return model(t["x"], train=train)


def inputs(hw, seed=1, b=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.random((b, hw, hw, 3), dtype=np.float32),
            "mask": (rng.random((b, hw, hw, 1)) > 0.5).astype(np.float32),
            "obs": rng.random((b, hw, hw, 1), dtype=np.float32)}


@pytest.fixture(scope="module")
def pairs():
    """name -> (port model, JAX tree, JAX apply) at the tiny presets. The
    weights are the port's seeded init taken to the JAX layout by the
    bridge, with seeded noise on every leaf: both packages start from
    them, and no JAX init runs (op by op it took about a minute)."""
    out = {}
    for name in NAMES:
        model = get_model(name, tiny=True, device="cpu")
        model.init_weights_(torch.Generator().manual_seed(0))
        _, apply = jax_side(name, model.cfg)
        tree = noisy_tree(baseline_params_to_jax(name, model.state_dict(),
                                                 model.cfg))
        out[name] = (model, tree, apply)
    return out


def _fresh(pairs, name):
    model, tree, apply = pairs[name]
    model.load_state_dict(baseline_params_from_jax(name, tree, model.cfg),
                          strict=True)
    return model, tree, apply


def _close(ours, ref, tol=1e-4):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("hw", [64, 96])
@pytest.mark.parametrize("name,train", [
    (name, train) for name in NAMES for train in (False, True)
    if not (name == "InvisibleStitch" and train)])  # it has no train mode
def test_forward_matches_jax(pairs, name, hw, train):
    """96 px resamples jo_dpt's pos embed and the BEiT bias table (grid 6
    against the native 4)."""
    model, tree, apply = _fresh(pairs, name)
    inp = inputs(hw)
    with jax.default_matmul_precision("highest"):
        ref, _ = apply(tree, inp, train)
    with torch.no_grad():
        ours = port_call(name, model, inp, train)
    if name == "ADDeepLab":
        for o, r in zip(ours, ref):
            _close(o, r)
    else:
        _close(ours, ref)


@pytest.mark.parametrize("name", BN_NAMES + ("PartialCompletionContentDPT",))
def test_running_stats_after_a_train_forward_match_jax(pairs, name):
    """ADDeepLab and JoUNet move their running statistics as the JAX
    `new_bn`; jo_dpt's SPADE statistics stay where they are, as the JAX
    registry leaves them (it drops `new_bn`)."""
    model, tree, apply = _fresh(pairs, name)
    inp = inputs(64, seed=2)
    _, new_bn = apply(tree, inp, True)
    with torch.no_grad():
        port_call(name, model, inp, True)
    sd = baseline_params_to_jax(name, model.state_dict(), model.cfg)
    expect = tree["bn"] if name == "PartialCompletionContentDPT" else new_bn
    flat_ours = dict(_leaves(sd["bn"]))
    flat_ref = dict(_leaves(jax.tree.map(np.asarray, expect)))
    assert flat_ours.keys() == flat_ref.keys()
    for key, ref in flat_ref.items():
        np.testing.assert_allclose(flat_ours[key], ref, rtol=0, atol=1e-5,
                                   err_msg=key)


def _leaves(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val)


@pytest.mark.parametrize("name", NAMES)
def test_bridge_round_trip_is_exact(pairs, name):
    model, tree, _ = pairs[name]
    sd = baseline_params_from_jax(name, tree, model.cfg)
    assert set(sd) == set(model.state_dict())
    back = baseline_params_to_jax(name, sd, model.cfg)
    a, b = dict(_leaves(tree)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_batch_norm_follows_the_jax_rule(dtype):
    """The port's BatchNorm against the JAX `_bn` (f32 statistics whatever
    the input's dtype; running stats with the unbiased variance); in f32
    `nn.BatchNorm2d` agrees with both."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 6, 5, 4)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.random(4, dtype=np.float32) + 0.5,
         "bias": rng.standard_normal(4).astype(np.float32)}
    s = {"mean": rng.standard_normal(4).astype(np.float32),
         "var": rng.random(4, dtype=np.float32) + 0.5}
    bn = BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    jx = jax.numpy.asarray(x, dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    ref, new_s = jax_bn(p, s, jx, True)
    with torch.no_grad():
        ours = bn(tx, train=True)
    tol = 1e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), new_s["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new_s["var"],
                               atol=1e-6)
    if dtype == np.float32:
        lib = torch.nn.BatchNorm2d(4, momentum=0.1)
        with torch.no_grad():
            lib.weight.copy_(bn.weight)
            lib.bias.copy_(bn.bias)
            lib.running_mean.copy_(torch.from_numpy(s["mean"]))
            lib.running_var.copy_(torch.from_numpy(s["var"]))
            y = lib(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(y.numpy(), ours.numpy(), atol=1e-5)
        np.testing.assert_allclose(lib.running_var.numpy(),
                                   bn.running_var.numpy(), atol=1e-6)


def test_zoedepth_reference_loader_reads_the_jax_emitter(pairs):
    model, tree, _ = pairs["InvisibleStitch"]
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in emit_zoedepth_sd(tree).items()}
    assert all(k.startswith("module.") for k in sd)
    ours = zoedepth_state_dict(sd, model)
    ref = baseline_params_from_jax("InvisibleStitch", tree, model.cfg)
    assert ours.keys() == ref.keys()
    for key in ref:
        torch.testing.assert_close(ours[key], ref[key], rtol=0, atol=0)
    model.load_state_dict(ours, strict=True)


def _jo_dpt_reference_sd(params, bn, depth):
    """The jo_amodal DPT checkpoint layout, built as
    tests/test_convert_jo_dpt.py builds it."""
    sd: dict = {}

    def lin(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).T
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def conv(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        if "b" in p:
            sd[f"{name}.bias"] = np.asarray(p["b"])

    def convt(name, p):
        sd[f"{name}.weight"] = np.asarray(p["w"]).transpose(0, 3, 1, 2)
        sd[f"{name}.bias"] = np.asarray(p["b"])

    def ln(name, p):
        sd[f"{name}.weight"] = np.asarray(p["scale"])
        sd[f"{name}.bias"] = np.asarray(p["bias"])

    bb = "model.pretrained.model"
    conv(f"{bb}.patch_embed.proj", params["patch_embed"]["proj"])
    sd[f"{bb}.cls_token"] = params["cls_token"]
    sd[f"{bb}.pos_embed"] = params["pos_embed"]
    ln(f"{bb}.norm", params["norm"])
    for i in range(depth):
        blk = jax.tree.map(lambda a: a[i], params["blocks"])
        b = f"{bb}.blocks.{i}"
        ln(f"{b}.norm1", blk["norm1"])
        lin(f"{b}.attn.qkv", blk["attn"]["qkv"])
        lin(f"{b}.attn.proj", blk["attn"]["proj"])
        ln(f"{b}.norm2", blk["norm2"])
        lin(f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        lin(f"{b}.mlp.fc2", blk["mlp"]["fc2"])
    for i in range(4):
        ap = f"model.pretrained.act_postprocess{i + 1}"
        lin(f"{ap}.0.project.0", params["readout"][str(i)])
        conv(f"{ap}.3", params["reassemble"][str(i)]["project"])
    convt("model.pretrained.act_postprocess1.4",
          params["reassemble"]["0"]["resize"])
    convt("model.pretrained.act_postprocess2.4",
          params["reassemble"]["1"]["resize"])
    conv("model.pretrained.act_postprocess4.4",
         params["reassemble"]["3"]["resize"])
    for i in range(1, 5):
        conv(f"model.scratch.layer{i}_rn", params["scratch"][f"layer{i}_rn"])
        r = params["scratch"][f"refinenet{i}"]
        for u in ("resConfUnit1", "resConfUnit2"):
            conv(f"model.scratch.refinenet{i}.{u}.conv1", r[u]["conv1"])
            conv(f"model.scratch.refinenet{i}.{u}.conv2", r[u]["conv2"])
        conv(f"model.scratch.refinenet{i}.out_conv", r["out_conv"])
    oc = params["scratch"]["output_conv"]
    conv("model.scratch.output_conv.0", oc["conv1"])
    conv("model.scratch.output_conv.2", oc["conv2"])
    conv("model.scratch.output_conv.4", oc["conv3"])
    for i in range(1, 5):
        s = f"model.spade_fusion{i}"
        sp = params["spade"][str(i)]
        conv(f"{s}.mlp_shared.0", sp["mlp_shared"])
        conv(f"{s}.mlp_gamma", sp["mlp_gamma"])
        conv(f"{s}.mlp_beta", sp["mlp_beta"])
        sd[f"{s}.param_free_norm.running_mean"] = bn[str(i)]["mean"]
        sd[f"{s}.param_free_norm.running_var"] = bn[str(i)]["var"]
    # the auxiliary feature conv the converters drop
    sd["model.d_feat.weight"] = np.zeros((80, 16, 1, 1), np.float32)
    return sd


def test_jo_dpt_reference_loader_matches_the_bridge(pairs):
    model, tree, apply = pairs["PartialCompletionContentDPT"]
    sd = _jo_dpt_reference_sd(tree["params"], tree["bn"], model.cfg.depth)
    ours = jo_dpt_state_dict(sd, model)
    ref = baseline_params_from_jax("PartialCompletionContentDPT", tree,
                                   model.cfg)
    assert ours.keys() == ref.keys()
    for key in ref:
        torch.testing.assert_close(ours[key], ref[key], rtol=0, atol=0)
    model.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_each_baseline_on_the_card_unless_asked(name,
                                                                monkeypatch):
    seen = []
    from amodal_depth_anything_tpu_torch import models
    monkeypatch.setattr(models, "_built",
                        lambda cls, cfg, device: seen.append(device))
    get_model(name)
    get_model(name, device="cpu", tiny=True)
    assert seen == ["cuda", "cpu"]
