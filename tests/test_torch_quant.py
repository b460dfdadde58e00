"""The port's serving compression (`ops/quant.py`) against the JAX package's.

Same seeded numpy inputs on both sides, float32, HIGHEST precision on the
JAX side (its CPU default for float32):
  * int8, w8 and w4 weight codes, scales and packed nibbles: bit for bit;
  * the int32 accumulators of the int8 linear and convolution: equal; the
    outputs of `int8_linear`, `int8_conv2d`, `w8_*` and `w4_*` <= 1e-6 of
    the reference's max abs;
  * the tiny amodal pipeline (vitt) under calibrated + heads, dynamic +
    heads, SmoothQuant + mixed + families and per-layer masks (LN-bound
    through the mixed mode here and end to end in
    tests/test_torch_serving_ckpt.py) and the tiny DepthFM pipeline under
    three mixed modes (each of w4, w8 and dynamic W8A8 once on the UNet,
    once on the VAE encoder, once on the VAE decoder) and calibrated
    W8A8: the
    port's own quantisation picks the JAX package's sites with the JAX
    package's weight codes, and the port fed the JAX package's quantised
    tree through the bridge gives the JAX output <= 1e-4 of its max abs.
The JAX quantisations are shared by module-scoped fixtures."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops import quant as jq
from amodal_depth_anything_tpu_torch.convert.weights import (
    depthfm_params_from_jax, depthfm_params_to_jax, params_from_jax,
    params_to_jax)
from amodal_depth_anything_tpu_torch.models.amodal_dav2 import build_model
from amodal_depth_anything_tpu_torch.models.depthfm import build_depthfm
from amodal_depth_anything_tpu_torch.ops import quant as Q
from amodal_depth_anything_tpu_torch.ops.conv import Conv2dNHWC, \
    ConvTranspose2dNHWC
from amodal_depth_anything_tpu_torch.models.layers import Linear
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
    DepthFMPipeline
from amodal_depth_anything_tpu_torch.pipeline.serving_ckpt import \
    flatten_tree
from tests.test_torch_depthfm_pipeline import _inputs as depthfm_inputs
from tests.test_torch_depthfm_pipeline import _noise as jax_noise
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_serving_ckpt import (AMODAL_CFG, RAW_CFG, SIZE,
                                           amodal_inputs, amodal_params,
                                           depthfm_pair, jax_amodal,
                                           port_amodal)

OP_TOL = 1e-6      # of the reference's max abs
TOL = 1e-4


def _rel_err(ours, ref) -> float:
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor)
                      else ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.isfinite(ours).all()
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _linear(w_jax, b=None):
    """A port Linear holding JAX [in, out] weight `w_jax`."""
    lin = Linear(w_jax.shape[0], w_jax.shape[1], bias=b is not None)
    with torch.no_grad():
        lin.weight.copy_(_t(w_jax.T))
        if b is not None:
            lin.bias.copy_(_t(b))
    return lin


def _conv(w_hwio, b=None, stride=1, padding=0):
    kh, kw, ci, co = w_hwio.shape
    conv = Conv2dNHWC(ci, co, (kh, kw), stride=stride, padding=padding,
                      bias=b is not None)
    with torch.no_grad():
        conv.weight.copy_(_t(w_hwio.transpose(3, 2, 0, 1)))
        if b is not None:
            conv.bias.copy_(_t(b))
    return conv


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def _jit(fn, **static):
    """`fn` of the JAX package jitted with `static` bound: one compile per
    shape, in place of one per eager op. Not for the quantisers, whose
    codes are held bit for bit: under jit XLA may divide by the scale as a
    multiply by its reciprocal."""
    return jax.jit(functools.partial(fn, **static))


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("kind", ["linear", "conv", "convt"])
def test_int8_weight_codes_and_scales_are_bit_identical(kind, rng):
    if kind == "linear":
        w = rng.standard_normal((96, 40), dtype=np.float32)
        ref = jq.quantize_linear_int8({"w": jnp.asarray(w)}, None)
        ours = Q.quantize_linear_int8(_linear(w))
        codes = ours.weight.numpy().T
    else:   # HWIO conv; [C_in, k, k, C_out] transposed conv (JAX layout)
        w = rng.standard_normal((3, 3, 24, 16) if kind == "conv"
                                else (24, 4, 4, 16), dtype=np.float32)
        ref = jq.quantize_conv_int8({"w": jnp.asarray(w)})
        if kind == "conv":
            ours = Q.quantize_conv_int8(_conv(w))
            codes = ours.weight.numpy().transpose(2, 3, 1, 0)
        else:
            mod = ConvTranspose2dNHWC(24, 16, 4, stride=4)
            with torch.no_grad():
                mod.weight.copy_(_t(w.transpose(0, 3, 1, 2)))
            ours = Q.quantize_conv_int8(mod)
            assert isinstance(ours, Q.QuantConvTranspose2d)
            codes = ours.weight.numpy().transpose(0, 2, 3, 1)
    assert ours.weight.dtype == torch.int8
    np.testing.assert_array_equal(codes, np.asarray(ref["w"]))
    np.testing.assert_array_equal(ours.w_scale.numpy(),
                                  np.asarray(ref["w_scale"]))


@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_w8_codes_are_bit_identical(kind, rng):
    if kind == "linear":
        w = rng.standard_normal((64, 48), dtype=np.float32)
        ref = jq.quantize_linear_w8({"w": jnp.asarray(w)})
        ours = Q.quantize_linear_w8(_linear(w))
        codes = ours.w8.numpy().T
    else:
        w = rng.standard_normal((3, 3, 16, 8), dtype=np.float32)
        ref = jq.quantize_conv_w8({"w": jnp.asarray(w)})
        ours = Q.quantize_conv_w8(_conv(w, padding=1))
        codes = ours.w8.numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(codes, np.asarray(ref["w8"]))
    np.testing.assert_array_equal(ours.w_scale.numpy(),
                                  np.asarray(ref["w_scale"]))


@pytest.mark.parametrize("shape", [(128, 24), (96, 16), (3, 3, 40, 8)],
                         ids=["linear-g64", "linear-g48", "conv-g40"])
def test_w4_packed_nibbles_and_scales_are_bit_identical(shape, rng):
    w = rng.standard_normal(shape, dtype=np.float32)
    if len(shape) == 2:
        ref = jq.quantize_linear_w4({"w": jnp.asarray(w)})
        ours = Q.quantize_linear_w4(_linear(w))
        packed, scale = ours.w4.numpy().T, ours.w4_scale.numpy().T
    else:
        ref = jq.quantize_conv_w4({"w": jnp.asarray(w)})
        ours = Q.quantize_conv_w4(_conv(w, padding=1))
        packed = ours.w4.numpy().transpose(2, 3, 1, 0)
        scale = ours.w4_scale.numpy().T
    assert ours.w4.dtype == torch.int8
    np.testing.assert_array_equal(packed, np.asarray(ref["w4"]))
    np.testing.assert_array_equal(scale, np.asarray(ref["w4_scale"]))
    assert int(ours.w4_group) == ref["w4_group"]


def test_nibble_packing_matches_jax_on_every_pair():
    vals = np.arange(-8, 8, dtype=np.int8)
    pairs = np.stack(np.meshgrid(vals, vals, indexing="ij"), -1).reshape(-1)
    q = pairs.reshape(-1, 1).repeat(3, 1)          # [512, 3], pairs on axis 0
    ref = np.asarray(jq._pack_nibbles(jnp.asarray(q), 0))
    ours = Q.pack_nibbles(_t(q), 0)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(Q.unpack_nibbles(ours, 0).numpy(), q)


# --------------------------------------------------------------- products

@pytest.mark.parametrize("m,k,n", [(5, 27, 13), (40, 64, 24), (3, 8, 8)])
def test_int8_matmul_is_exact_at_padded_shapes(m, k, n, rng):
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    acc = Q.int8_matmul(_t(a), _t(w))
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    np.testing.assert_array_equal(acc.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("mode", ["static", "dynamic", "smooth", "masked"])
def test_int8_linear_matches_jax(mode, rng):
    d_in, d_out = 64, 48
    w = rng.standard_normal((d_in, d_out), dtype=np.float32) * 0.1
    b = rng.standard_normal(d_out, dtype=np.float32) * 0.1
    x = rng.standard_normal((2, 9, d_in), dtype=np.float32) * 2
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    lin = _linear(w, b)
    if mode == "smooth":
        smooth = rng.uniform(0.5, 2.0, d_in).astype(np.float32)
        p["smooth"] = jnp.asarray(smooth)
        lin = Q.QuantLinear({"weight": lin.weight.detach(),
                             "bias": lin.bias.detach(),
                             "smooth": _t(smooth)})
    scale = None if mode == "dynamic" else np.float32(6.0 / 127.0)
    use_q = False if mode == "masked" else None
    ref_q = jq.quantize_linear_int8(
        jax.tree.map(lambda a: a[None], p) if use_q is not None else p,
        None if scale is None else (jnp.asarray([scale]) if use_q is not None
                                    else jnp.asarray(scale)),
        None if use_q is None else jnp.asarray([use_q]))
    if use_q is not None:
        ref_q = jax.tree.map(lambda a: a[0], ref_q)
    ours = Q.quantize_linear_int8(lin, scale, use_q)
    ref = np.asarray(_jit(jq.int8_linear)(ref_q, jnp.asarray(x)))
    with torch.no_grad():
        assert _rel_err(ours(_t(x)), ref) <= OP_TOL
    if mode == "masked":
        return
    # the int32 accumulator, from the same activation codes
    xs = x * (smooth if mode == "smooth" else 1.0)
    s_act = scale if scale is not None else max(np.abs(xs).max() / 127.0,
                                                1e-9)
    xq = np.clip(np.round(xs / np.float32(s_act)), -127, 127).astype(np.int8)
    acc_ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(xq), ref_q["w"], (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    acc = Q.int8_matmul(_t(xq).reshape(-1, d_in), ours.weight)
    np.testing.assert_array_equal(acc.numpy().reshape(acc_ref.shape),
                                  acc_ref)


CONV_CASES = {
    "3x3-pad1": dict(shape=(3, 3, 384, 16), stride=1, padding=1),
    "1x1": dict(shape=(1, 1, 24, 32), stride=1, padding=0),
    "3x3-stride2": dict(shape=(3, 3, 16, 8), stride=2, padding=1),
    "3x3-pad01": dict(shape=(3, 3, 16, 8), stride=2,
                      padding=((0, 1), (0, 1))),
    "fan27": dict(shape=(3, 3, 3, 12), stride=1, padding=1),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_int8_conv2d_matches_jax(case, dynamic, rng):
    c = CONV_CASES[case]
    kh, kw, ci, co = c["shape"]
    w = rng.standard_normal(c["shape"], dtype=np.float32) * 0.1
    b = rng.standard_normal(co, dtype=np.float32) * 0.1
    x = rng.standard_normal((2, 9, 11, ci), dtype=np.float32)
    scale = None if dynamic else np.float32(3.0 / 127.0)
    ref_q = jq.quantize_conv_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  None if scale is None
                                  else jnp.asarray(scale))
    pad = c["padding"]
    ref = np.asarray(_jit(
        jq.int8_conv2d, stride=c["stride"],
        padding=pad if isinstance(pad, int) else tuple(pad))(
            ref_q, jnp.asarray(x)))
    ours = Q.quantize_conv_int8(_conv(w, b, c["stride"], 0), scale)
    with torch.no_grad():
        out = ours.conv(_t(x), stride=c["stride"], padding=pad)
    assert _rel_err(out, ref) <= OP_TOL
    if dynamic:
        return
    # int32 accumulators equal, past 2^24 at the 3x3x384 fan
    xq = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    pads = [(pad, pad)] * 2 if isinstance(pad, int) else list(pad)
    acc_ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), ref_q["w"], (c["stride"],) * 2, pads,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    acc = Q._int8_conv_acc(_t(xq), ours.weight, c["stride"], pad)
    np.testing.assert_array_equal(acc.numpy(), acc_ref)
    if case == "3x3-pad1":
        assert np.abs(acc_ref).max() > 0 and kh * kw * ci * 127 * 127 > 2**24


def test_int8_conv_transpose_is_the_exact_int_product(rng):
    """The JAX package runs an int8 transposed conv on its raw codes (no
    scale; ROADMAP queue 3); the port's is held to the exact W8A8 value."""
    w = rng.standard_normal((24, 8, 4, 4), dtype=np.float32)   # torch layout
    x = rng.standard_normal((2, 3, 5, 24), dtype=np.float32)
    mod = ConvTranspose2dNHWC(24, 8, 4, stride=4)
    with torch.no_grad():
        mod.weight.copy_(_t(w))
        mod.bias.zero_()
    q = Q.quantize_conv_int8(mod)
    with torch.no_grad():
        out = q(_t(x)).numpy().astype(np.float64)
    s_act = np.float32(np.abs(x).max() / 127.0)
    xq = np.clip(np.round(x / s_act), -127, 127).astype(np.int64)
    acc = np.einsum("bhwc,cokl->bhkwlo", xq, q.weight.numpy().astype(np.int64))
    ref = (acc.astype(np.float32) * (s_act * q.w_scale.numpy()))
    ref = ref.reshape(2, 12, 20, 8)
    assert _rel_err(out, ref) <= OP_TOL


@pytest.mark.parametrize("scheme", ["w8", "w4"])
@pytest.mark.parametrize("kind", ["linear", "conv"])
def test_weight_only_layers_match_jax(scheme, kind, rng):
    if kind == "linear":
        w = rng.standard_normal((128, 40), dtype=np.float32) * 0.1
        b = rng.standard_normal(40, dtype=np.float32)
        x = rng.standard_normal((3, 7, 128), dtype=np.float32)
        p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        ref_q = (jq.quantize_linear_w8 if scheme == "w8"
                 else jq.quantize_linear_w4)(p)
        ref = _jit(jq.w8_linear if scheme == "w8" else jq.w4_linear)(
            ref_q, jnp.asarray(x))
        ours = (Q.quantize_linear_w8 if scheme == "w8"
                else Q.quantize_linear_w4)(_linear(w, b))
    else:
        w = rng.standard_normal((3, 3, 64, 16), dtype=np.float32) * 0.1
        b = rng.standard_normal(16, dtype=np.float32)
        x = rng.standard_normal((2, 8, 8, 64), dtype=np.float32)
        p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
        ref_q = (jq.quantize_conv_w8 if scheme == "w8"
                 else jq.quantize_conv_w4)(p)
        ref = _jit(jq.w8_conv2d if scheme == "w8" else jq.w4_conv2d,
                   padding=1)(ref_q, jnp.asarray(x))
        ours = (Q.quantize_conv_w8 if scheme == "w8"
                else Q.quantize_conv_w4)(_conv(w, b, padding=1))
    with torch.no_grad():
        assert _rel_err(ours(_t(x)), np.asarray(ref)) <= OP_TOL


# --------------------------------------------------------------- pipelines
#
# Two float paths agree to ~1e-7 relative, not bit for bit, so now and then
# an activation lands within that distance of a rounding boundary and its
# int8 code differs by one between the packages (a tie that flips). The
# pipeline tests count these flips and report them (`record_property`
# "activation_code_flips"), and hold the port to the JAX output with the
# JAX package's codes replayed at every int8 site, so the bound stays 1e-4.


@contextlib.contextmanager
def jax_code_tape():
    """While a JAX call traces, its int8 sites send the activation codes
    they compute to the host, in program order (ordered debug callbacks);
    yields the list they land in."""
    tape = []
    orig_lin, orig_conv = jq.int8_linear, jq.int8_conv2d
    f32 = jnp.float32

    def send(p, x):
        s = p["act_scale"].astype(f32) if "act_scale" in p else \
            jnp.maximum(jnp.max(jnp.abs(x.astype(f32))) / 127.0, 1e-9)
        codes = jnp.clip(jnp.round(x.astype(f32) / s), -127, 127)
        jax.debug.callback(lambda a: tape.append(np.asarray(a, np.int8)),
                           codes, ordered=True)

    def lin(p, x):
        if "use_q" not in p:     # the masked form dispatches to the plain
            send(p, x * p["smooth"].astype(x.dtype) if "smooth" in p
                 else x)
        return orig_lin(p, x)

    def conv(p, x, **kw):
        send(p, x)
        return orig_conv(p, x, **kw)

    jq.int8_linear, jq.int8_conv2d = lin, conv
    try:
        yield tape
    finally:
        jq.int8_linear, jq.int8_conv2d = orig_lin, orig_conv


@contextlib.contextmanager
def replayed(tape):
    """The port's int8 sites take the taped JAX codes, in call order;
    yields the list of flips (codes of the port's own that differ) per
    site. Every flip is one step."""
    orig = Q._quantize_act
    it = iter(tape)
    flips = []

    def take(x, s):
        ours = orig(x, s)
        ref = torch.from_numpy(next(it)).to(ours.device)
        assert ref.shape == ours.shape, (ref.shape, ours.shape)
        diff = (ours.to(torch.int16) - ref.to(torch.int16)).abs()
        assert int(diff.max()) <= 1
        flips.append(int(diff.sum()))
        return ref

    Q._quantize_act = take
    try:
        yield flips
    finally:
        Q._quantize_act = orig
    assert next(it, None) is None, "the port ran fewer int8 sites"


def _report(record_property, flips, tape):
    n = sum(a.size for a in tape)
    record_property("activation_code_flips", f"{sum(flips)} of {n}")
    assert sum(flips) <= 1e-3 * n, (sum(flips), n)


AMODAL_MODES = {
    # calibrated trunks and heads, blocks masked per model
    "calibrated-head-mask": dict(
        base=True, amodal=True, head=True, calib=True,
        base_layer_mask=[True, False, True, True],
        amodal_layer_mask=[False, True, True, True]),
    "dynamic-head-mask": dict(base=True, amodal=True, head=True,
                              dynamic=True,
                              amodal_layer_mask=[True, True, False, True]),
    # SmoothQuant on proj / ffn2, LN-bound qkv, ffn1 left out (mixed), the
    # base model alone
    "smooth-mixed-families": dict(base=True, amodal=False, calib=True,
                                  smooth_alpha=0.5, mixed=True,
                                  families=("qkv", "proj", "ffn2")),
}


@pytest.fixture(scope="module")
def amodal_setup():
    params = amodal_params(seed=4)
    img, msk = amodal_inputs(batch=2, seed=5)
    return params, img, msk, port_amodal(params)(img, msk)


def _calib(kw, *inputs):
    kw = dict(kw)
    if kw.pop("calib", False):
        kw["calibration"] = inputs
    return kw


@pytest.fixture(scope="module")
def jax_quantized(amodal_setup):
    """{mode: (JAX raw tree, JAX amodal tree, JAX output, code tape of the
    call, code tape of the calibration)}."""
    params, img, msk, _ = amodal_setup
    out = {}
    for mode, kw in AMODAL_MODES.items():
        jp = jax_amodal(params)
        with jax_code_tape() as calib_tape:   # the head's, on int8 trunks
            jp.quantize_int8(**_calib(kw, img, msk))
        with jax_code_tape() as tape:
            ref = jp(img, msk)
        out[mode] = (jax.tree.map(np.asarray, jp.params_raw),
                     jax.tree.map(np.asarray, jp.params_amodal), ref, tape,
                     calib_tape)
    return out


def _port_from_trees(raw, amodal):
    models = []
    for cfg, tree in ((RAW_CFG, raw), (AMODAL_CFG, amodal)):
        model = build_model(cfg)
        sd = params_from_jax(tree, cfg)
        Q.apply_quantized_(model, sd)
        model.load_state_dict(sd, strict=True)
        models.append(model)
    return AmodalDepthPipeline(*models, size=SIZE, device="cpu",
                               attn_impl="plain")


def _assert_same_sites_and_codes(ours: dict, ref: dict, *, codes=True):
    """The flat JAX-layout trees hold the same leaves; int8 / bool leaves
    are equal, the float ones close."""
    ours, ref = flatten_tree(ours), flatten_tree(ref)
    assert sorted(ours) == sorted(ref)
    for key, leaf in ref.items():
        mine = np.asarray(ours[key])
        assert mine.dtype == leaf.dtype or leaf.dtype.kind == "f", key
        if leaf.dtype in (np.int8, np.bool_) and codes:
            np.testing.assert_array_equal(mine, leaf, err_msg=key)
        elif leaf.dtype.kind == "f":
            assert _rel_err(mine, leaf) <= TOL, key


@pytest.mark.parametrize("mode", list(AMODAL_MODES))
def test_quantized_amodal_pipeline_matches_jax(mode, amodal_setup,
                                               jax_quantized,
                                               record_property):
    params, img, msk, exact = amodal_setup
    raw_j, amodal_j, ref, tape, calib_tape = jax_quantized[mode]
    # the JAX package's quantised trees through the bridge
    with replayed(tape) as flips:
        base, blended = _port_from_trees(raw_j, amodal_j)(img, msk)
    _report(record_property, flips, tape)
    assert _rel_err(base, ref[0]) <= TOL
    assert _rel_err(blended, ref[1]) <= TOL
    # the port's own quantisation: the JAX sites, codes and scales
    pipe = port_amodal(params)
    with replayed(calib_tape):
        pipe.quantize_int8(**_calib(AMODAL_MODES[mode], img, msk))
    smooth = "smooth" in mode   # smoothed weights carry an f32 pow each
    for model, cfg, tree in ((pipe.raw_model, RAW_CFG, raw_j),
                             (pipe.amodal_model, AMODAL_CFG, amodal_j)):
        _assert_same_sites_and_codes(
            params_to_jax(model.state_dict(), cfg), tree, codes=not smooth)
    with replayed(tape):
        base, blended = pipe(img, msk)
    assert _rel_err(blended, ref[1]) <= TOL
    # compression changes the result, and stays near the exact one
    assert 0 < np.abs(ref[1] - exact[1]).max() < 0.2


def test_quantize_int8_checks_its_options(amodal_setup):
    params, img, msk, _ = amodal_setup
    pipe = port_amodal(params)
    for kw, match in ((dict(smooth_alpha=0.5), "smooth_alpha requires"),
                      (dict(dynamic=True, calibration=(img, msk)),
                       "needs no calibration"),
                      (dict(dynamic=True, mixed=True), "incompatible"),
                      (dict(head=True), "head=True requires"),
                      (dict(base=False, head=True, calibration=(img, msk)),
                       "enable at least one")):
        with pytest.raises(ValueError, match=match):
            pipe.quantize_int8(**kw)


# each mixed mode gives the UNet, the VAE encoder and the VAE decoder a
# scheme of their own, so that over the three each part runs w4, w8 and
# dynamic W8A8 once (a lower fan threshold reaches the tiny VAE's convs)
DEPTHFM_MODES = {
    "w4-unet-dynamic-encoder-w8-decoder": ("w4", "int8", "w8"),
    "dynamic-unet-w8-encoder-w4-decoder": ("int8", "w8", "w4"),
    "w8-unet-w4-encoder-dynamic-decoder": ("w8", "w4", "int8"),
    "calibrated": None,
}
_PARTS = {"unet": {}, "vae.encoder": dict(min_conv_fan=128),
          "vae.decoder": dict(min_conv_fan=128)}
_SCHEME_KW = {"int8": {}, "w8": dict(weight_only=True),
              "w4": dict(weight_only=True, bits=4)}


# one Euler step: the JAX calibration unrolls the trajectory, so each step
# costs it a UNet's compile
STEPS = 1


def _mix(mode):
    """{part: (its scheme, the quantiser's keywords)} of a mixed mode."""
    return {part: (scheme, {**kw, **_SCHEME_KW[scheme]})
            for (part, kw), scheme in zip(_PARTS.items(),
                                          DEPTHFM_MODES[mode])}


def _jax_quantize_depthfm(jp, mode, calib):
    if calib is not None:
        jp.quantize_int8(calibration=calib)
        return
    params = jax.tree.map(lambda a: a, jp.params)
    for part, (_, kw) in _mix(mode).items():  # jitted, as the JAX pipeline
        *parents, leaf = part.split(".")
        node = params
        for p in parents:
            node = node[p]
        node[leaf] = jax.jit(functools.partial(
            jq.quantize_diffusion_int8, **kw))(node[leaf])
    jp.params = params


def _port_quantize_depthfm(pipe, mode, calib, noise):
    if calib is not None:
        pipe.quantize_int8(calibration=calib, noise=noise)
        return
    from amodal_depth_anything_tpu_torch.convert.weights import \
        depthfm_layer_paths
    paths = depthfm_layer_paths(pipe.cfg)
    for part, (scheme, kw) in _mix(mode).items():
        n0, p0 = part + ".", part.replace(".", "/") + "/"
        sub = {n[len(n0):]: p[len(p0):] for n, p in paths.items()
               if n.startswith(n0)}
        done = Q.quantize_diffusion_modules(
            pipe.model.get_submodule(part), sub, **kw)
        assert scheme in set(done.values())


@pytest.fixture(scope="module")
def depthfm_setup():
    params, jpipe, pipe = depthfm_pair(seed=5)
    img, mask, obs = depthfm_inputs(3, batch=2)
    return params, jpipe, pipe.cfg, img, mask, obs


@pytest.mark.parametrize("mode", list(DEPTHFM_MODES))
def test_quantized_depthfm_pipeline_matches_jax(mode, depthfm_setup,
                                                record_property):
    params, jpipe, cfg, img, mask, obs = depthfm_setup
    calib = (img, mask, obs) if mode == "calibrated" else None
    noise = jax_noise(2, 16, 16, 4)
    jp = type(jpipe)(params, jpipe.cfg, size=32, num_steps=STEPS,
                     attn_impl="xla", seed=jpipe.seed)
    with jax_code_tape() as calib_tape:
        _jax_quantize_depthfm(jp, mode, calib)
    with jax_code_tape() as tape:
        ref = jp(img, mask, obs)
    # the JAX tree through the bridge
    tree = jax.tree.map(np.asarray, jp.params)
    model = build_depthfm(cfg, device="cpu")
    sd = depthfm_params_from_jax(tree, model.cfg)
    Q.apply_quantized_(model, sd)
    model.load_state_dict(sd, strict=True)
    pipe = DepthFMPipeline(model, size=32, num_steps=STEPS, seed=jpipe.seed,
                           device="cpu", attn_impl="plain")
    with replayed(tape) as flips:
        out = pipe(img, mask, obs, noise=noise)
    _report(record_property, flips, tape)
    assert _rel_err(out, ref) <= TOL
    # the port's own quantisation: the same sites, codes and scales
    own = build_depthfm(model.cfg, device="cpu")
    own.load_state_dict(depthfm_params_from_jax(params, own.cfg))
    pipe = DepthFMPipeline(own, size=32, num_steps=STEPS, seed=jpipe.seed,
                           device="cpu", attn_impl="plain")
    with replayed(calib_tape):
        _port_quantize_depthfm(pipe, mode, calib, noise)
    _assert_same_sites_and_codes(
        depthfm_params_to_jax(own.state_dict(), own.cfg), tree)
    with replayed(tape):
        out = pipe(img, mask, obs, noise=noise)
    assert _rel_err(out, ref) <= TOL


def test_quantize_diffusion_sites_match_jax_on_the_sd_topology(
        monkeypatch):
    """At the SD-1.5 widths (shapes only: the JAX quantisers are replaced
    by markers, so nothing is computed): the sites the port picks equal
    the JAX package's, scheme for scheme (int8 / w8 / w4), for the UNet,
    the VAE (its upsamplers stay float in the weight-only modes) and the
    output convs (kept)."""
    import types

    from amodal_depth_anything_tpu_torch.convert.weights import \
        depthfm_layer_paths
    from amodal_depth_anything_tpu_torch.models.depthfm import (
        DepthFM, DepthFMConfig)
    for name in ("conv_int8", "conv_w8", "conv_w4", "linear_w8",
                 "linear_w4"):
        monkeypatch.setattr(jq, f"quantize_{name}",
                            lambda p, *a, _n=name, **k: {
                                "site": _n.split("_")[1]})
    monkeypatch.setattr(jq, "quantize_linear_int8",
                        lambda p, *a, **k: {"site": "int8"})
    cfg = DepthFMConfig()
    with torch.device("meta"):
        model = DepthFM(cfg)
    paths = depthfm_layer_paths(cfg)
    tree: dict = {}
    for name, path in paths.items():
        s = tuple(model.get_submodule(name).weight.shape)
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node["w"] = types.SimpleNamespace(
            ndim=len(s), shape=s[::-1] if len(s) == 2
            else (s[2], s[3], s[1], s[0]))
    for kw in (dict(), dict(weight_only=True),
               dict(weight_only=True, bits=4)):
        ref = jq.quantize_diffusion_int8(tree, **kw)
        want = {}
        for name, path in paths.items():
            node = ref
            for part in path.split("/"):
                node = node[part]
            want[name] = node.get("site")
        got = {name: Q.diffusion_site(path, model.get_submodule(name), **kw)
               for name, path in paths.items()}
        assert got == want
        assert len({v for v in got.values()}) > 1
        assert got["unet.out.2"] is None and \
            got["vae.decoder.conv_out"] is None


def test_proxy_gate_v2_ladder_corpus_and_table(tmp_path, capsys):
    """The port's `scripts/proxy_gate_v2.py`: the JAX script's ladder, its
    corpus loader's arrays (PNGs read without PIL, at the tree's own size
    and resized, 16-bit depths included), and a gate table on the CPU at a
    small size over three points (exact, LN-bound int8, ToMe): the control
    row is exactly zero and every point is finite."""
    from amodal_depth_anything_tpu.data.synthetic import \
        make_synthetic_sam_tree
    from amodal_depth_anything_tpu.scripts import proxy_gate_v2 as jgate
    from amodal_depth_anything_tpu.scripts.train_proxy import _load_corpus
    from amodal_depth_anything_tpu_torch.scripts import proxy_gate_v2 as gate
    assert gate.build_ladder(224, 2, 12) == jgate.build_ladder(224, 2, 12)
    root = str(tmp_path / "scenes")
    list_path = make_synthetic_sam_tree(root, n=2, hw=48, seed=1,
                                        style="scenes")
    for size in (48, 56):
        for ours, ref in zip(gate.load_corpus(root, list_path, size),
                             _load_corpus(root, list_path, size)):
            np.testing.assert_array_equal(ours, ref)
    rows = gate.main(["--size", "56", "--eval-n", "2", "--points", "0,2,10",
                      "--device", "cpu", "--corpus-dir",
                      str(tmp_path / "held_out")])
    assert [r["point"].split(" ")[0] for r in rows] == ["exact", "int8",
                                                        "tome"]
    assert rows[0]["blended_max_abs"] == 0.0 and rows[0]["pass"]
    assert all(np.isfinite(r["blended_max_abs"]) for r in rows)
    assert "| operating point |" in capsys.readouterr().out
