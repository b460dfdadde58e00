"""The port's demo app (`cli/app.py`) against the JAX package's.

Both apps hold the in-repo trained proxies (vitp at 112 px) and, for
"prompt_points", the noisy tiny heuristics stack of
tests/test_torch_heuristics.py on the same weights; the DDIM noise is the
JAX package's, handed over. Depth max abs <= 1e-4, the derived mask equal,
the port's render of the JAX app's depth equal to the JAX app's render.
Then the plain-HTTP demo round trip on the CPU and `_build_heuristics`'s
flag checks."""

import base64
import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.cli import app as japp
from amodal_depth_anything_tpu.models import amodal_dav2 as jdav2
from amodal_depth_anything_tpu.pipeline import amodal_pipeline as jpipe
from amodal_depth_anything_tpu.scripts.train_proxy import \
    load_params_npz as jax_load_params_npz
from amodal_depth_anything_tpu_torch.cli import app as tapp
from amodal_depth_anything_tpu_torch.convert.weights import (
    load_params_npz, params_from_jax)
from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (DAV2Config,
                                                                 build_model)
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from amodal_depth_anything_tpu_torch.utils.host_image import (decode_png,
                                                              encode_png)
from tests.test_torch_heuristics import _jax_noise, stack  # noqa: F401
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-4
PROXY = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "proxy")
CFGS = (("raw_base", DAV2Config(encoder="vitp", guide_type="none", raw=True)),
        ("amodal", DAV2Config(encoder="vitp", guide_type="mask+observation")))


@pytest.fixture(scope="module")
def apps():
    models, jparams = [], []
    for name, cfg in CFGS:
        path = os.path.join(PROXY, f"{name}.npz")
        model = build_model(cfg, device="cpu")
        model.load_state_dict(params_from_jax(load_params_npz(path), cfg),
                              strict=True)
        models.append(model)
        jparams += [jax.tree.map(jnp.asarray, jax_load_params_npz(path)),
                    jdav2.DAV2Config(**dataclasses.asdict(cfg))]
    tpipe = AmodalDepthPipeline(*models, size=112, device="cpu")
    jp = jpipe.AmodalDepthPipeline(*jparams, size=112, attn_impl="xla")
    return japp.AmodalDepthApp(jp), tapp.AmodalDepthApp(tpipe)


def _scene(seed, h=60, w=84):
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    mask = np.zeros((h, w), np.float32)
    mask[15:45, 20:60] = 1.0
    return img, mask


def _compare(japp_, ref, arrays, img, mask):
    """The port's arrays against the JAX app's result: base depth (from the
    JAX pipeline's own call) and aligned depth within 1e-4, the derived
    mask equal; the port's render of the JAX app's depth equal to the JAX
    app's render, bit for bit."""
    jbase_render, jamodal_render, jaligned = ref
    jbase, _ = japp_.pipeline(img, (mask > 0).astype(np.float32))
    assert arrays["aligned"].shape == jaligned.shape == (112, 112)
    assert np.abs(arrays["aligned"] - np.asarray(jaligned)).max() <= TOL
    assert np.abs(arrays["base"] - np.asarray(jbase)).max() <= TOL
    base_render, amodal_render = tapp.AmodalDepthApp.render(
        dict(arrays, base=np.asarray(jbase), aligned=np.asarray(jaligned)),
        img.shape[:2])
    np.testing.assert_array_equal(base_render, jbase_render)
    np.testing.assert_array_equal(amodal_render, jamodal_render)


def test_amodal_mask_mode_matches_jax_app(apps):
    japp_, tapp_ = apps
    img, mask = _scene(0)
    arrays = tapp_.predict_arrays(img, mask, "amodal_mask")
    _compare(japp_, japp_.predict_amodal_depth(img, mask, "amodal_mask"),
             arrays, img, mask)
    assert sorted(arrays) == ["aligned", "base", "blended", "mask", "mask_s"]
    np.testing.assert_array_equal(arrays["mask"], mask)
    assert arrays["aligned"].min() >= 0 and arrays["aligned"].max() <= 1
    base_render, amodal_render, aligned = tapp_.predict_amodal_depth(
        img, mask, "amodal_mask")
    assert base_render.shape == amodal_render.shape == img.shape
    np.testing.assert_array_equal(aligned, arrays["aligned"])


def test_prompt_points_mode_matches_jax_app(apps, stack):
    """The heuristics derive the mask in both apps (threshold matting),
    then the same depth path runs on it."""
    japp_, tapp_ = apps
    jh, th, _ = stack
    img, _ = _scene(1, 40, 52)
    hint = np.zeros(img.shape[:2], np.float32)
    hint[18:34, 6:28] = 1.0
    saved = (jh.matting_fn, th.matting_fn)
    jh.matting_fn = th.matting_fn = None
    japp_.heuristics, tapp_.heuristics = jh, th
    try:
        noise = _jax_noise(0, th.p2g_cfg.image_size)
        ref = japp_.predict_amodal_depth(img, hint, "prompt_points")
        arrays = tapp_.predict_arrays(img, hint, "prompt_points", noise=noise)
        want_mask = jh.amodal_mask_from_points(img, hint)
    finally:
        jh.matting_fn, th.matting_fn = saved
        japp_.heuristics = tapp_.heuristics = None
    np.testing.assert_array_equal(arrays["mask"], want_mask)
    _compare(japp_, ref, arrays, img, want_mask)


def test_prompt_points_without_heuristics_and_unknown_mode(apps):
    _, tapp_ = apps
    img, mask = _scene(2)
    with pytest.raises(RuntimeError, match="heuristics"):
        tapp_.predict_arrays(img, mask, "prompt_points")
    with pytest.raises(ValueError, match="mask_type"):
        tapp_.predict_arrays(img, mask, "scribble")


def test_mask_png_reads_as_pil_converts_it():
    from PIL import Image
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (9, 13, 4)).astype(np.uint8)
    want = np.maximum(np.asarray(Image.fromarray(rgba).convert("L")),
                      rgba[..., 3]).astype(np.float32)
    np.testing.assert_array_equal(tapp._mask_from_png(rgba), want)
    rgb = rgba[..., :3]
    np.testing.assert_array_equal(
        tapp._mask_from_png(rgb),
        np.asarray(Image.fromarray(rgb).convert("L")).astype(np.float32))
    np.testing.assert_array_equal(
        tapp._as_rgb(rgba), np.asarray(Image.fromarray(rgba).convert("RGB")))


def test_http_demo_round_trip(apps):
    _, tapp_ = apps
    img, mask = _scene(4)
    painted = np.zeros(img.shape[:2] + (4,), np.uint8)
    painted[..., 0] = 255
    painted[..., 3] = (mask * 204).astype(np.uint8)   # the canvas's alpha
    server = tapp.build_http_demo(tapp_, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        page = urllib.request.urlopen(url + "/").read().decode()
        assert "Amodal Depth Anything" in page
        body = json.dumps({
            "image": base64.b64encode(encode_png(img)).decode(),
            "mask": base64.b64encode(encode_png(painted)).decode(),
            "mask_type": "amodal_mask"}).encode()
        out = json.loads(urllib.request.urlopen(urllib.request.Request(
            url + "/predict", data=body, method="POST")).read())
        bad = urllib.request.Request(url + "/predict", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad)
        assert err.value.code == 500
    finally:
        server.shutdown()
        server.server_close()
    base, amodal, _ = tapp_.predict_amodal_depth(
        img, tapp._mask_from_png(painted), "amodal_mask")
    np.testing.assert_array_equal(decode_png(base64.b64decode(out["base"])),
                                  base)
    np.testing.assert_array_equal(
        decode_png(base64.b64decode(out["amodal"])), amodal)


def _args(*argv):
    return tapp.build_parser().parse_args(list(argv))


def test_build_heuristics_flag_checks(tmp_path, stack):
    assert tapp._build_heuristics(_args()) is None
    with pytest.raises(SystemExit, match="not ported"):
        tapp._build_heuristics(_args("--p2g_int8", "--random"))
    with pytest.raises(SystemExit, match="requires the heuristics stack"):
        tapp._build_heuristics(_args("--p2g_deep_cache", "5"))
    with pytest.raises(SystemExit, match="missing --p2g_ckpt --vae_ckpt"):
        tapp._build_heuristics(_args("--sam_ckpt", "x.pth",
                                     "--clip_ckpt", "c"))
    _, th, _ = stack
    path = str(tmp_path / "heur")
    th.save_serving(path)
    mh = tapp._build_heuristics(_args("--heur_serving", path, "--device",
                                      "cpu", "--p2g_deep_cache", "2,1"))
    assert mh.p2g_cfg.ddim_deep_cache == (2, 1)
    assert mh.device == torch.device("cpu")
    assert dataclasses.replace(mh.p2g_cfg, ddim_deep_cache=None) == \
        th.p2g_cfg
    assert _args().device == "cuda"


def test_gradio_demo_needs_gradio(apps):
    try:
        import gradio  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="gradio"):
            tapp.build_demo(apps[1])
    else:
        assert tapp.build_demo(apps[1]) is not None
