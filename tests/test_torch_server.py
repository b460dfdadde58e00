"""Port serving front end: `pipeline/server.py` (MicroBatcher), `cli/serve.py`
(the HTTP server) and `utils/host_image.py` (its PIL-free PNG codec and
resizes), on the CPU.

MicroBatcher: the counterparts of tests/test_server.py (coalescing and
padding, a single output, the timeout, shape mismatch and error
propagation), and concurrent callers through it bit-identical to a direct
port call. HTTP: both families' endpoints against the JAX package's
`build_server` on the same weights (carried across by `params_from_jax` /
`depthfm_params_from_jax`; the DepthFM noise is JAX's draw, handed to the
port), decoded uint16 depth within 1e-4 + 1/65535; the 400 and 404 errors;
`cli.serve --random --device cpu` as a subprocess polled through /healthz;
flags that do not go together exit with their message. The codec and the
host resizes equal PIL's, and the server's `_prep` and `_b64_depth_to_array`
the JAX server's, bit for bit; the quality gate's functions equal the JAX
package's."""

import base64
import concurrent.futures
import io
import json
import os
import re
import select
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from amodal_depth_anything_tpu.cli import serve as jax_serve
from amodal_depth_anything_tpu.pipeline import quality as jax_quality
from amodal_depth_anything_tpu_torch.cli import serve
from amodal_depth_anything_tpu_torch.pipeline import quality
from amodal_depth_anything_tpu_torch.pipeline.server import MicroBatcher
from amodal_depth_anything_tpu_torch.utils.host_image import (decode_png,
                                                              encode_png,
                                                              resize_bilinear,
                                                              resize_nearest)
from tests.test_torch_depthfm_pipeline import _noise as jax_noise
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_serving_ckpt import (amodal_params, depthfm_pair,
                                           jax_amodal, port_amodal)

U16_TOL = 1e-4 * 65535 + 1   # 1e-4 of the depth range plus one uint16 step

# ----------------------------------------------------------- MicroBatcher


def test_microbatcher_coalesces_and_pads(rng):
    calls = []

    def batch_fn(x, y):
        calls.append(x.shape[0])
        return x * 2.0, y + 1.0

    with MicroBatcher(batch_fn, max_batch=4, max_delay_ms=200) as mb:
        xs = [rng.random((3, 2)).astype(np.float32) for _ in range(6)]
        ys = [rng.random((3,)).astype(np.float32) for _ in range(6)]
        futs = [mb.submit(x, y) for x, y in zip(xs, ys)]
        outs = [f.result(timeout=30) for f in futs]

    for (ox, oy), x, y in zip(outs, xs, ys):
        np.testing.assert_array_equal(ox, x * 2.0)
        np.testing.assert_array_equal(oy, y + 1.0)
    # 6 requests at max_batch 4 -> 2 dispatches, both padded to 4
    assert mb.dispatches == 2
    assert calls == [4, 4]


def test_microbatcher_single_output_and_infer():
    with MicroBatcher(lambda x: x + 1.0, max_batch=2,
                      max_delay_ms=0) as mb:
        out = mb.infer(np.zeros((2, 2), np.float32))
    np.testing.assert_array_equal(out, np.ones((2, 2), np.float32))
    assert mb.dispatches == 1


def test_microbatcher_infer_timeout():
    def slow(x):
        time.sleep(2.0)
        return x

    with MicroBatcher(slow, max_batch=1, max_delay_ms=0) as mb:
        with pytest.raises(concurrent.futures.TimeoutError):
            mb.infer(np.zeros((2,), np.float32), timeout=0.2)


def test_microbatcher_shape_mismatch_and_errors():
    def boom(x):
        raise RuntimeError("replay failed")

    with MicroBatcher(boom, max_batch=2, max_delay_ms=0) as mb:
        fut = mb.submit(np.zeros((2,), np.float32))
        with pytest.raises(RuntimeError, match="replay failed"):
            fut.result(timeout=30)

    with MicroBatcher(lambda x: x, max_batch=4, max_delay_ms=500) as mb:
        f1 = mb.submit(np.zeros((2,), np.float32))
        f2 = mb.submit(np.zeros((3,), np.float32))
        for fut in (f1, f2):
            with pytest.raises(ValueError, match="per-sample shapes"):
                fut.result(timeout=30)

    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(np.zeros((2,), np.float32))


def test_microbatcher_concurrent_callers_match_direct_port_call(rng):
    """Threaded callers through the batcher get bit-identical results to
    one direct batched call of the port's pipeline."""
    pipe = port_amodal(amodal_params(seed=5), attn_impl=None)
    imgs = (rng.random((5, 48, 40, 3)) * 255).astype(np.float32)
    msks = (rng.random((5, 48, 40)) > 0.5).astype(np.float32)
    want_base, want_blend = pipe(imgs[:4], msks[:4])  # direct, full batch

    results = [None] * 5
    with MicroBatcher(pipe, max_batch=4, max_delay_ms=1000) as mb:
        def call(i):
            results[i] = mb.infer(imgs[i], msks[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    assert mb.dispatches == 2  # 4 + 1 (padded)
    for i in range(4):
        base_i, blend_i = results[i]
        np.testing.assert_array_equal(base_i, want_base[i])
        np.testing.assert_array_equal(blend_i, want_blend[i])
    base4, blend4 = results[4]
    assert base4.shape == (56, 56) and np.isfinite(blend4).all()

# ------------------------------------------------------------------- HTTP


def _b64_png(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _u16(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64)))).astype(
        np.int64)


def _start(server) -> str:
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _post(url: str, route: str, body: bytes) -> dict:
    req = urllib.request.Request(f"{url}{route}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _http_error(url: str, route: str, body: bytes) -> int:
    try:
        urllib.request.urlopen(urllib.request.Request(f"{url}{route}",
                                                      data=body), timeout=60)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def _stop(servers) -> None:
    for server in servers:
        server.shutdown()
        server.batcher.close()


def test_http_amodal_endpoint_matches_jax_server(rng):
    params = amodal_params(seed=8)
    pipe = port_amodal(params)
    servers = [jax_serve.build_server(jax_amodal(params), port=0,
                                      max_batch=2, max_delay_ms=0),
               serve.build_server(pipe, port=0, max_batch=2,
                                  max_delay_ms=0)]
    try:
        jax_url, url = (_start(s) for s in servers)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "dispatches": 0, "size": 56}

        image = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
        mask = ((rng.random((48, 40)) > 0.5) * 255).astype(np.uint8)
        body = json.dumps({"image": _b64_png(image),
                           "mask": _b64_png(mask)}).encode()
        theirs, ours = (_post(u, "/v1/amodal_depth", body)
                        for u in (jax_url, url))
        assert ours["size"] == theirs["size"] == 56
        for key in ("base_depth", "blended_depth"):
            diff = np.abs(_u16(ours[key]) - _u16(theirs[key]))
            assert diff.max() <= U16_TOL, (key, diff.max())

        # the port's response is a direct call on its host-prepped inputs
        # (the padded batch of two, as the batcher sends it)
        img_p, msk_p = serve._prep(image.astype(np.float32), mask, 56)
        _, blended = pipe(np.stack([img_p] * 2), np.stack([msk_p] * 2))
        want = (np.clip(blended[0], 0, 1) * 65535).astype(np.uint16)
        np.testing.assert_array_equal(_u16(ours["blended_depth"]), want)
        assert servers[1].batcher.dispatches == 1

        assert _http_error(url, "/v1/amodal_depth",
                           b'{"image": "zzz"}') == 400
        assert _http_error(url, "/v1/depthfm_depth", body) == 404
    finally:
        _stop(servers)


class _WithNoise:
    """The port's DepthFM pipeline behind the batcher with JAX's q_sample
    noise for the served batch."""

    def __init__(self, pipe, batch: int):
        self.pipe, self.size = pipe, pipe.size
        s = pipe.latent_size()
        self.noise = jax_noise(batch, s, s, 4)

    def __call__(self, img, msk, obs):
        return self.pipe(img, msk, obs, noise=self.noise)


def test_http_depthfm_endpoint_matches_jax_server(rng):
    _, jpipe, pipe = depthfm_pair(seed=9)
    servers = [jax_serve.build_server(jpipe, port=0, max_batch=2,
                                      max_delay_ms=0, family="depthfm"),
               serve.build_server(_WithNoise(pipe, 2), port=0, max_batch=2,
                                  max_delay_ms=0, family="depthfm")]
    try:
        jax_url, url = (_start(s) for s in servers)
        image = (rng.random((40, 48, 3)) * 255).astype(np.uint8)
        mask = ((rng.random((40, 48)) > 0.5) * 255).astype(np.uint8)
        obs = (rng.random((40, 48)) * 65535).astype(np.uint16)
        body = json.dumps({"image": _b64_png(image), "mask": _b64_png(mask),
                           "observation": _b64_png(obs, mode="I;16")
                           }).encode()
        theirs, ours = (_post(u, "/v1/depthfm_depth", body)
                        for u in (jax_url, url))
        assert ours["size"] == theirs["size"] == 32
        diff = np.abs(_u16(ours["depth"]) - _u16(theirs["depth"]))
        assert diff.max() <= U16_TOL, diff.max()
        assert _u16(ours["depth"]).std() > 0
        assert _http_error(url, "/v1/amodal_depth", body) == 404
    finally:
        _stop(servers)


def test_serve_cli_random_subprocess_on_the_cpu():
    """cli.serve --random --device cpu: argument parsing, the pipeline
    build and the server bring-up as a real subprocess, polled through
    /healthz."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "amodal_depth_anything_tpu_torch.cli.serve",
         "--random", "--device", "cpu", "--port", "0", "--max_batch", "1"],
        env=dict(os.environ, OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.time() + 240
        while time.time() < deadline:
            # select-gated read: a wedged server fails the deadline instead
            # of blocking the suite in readline()
            ready, _, _ = select.select([proc.stdout], [], [], 5.0)
            if not ready:
                assert proc.poll() is None, "server exited early"
                continue
            line = proc.stdout.readline()
            if "serving on" in line:
                break
            assert proc.poll() is None, f"server exited early: {line!r}"
        assert "serving on" in line and "eager on the CPU" in line, line
        port = re.search(r":(\d+) ", line).group(1)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["size"] == 56
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("argv, message", [
    (["--random", "--int8", "wo"], "--int8 wo is a depthfm-family mode"),
    (["--artifact", "/nonexistent"], "--artifact needs --serving_state"),
    (["--random", "--artifact", "/nonexistent", "--export_artifact",
      "/tmp/x"], "pass one of them"),
    (["--random", "--artifact", "/nonexistent", "--int8", "ln"],
     "cannot be applied to a pre-compiled --artifact"),
    (["--family", "amodal", "--random", "--deep_cache", "2,2"],
     "depthfm-family knob"),
    (["--family", "depthfm", "--random", "--size", "36"], "divisible"),
    (["--family", "depthfm", "--random", "--int8", "ln"],
     "amodal-family mode"),
], ids=["int8", "artifact", "export_artifact", "artifact-int8",
        "deep_cache", "size", "int8-ln"])
def test_serve_cli_knob_validation(argv, message, capsys):
    with pytest.raises(SystemExit, match=message):
        serve.main(argv)


@pytest.mark.parametrize("family, mode, scheme", [
    ("amodal", "ln", "int8"), ("depthfm", "wo", "w8"),
    ("depthfm", "dynamic", "int8")])
def test_serve_cli_int8_compresses_before_serving(family, mode, scheme,
                                                  monkeypatch):
    """`--int8` quantises the pipeline before it is served (as the JAX CLI
    does); the served pipeline's layers carry the mode's scheme, with
    run-time scales for 'dynamic' and LN-bound static ones for 'ln'."""
    seen = {}

    def stop(served, *args, **kwargs):
        seen["pipe"] = served
        raise SystemExit("stop before serving")

    monkeypatch.setattr(serve, "build_server", stop)
    with pytest.raises(SystemExit, match="stop before serving"):
        serve.main(["--family", family, "--random", "--int8", mode,
                    "--device", "cpu"])
    pipe = seen["pipe"]
    models = ([pipe.raw_model, pipe.amodal_model] if family == "amodal"
              else [pipe.model])
    quant = [m for model in models for m in model.modules()
             if type(m).__name__.startswith("Quant")]
    assert quant and {m.mode for m in quant} == {scheme}
    if scheme == "int8":
        static = {m._get("act_scale") is not None for m in quant}
        assert static == {mode == "ln"}


def test_serve_cli_int8_refuses_a_quantised_state(tmp_path):
    """A serving state that is already quantised is served as it is:
    `--int8` on it exits instead of quantising the int8 codes again."""
    from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
        DepthFMPipeline
    pipe = DepthFMPipeline.init_random(0, device="cpu")
    pipe.quantize_int8(weight_only=True)
    pipe.save_serving(str(tmp_path / "state"))
    with pytest.raises(SystemExit, match="already quantised"):
        serve.main(["--family", "depthfm", "--serving_state",
                    str(tmp_path / "state"), "--int8", "dynamic",
                    "--device", "cpu"])
    with pytest.raises(ValueError, match="already quantised"):
        pipe.quantize_int8()


def test_serve_cli_on_cuda_without_a_card_exits(monkeypatch):
    """The default device is "cuda": without a card the CLI stops; it
    never serves on the CPU unless --device cpu asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--random"])

# ---------------------------------------------- host codec and resizes


@pytest.mark.parametrize("hw, out", [((48, 40), (56, 56)),
                                     ((600, 800), (518, 518)),
                                     ((37, 91), (32, 32)),
                                     ((512, 512), (512, 512))])
def test_host_resizes_equal_pil(hw, out, rng):
    rgb = (rng.random((*hw, 3)) * 255).astype(np.uint8)
    gray = rgb[..., 1].copy()
    flt = rng.random(hw).astype(np.float32)
    mask = (rng.random(hw) > 0.5).astype(np.uint8)
    depth16 = (rng.random(hw) * 65535).astype(np.uint16)   # PIL "I;16"
    for arr in (rgb, gray, flt):
        np.testing.assert_array_equal(
            resize_bilinear(arr, out),
            np.asarray(Image.fromarray(arr).resize(out, Image.BILINEAR)))
    for arr in (mask, rgb, flt, depth16):
        np.testing.assert_array_equal(
            resize_nearest(arr, out),
            np.asarray(Image.fromarray(arr).resize(out, Image.NEAREST)))


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "1",
                                  "I;16"])
def test_png_codec_equals_pil(mode, rng):
    if mode == "I;16":
        img = Image.fromarray((rng.random((21, 33)) * 65535).astype(
            np.uint16))
    else:
        img = Image.fromarray((rng.random((21, 33, 4)) * 255).astype(
            np.uint8), "RGBA").convert(mode)
    for optimize in (False, True):   # PIL picks each row's filter either way
        buf = io.BytesIO()
        img.save(buf, format="PNG", optimize=optimize)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
        got = decode_png(buf.getvalue())
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if mode in ("RGB", "L", "RGBA", "I;16"):
        arr = np.asarray(img)
        if mode == "I;16":
            arr = arr.astype(np.uint16)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(encode_png(arr)))), arr)


def _filter_row(kind, line, prior, bpp):
    """PNG filter `kind` of one row, byte after byte as the format defines
    it (the independent reference for the codec's vectorised filters)."""
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        paeth = a if pa <= pb and pa <= pc else b if pb <= pc else c
        pred = (0, a, b, (a + b) // 2, paeth)[kind]
        out[i] = (x - pred) % 256
    return bytes(out)


@pytest.mark.parametrize("mode,shape,bpp", [
    ("L", (17, 23), 1), ("RGB", (17, 23, 3), 3), ("RGBA", (9, 31, 4), 4),
    ("I;16", (13, 19), 2)])
def test_png_decode_undoes_every_row_filter(mode, shape, bpp, rng):
    """Rows filtered by a seeded choice of all five filter types (Average
    and Paeth take the anti-diagonal path; None/Sub/Up alone the row path):
    decode_png gives what PIL gives, which is the image; and encode_png's
    own choice of filters decodes to the image in both codecs."""
    dtype = np.uint16 if mode == "I;16" else np.uint8
    img = (rng.random(shape) * np.iinfo(dtype).max).astype(dtype)
    img[2:6] = img[1]                                   # some smooth rows
    rows = (img.astype(">u2").view(np.uint8) if dtype == np.uint16
            else img).reshape(shape[0], -1)
    for kinds in (rng.permutation(np.arange(shape[0]) % 5),
                  rng.integers(0, 3, shape[0])):
        prior, lines = bytes(rows.shape[1]), b""
        for kind, line in zip(kinds, rows):
            lines += bytes([kind]) + _filter_row(kind, line.tobytes(),
                                                 prior, bpp)
            prior = line.tobytes()
        body = encode_png(img)
        start = body.index(b"IDAT") - 4
        end = start + 12 + int.from_bytes(body[start:start + 4], "big")
        idat = zlib.compress(lines)
        png = (body[:start] + len(idat).to_bytes(4, "big") + b"IDAT" + idat
               + zlib.crc32(b"IDAT" + idat).to_bytes(4, "big") + body[end:])
        want = np.asarray(Image.open(io.BytesIO(png)))
        np.testing.assert_array_equal(want, img)
        np.testing.assert_array_equal(decode_png(png), want)
    body = encode_png(img)
    np.testing.assert_array_equal(decode_png(body), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))),
                                  img)


def _png_rows(data: bytes) -> bytes:
    """The filtered rows of a PNG: its IDAT chunks joined and inflated."""
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return zlib.decompress(idat)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "I;16"])
def test_png_encoder_filters_rows_as_pil(mode, rng):
    """encode_png writes the filtered rows PIL writes, filter types
    included, for a textured image (Paeth rows), a smooth one (Up and Sub)
    and noise (None)."""
    yy, xx = np.mgrid[0:40, 0:56] / 9.0
    smooth = np.stack([np.sin(xx + c) * np.cos(yy - c) for c in range(4)],
                      -1)
    seen = set()
    for noise, base in ((12, 110), (0, 120), (255, 0)):
        img = (smooth * base + 128 + rng.normal(0, noise, smooth.shape))
        if mode == "I;16":
            arr = (img[..., 0].clip(0, 255) * 257).astype(np.uint16)
            pil = Image.fromarray(arr)
        else:
            arr = img.clip(0, 255).astype(np.uint8)
            arr = {"RGB": arr[..., :3], "L": arr[..., 0], "RGBA": arr}[mode]
            pil = Image.fromarray(arr)
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        want = _png_rows(buf.getvalue())
        got = _png_rows(encode_png(arr))
        assert got == want
        seen.update(got[::len(got) // arr.shape[0]])
    assert {0, 4} <= seen


def test_server_host_prep_equals_jax_server(rng):
    image = (rng.random((45, 61, 3)) * 255).astype(np.float32)
    mask = ((rng.random((45, 61)) > 0.5) * 255).astype(np.uint8)
    for a, b in zip(serve._prep(image, mask, 56),
                    jax_serve._prep(image, mask, 56)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for obs in ((rng.random((45, 61)) * 65535).astype(np.uint16),
                (rng.random((45, 61)) * 255).astype(np.uint8)):
        data = _b64_png(obs)
        np.testing.assert_array_equal(serve._b64_depth_to_array(data, 32),
                                      jax_serve._b64_depth_to_array(data, 32))
    depth = rng.random((32, 32)).astype(np.float32)
    np.testing.assert_array_equal(_u16(serve._depth_to_b64_png(depth)),
                                  _u16(jax_serve._depth_to_b64_png(depth)))


def test_quality_gate_equals_jax(rng):
    maps = [rng.random((2, 16, 16)).astype(np.float32) for _ in range(4)]
    maps[3] = maps[1] + 0.03 * rng.standard_normal((2, 16, 16)).astype(
        np.float32)
    delta = quality.blended_depth_delta(*maps)
    assert delta == jax_quality.blended_depth_delta(*maps)
    for kw in ({}, {"max_abs": 0.5, "mean_abs": 0.5}):
        assert quality.check_gate(delta, **kw) == \
            jax_quality.check_gate(delta, **kw)
    assert quality.QUALITY_GATE == jax_quality.QUALITY_GATE

    def run(shift):
        return lambda image, mask: (image[..., 0] / 255.0 + shift,
                                    mask[..., 0] + shift)

    corpus = [{"image": (rng.random((8, 8, 3)) * 255).astype(np.uint8),
               "mask": rng.random((8, 8)) > 0.5,
               "visible": rng.random((8, 8)) > v, "whole": np.ones((8, 8))}
              for v in (0.1, 0.4, 0.9)]
    ours = quality.corpus_quality_report(run(0.0), run(0.01), corpus)
    assert ours == jax_quality.corpus_quality_report(run(0.0), run(0.01),
                                                     corpus)
    assert ours["n_samples"] == 3
    assert {k: v["n"] for k, v in ours["per_bucket"].items()} == \
        {"easy": 1, "mid": 1, "hard": 1}
