"""Serialised serving programs of the port (`pipeline/aot.py`:
`save_*_artifact`, `Exported*Serving`) on the CPU: the counterparts of the
JAX package's `tests/test_aot.py`.

An artifact is a directory of `meta.json` and one `torch.export` program
(`.pt2`) per batch bucket, with the weights as program inputs: the layout
holds no weights. Held here: the layout; the round trip (export -> load ->
bind -> call) bit-identical to the eager port and within 1e-4 of the JAX
package's `ExportedAmodalServing` on the same seeded weights; the
unbucketed-batch and unbound errors and a state that does not fit; the
`MicroBatcher` front; the platform guard (device, torch and CUDA versions,
the kernel sources' hash); `cli.serve --export_artifact` then `--artifact`
answering over HTTP as the live `--random` pipeline does; the DepthFM round
trip through the CLI, bit-identical, and its missing-input error. On the
card a bound handle captures each loaded program as a CUDA graph
(`chip_smoke.py` phase 9 holds its replay to the in-process capture)."""

import base64
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.pipeline import \
    ExportedAmodalServing as JaxExportedAmodalServing
from amodal_depth_anything_tpu.pipeline import \
    save_amodal_artifact as jax_save_amodal_artifact
from amodal_depth_anything_tpu_torch.cli import serve
from amodal_depth_anything_tpu_torch.convert.weights import params_to_jax
from amodal_depth_anything_tpu_torch.pipeline import (ExportedAmodalServing,
                                                      ExportedDepthFMServing,
                                                      MicroBatcher)
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
    DepthFMPipeline
from amodal_depth_anything_tpu_torch.utils.host_image import (decode_png,
                                                              encode_png)
from tests.test_torch_models import few_torch_threads  # noqa: F401
from tests.test_torch_serving_ckpt import jax_amodal

SIZE = 56
TOL = 1e-4


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """`cli.serve --random --export_artifact` at batch 2: the program of the
    live `--random` pipeline (seeded vitt raw base + AmodalDAv2, 56 px,
    float32) through the adat:: ops, and that pipeline."""
    path = tmp_path_factory.mktemp("aot") / "artifact"
    serve.main(["--random", "--size", str(SIZE), "--max_batch", "2",
                "--device", "cpu", "--export_artifact", str(path)])
    live = AmodalDepthPipeline.init_random(0, size=SIZE, device="cpu")
    meta = json.loads((path / "meta.json").read_text())
    return path, meta, live


@pytest.fixture(scope="module")
def served(artifact):
    path, _, live = artifact
    return ExportedAmodalServing.load(str(path)).bind(
        live.raw_model.state_dict(), live.amodal_model.state_dict())


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((batch, SIZE, SIZE, 3)) * 255).astype(np.float32),
            (rng.random((batch, SIZE, SIZE)) > 0.5).astype(np.float32))


def test_artifact_layout(artifact, served):
    path, meta, _ = artifact
    assert meta["artifact_version"] == 1
    assert meta["kind"] == "amodal_serving_program"
    assert meta["batches"] == [2] and meta["hw"] == [SIZE, SIZE]
    assert meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert meta["torch_version"] == torch.__version__
    assert len(meta["csrc_sha256"]) == 64 and meta["inputs"] == [
        "image", "mask"]
    assert set(meta["export_seconds"]) == {"2"}
    assert sorted(p.name for p in path.iterdir()) == ["batch_2.pt2",
                                                       "meta.json"]
    # no weights: the program takes them as inputs; its constants are the
    # two trunks' normalisation vectors
    ep = served.programs[2]   # as `bind` read it from batch_2.pt2
    assert not ep.state_dict and ep.example_inputs is None
    assert sum(v.numel() for v in ep.constants.values()) <= 12
    nodes = [str(n.target) for n in ep.graph.nodes]
    assert "adat.flash_attn_fwd.default" in nodes


def test_roundtrip_bit_exact_and_against_jax(artifact, served, tmp_path):
    _, _, live = artifact
    assert served.batches == [2] and served.hw == (SIZE, SIZE)
    assert served.size == live.size
    img, msk = _inputs(2, seed=2)
    ours = served(img, msk)
    for got, want in zip(ours, live(img, msk)):
        assert got.shape == (2, SIZE, SIZE)
        np.testing.assert_array_equal(got, want)
    # the JAX package's artifact of the same weights
    params = tuple(params_to_jax(m.state_dict(), m.cfg) for m in
                   (live.raw_model, live.amodal_model))
    jpath = tmp_path / "jax_artifact"
    jax_save_amodal_artifact(jax_amodal(params), str(jpath), batches=(2,),
                             hw=(SIZE, SIZE), platforms=("cpu",))
    jserved = JaxExportedAmodalServing.load(str(jpath)).bind(*params)
    for got, want in zip(ours, jserved(img, msk)):
        assert np.abs(got - want).max() <= TOL


def test_unbucketed_batch_unbound_and_mismatched_state(artifact, served):
    path, _, live = artifact
    fresh = ExportedAmodalServing.load(str(path))
    img, msk = _inputs(3)
    with pytest.raises(RuntimeError, match="bind"):
        fresh(img, msk)
    raw = live.raw_model.state_dict()
    with pytest.raises(ValueError, match="does not match"):
        fresh.bind({k: v for k, v in raw.items() if "blocks.0." not in k},
                   live.amodal_model.state_dict())
    with pytest.raises(ValueError, match="not in compiled buckets"):
        served(img, msk)


def test_microbatcher_front(artifact, served):
    """The static-bucket contract: MicroBatcher pads request streams to the
    bucket, so any request count serves."""
    _, _, live = artifact
    img, msk = _inputs(3, seed=4)
    with MicroBatcher(served, max_batch=2, max_delay_ms=0.0) as mb:
        outs = [mb.infer(i, m, timeout=600) for i, m in zip(img, msk)]
    for i, (base, blended) in enumerate(outs):
        want = live(np.stack([img[i]] * 2), np.stack([msk[i]] * 2))
        np.testing.assert_array_equal(base, want[0][0])
        np.testing.assert_array_equal(blended, want[1][0])


@pytest.mark.parametrize("key, value, message", [
    ("device", "cuda", "no CUDA device"),
    ("torch_version", "0.0.0", "torch_version"),
    ("csrc_sha256", "0" * 64, "csrc_sha256"),
    ("kind", "depthfm_serving_program", "expected"),
])
def test_platform_guard(artifact, tmp_path, key, value, message):
    path, meta, _ = artifact
    copy = tmp_path / "copy"
    copy.mkdir()
    for f in path.glob("*.pt2"):
        (copy / f.name).symlink_to(f)
    (copy / "meta.json").write_text(json.dumps({**meta, key: value}))
    with pytest.raises(ValueError, match=message):
        ExportedAmodalServing.load(str(copy))
    if key != "kind":
        assert ExportedAmodalServing.load(
            str(copy), check_platform=False).batches == [2]


def test_served_head_tile_is_one_row_on_the_card(artifact):
    """The batch-row invariance on the card: the DPT heads run one row at a
    time there; elsewhere `head_batch_tile` as it is set."""
    assert artifact[2].served_head_tile is None
    card = AmodalDepthPipeline.__new__(AmodalDepthPipeline)
    card.device, card.head_batch_tile = torch.device("cuda"), None
    assert card.served_head_tile == 1


def test_serve_cli_artifact_flow(artifact, monkeypatch):
    """Deployment loop through the CLI: --export_artifact wrote the program
    (the fixture); a replica (--artifact --random) loads it, binds the
    seeded weights, and answers HTTP with the live --random pipeline's
    outputs."""
    path, _, live = artifact
    seen = {}

    def grab(args, served, how):
        seen["served"], seen["how"] = served, how

    monkeypatch.setattr(serve, "_serve", grab)
    serve.main(["--random", "--max_batch", "2", "--device", "cpu",
                "--artifact", str(path)])
    served = seen["served"]
    assert isinstance(served, ExportedAmodalServing)
    assert served.size == SIZE and served.batches == [2]
    assert seen["how"].startswith(f"artifact {path}")
    server = serve.build_server(served, port=0, max_batch=2, max_delay_ms=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    rng = np.random.default_rng(3)
    image = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
    mask = ((rng.random((48, 40)) > 0.5) * 255).astype(np.uint8)
    try:
        body = json.dumps({
            "image": base64.b64encode(encode_png(image)).decode(),
            "mask": base64.b64encode(encode_png(mask)).decode()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/amodal_depth",
            data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        got = decode_png(base64.b64decode(out["blended_depth"]))
        img, msk = serve._prep(image.astype(np.float32), mask, SIZE)
        _, ref = live(np.stack([img] * 2), np.stack([msk] * 2))
        want = (np.clip(ref[0], 0, 1) * 65535).astype(np.uint16)
        np.testing.assert_array_equal(got, want)
    finally:
        server.shutdown()
        server.batcher.close()


def test_depthfm_artifact_roundtrip(tmp_path):
    """Generative-family artifact through the CLI: export -> load -> bind ->
    serve, bit-identical to the live DepthFMPipeline (the seeded noise is
    part of the program), and its missing-input error."""
    art = tmp_path / "dfm_artifact"
    serve.main(["--family", "depthfm", "--random", "--size", "32",
                "--num_steps", "1", "--max_batch", "2", "--device", "cpu",
                "--export_artifact", str(art)])
    live = DepthFMPipeline.init_random(0, size=32, num_steps=1, device="cpu")
    served = ExportedDepthFMServing.load(str(art)).bind(
        live.model.state_dict())
    assert served.size == 32 and served.batches == [2]
    assert served.meta["inputs"] == ["image", "mask", "observation"]
    rng = np.random.default_rng(6)
    img = (rng.random((2, 32, 32, 3)) * 255).astype(np.float32)
    msk = (rng.random((2, 32, 32)) > 0.5).astype(np.float32)
    obs = rng.random((2, 32, 32)).astype(np.float32)
    np.testing.assert_array_equal(served(img, msk, obs), live(img, msk, obs))
    with pytest.raises(ValueError, match="requires input"):
        served(img, msk)
