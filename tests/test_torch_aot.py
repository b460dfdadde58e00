"""Port captured serving programs (`pipeline/aot.py`) on the CPU.

A pipeline the caller built on "cpu" gives handles that run the same
program eagerly, bucket by bucket, by request: their bucket lookup, the
unbucketed-batch error, a MicroBatcher front and outputs bit-identical to
the pipeline's own call are held here. A pipeline on "cuda" captures or
raises: without a card `capture_*` raises, and nothing falls back. The
DepthFM buckets draw their seeded noise once (`seeded_noise`) and give the
per-call draw's output. The card's replays are held in `chip_smoke.py`
(phase 4 against the CPU, phase 9 against the eager call)."""

import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu_torch.models.depthfm import q_sample
from amodal_depth_anything_tpu_torch.pipeline import (
    CapturedAmodalServing, CapturedDepthFMServing, MicroBatcher,
    capture_amodal_program, capture_depthfm_program)
from amodal_depth_anything_tpu_torch.pipeline.aot import depthfm_inputs
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from amodal_depth_anything_tpu_torch.pipeline.depthfm_pipeline import \
    DepthFMPipeline
from tests.test_torch_models import few_torch_threads  # noqa: F401

HW = (40, 48)


@pytest.fixture(scope="module")
def amodal():
    pipe = AmodalDepthPipeline.init_random(7, device="cpu")
    return pipe, capture_amodal_program(pipe, batch=(1, 2), hw=HW)


@pytest.fixture(scope="module")
def depthfm():
    pipe = DepthFMPipeline.init_random(7, device="cpu")
    return pipe, capture_depthfm_program(pipe, batch=2, hw=HW)


def _amodal_inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((batch, *HW, 3)) * 255).astype(np.float32),
            (rng.random((batch, *HW)) > 0.5).astype(np.float32))


def _depthfm_inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((batch, *HW, 3)) * 255).astype(np.float32),
            (rng.random((batch, *HW)) > 0.5).astype(np.float32),
            rng.random((batch, *HW)).astype(np.float32))


def test_amodal_handle_surface_and_outputs(amodal):
    pipe, served = amodal
    assert isinstance(served, CapturedAmodalServing)
    assert served.batches == [1, 2] and served.hw == HW
    assert served.size == pipe.size == 56
    assert served.device.type == "cpu"
    for batch in served.batches:
        img, msk = _amodal_inputs(batch, seed=batch)
        for got, want in zip(served(img, msk), pipe(img, msk)):
            assert got.dtype == np.float32 and got.shape == (batch, 56, 56)
            np.testing.assert_array_equal(got, want)
        # a [B,H,W,1] mask is the same request
        for got, want in zip(served(img, msk[..., None]), pipe(img, msk)):
            np.testing.assert_array_equal(got, want)


def test_unbucketed_batch_and_shape_errors(amodal, depthfm):
    _, served = amodal
    img, msk = _amodal_inputs(3)
    with pytest.raises(ValueError, match="not in compiled buckets"):
        served(img, msk)
    img, msk = _amodal_inputs(2)
    with pytest.raises(ValueError, match="captured for"):
        served(img[:, :-1], msk[:, :-1])
    _, served = depthfm
    img, msk, obs = _depthfm_inputs(1)
    with pytest.raises(ValueError, match="not in compiled buckets"):
        served(img, msk, obs)
    img, msk, obs = _depthfm_inputs(2)
    with pytest.raises(ValueError, match="requires observation"):
        served(img, msk)


def test_microbatcher_front(amodal):
    """The static-bucket contract: MicroBatcher pads request streams to the
    bucket, so any request count serves."""
    pipe, served = amodal
    img, msk = _amodal_inputs(3, seed=4)
    with MicroBatcher(served, max_batch=2, max_delay_ms=0.0) as mb:
        outs = [mb.infer(i, m, timeout=600) for i, m in zip(img, msk)]
    assert mb.dispatches == 3
    for i, (base, blended) in enumerate(outs):
        # each request went through padded to the bucket of two
        want_base, want_blended = pipe(np.stack([img[i]] * 2),
                                       np.stack([msk[i]] * 2))
        np.testing.assert_array_equal(base, want_base[0])
        np.testing.assert_array_equal(blended, want_blended[0])


def test_depthfm_static_noise_equals_the_per_call_draw(depthfm):
    pipe, served = depthfm
    assert isinstance(served, CapturedDepthFMServing)
    assert served.batches == [2] and served.size == 32
    assert depthfm_inputs(pipe.cfg) == ["image", "mask", "observation"]
    img, msk, obs = _depthfm_inputs(2, seed=5)
    want = pipe(img, msk, obs)   # draws from the seeded generator
    noise = pipe.seeded_noise(2)
    assert noise.shape == (2, pipe.latent_size(), pipe.latent_size(), 4)
    assert pipe.latent_size() == 16 and noise.dtype == pipe.dtype
    np.testing.assert_array_equal(pipe(img, msk, obs, noise=noise), want)
    np.testing.assert_array_equal(served(img, msk, obs), want)
    np.testing.assert_array_equal(served(img, msk[..., None], obs), want)


def test_depthfm_latent_size_follows_the_vae():
    pipe = DepthFMPipeline.init_random(1, device="cpu", size=40)
    rgb = torch.zeros(1, 40, 40, 3)
    with torch.inference_mode():
        latent = pipe.model.vae.encode_mode(rgb)
    assert latent.shape[1] == latent.shape[2] == pipe.latent_size()


def test_q_sample_takes_numbers_and_tensors_alike():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4, 4, generator=gen)
    noise = torch.randn(2, 4, 4, 4, generator=gen)
    by_number = q_sample(x, 400, noise)
    by_tensor = q_sample(x, torch.tensor(400.0), noise)
    np.testing.assert_array_equal(by_number.numpy(), by_tensor.numpy())


def test_capture_on_cuda_without_a_card_raises(monkeypatch):
    """A pipeline on "cuda" is captured or the call raises: without a card
    no handle comes back, eager or on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make, capture in ((AmodalDepthPipeline, capture_amodal_program),
                          (DepthFMPipeline, capture_depthfm_program)):
        pipe = make.init_random(0, device="cpu")
        pipe.device = torch.device("cuda")
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            capture(pipe, batch=1, hw=HW)
