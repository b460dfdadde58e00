"""The port's keep-aspect raw inference (`pipeline/raw_infer.py`) on the
CPU: `keep_aspect_size` against the JAX one over every method, the numpy
INTER_CUBIC (`resize_cubic`) against `cv2.resize` on float64 images bit
for bit (cv2 5.0; up- and downscales at the sizes the keep-aspect rule
gives, one and three channels), `image2tensor_np` against the JAX one bit
for bit, and `infer_image` against the JAX one on the vitt raw model
(JAX init with seeded noise, through the bridge) on a non-square image,
max abs <= 1e-4 of the depth's max (plain attention on both sides)."""

import cv2
import jax
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.pipeline import raw_infer as jax_raw_infer
from amodal_depth_anything_tpu_torch.convert.weights import params_from_jax
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.pipeline.raw_infer import (
    constrain_to_multiple_of, image2tensor_np, infer_image, keep_aspect_size,
    resize_cubic)
from tests.test_torch_models import few_torch_threads  # noqa: F401

SIZES = [(480, 640), (640, 480), (375, 1242), (518, 518), (17, 900),
         (1080, 1920), (100, 101), (3, 5)]


@pytest.mark.parametrize("method", ["lower_bound", "upper_bound", "minimal"])
@pytest.mark.parametrize("multiple", [1, 14, 32])
def test_keep_aspect_size_matches_jax(method, multiple):
    for h, w in SIZES:
        for th, tw in ((518, 518), (384, 512), (700, 300)):
            for keep in (True, False):
                kw = dict(target_height=th, target_width=tw,
                          multiple_of=multiple, keep_aspect_ratio=keep,
                          method=method)
                assert keep_aspect_size(h, w, **kw) == \
                    jax_raw_infer.keep_aspect_size(h, w, **kw), (h, w, kw)


def _port_seeded_tree(jcfg, seed=0):
    """Seeded weights of the JAX config `jcfg`'s DAV2 model in the JAX
    layout: the port's seeded init taken across by the bridge (a JAX init
    run op by op compiles every draw)."""
    import dataclasses

    import torch

    from amodal_depth_anything_tpu_torch.convert.weights import \
        params_to_jax
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model, init_weights_)
    cfg = DAV2Config(**dataclasses.asdict(jcfg))
    model = init_weights_(build_model(cfg, device="cpu"),
                          torch.Generator().manual_seed(seed))
    return params_to_jax(model.state_dict(), cfg)


def test_constrain_to_multiple_of_matches_jax():
    for x in np.linspace(0.0, 100.0, 301):
        for kw in ({}, {"min_val": 28}, {"max_val": 42},
                   {"min_val": 14, "max_val": 56}):
            assert constrain_to_multiple_of(x, 14, **kw) == \
                jax_raw_infer.constrain_to_multiple_of(x, 14, **kw)
    with pytest.raises(ValueError):
        keep_aspect_size(4, 4, target_height=8, target_width=8,
                         method="nope")


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", SIZES)
def test_resize_cubic_matches_cv2_bit_for_bit(hw, channels):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    shape = hw if channels == 1 else hw + (channels,)
    img = rng.integers(0, 256, shape).astype(np.uint8) / 255.0
    h, w = hw
    targets = {keep_aspect_size(h, w, target_height=518, target_width=518,
                                multiple_of=14),
               (max(1, h // 3), max(1, w // 2)), (2 * h + 1, w + 5), (h, w)}
    for oh, ow in targets:
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_CUBIC)
        ours = resize_cubic(img, (oh, ow))
        assert ours.dtype == ref.dtype == np.float64
        assert ours.shape == ref.shape
        np.testing.assert_array_equal(ours, ref, err_msg=str((oh, ow)))


@pytest.mark.parametrize("hw", [(480, 640), (97, 213), (700, 420)])
def test_image2tensor_np_matches_jax(hw):
    rng = np.random.default_rng(1)
    bgr = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    ours, size = image2tensor_np(bgr, 518)
    ref, ref_size = jax_raw_infer.image2tensor_np(bgr, 518)
    assert size == ref_size == hw
    assert ours.shape == ref.shape and ours.shape[1] % 14 == 0
    np.testing.assert_array_equal(ours, ref)


def test_infer_image_matches_jax():
    rng = np.random.default_rng(2)
    jmodel = jax_get_model("DepthAnythingV2Raw", encoder="vitt")
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), _port_seeded_tree(jmodel.config))
    bgr = rng.integers(0, 256, (45, 70, 3)).astype(np.uint8)
    with jax.default_matmul_precision("highest"):
        ref = jax_raw_infer.infer_image(params, jmodel.config, bgr, 70,
                                        attn_impl="xla")
    model = get_model("DepthAnythingV2Raw", encoder="vitt", device="cpu")
    model.load_state_dict(params_from_jax(params, model.cfg), strict=True)
    ours = infer_image(model, bgr, 70, attn_impl="plain")
    assert ours.shape == ref.shape == (45, 70) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
    # the keep-aspect input: lower bound 70 at a multiple of 14
    assert image2tensor_np(bgr, 70)[0].shape == (1, 70, 112, 3)
    assert torch.is_grad_enabled()
