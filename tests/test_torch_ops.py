"""Port ops (resize, conv helpers, blend) vs their JAX counterparts on the
same seeded numpy inputs; max abs <= 1e-5 (float32, sums in another
order). Resize inputs are images in [0, 1), as on the pipeline's path:
torch computes its source indices in float32 where the JAX package builds
its interpolation matrices in float64, a difference of a few 1e-6 per unit
of signal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops import blend as jblend
from amodal_depth_anything_tpu.ops import conv as jconv
from amodal_depth_anything_tpu.ops import resize as jresize
from amodal_depth_anything_tpu_torch.ops import blend, conv, resize
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _img(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(112, 112), (23, 41)])
def test_resize2d_size(method, align_corners, size):
    x = _img((2, 37, 29, 3))
    _close(resize.resize2d(torch.from_numpy(x), size=size, method=method,
                           align_corners=align_corners),
           jresize.resize2d(jnp.asarray(x), size=size, method=method,
                            align_corners=align_corners))


@pytest.mark.parametrize("method,scale,align_corners", [
    # the pos-embed resample of the proxies: 37x37 -> 8x8, (g + 0.1)/37
    ("bicubic", ((8 + 0.1) / 37, (8 + 0.1) / 37), False),
    ("bicubic", ((4 + 0.1) / 37, (6 + 0.1) / 37), False),
    # the DPT fusion upsample
    ("bilinear", 2.0, True),
    ("bilinear", 1.7, False),
])
def test_resize2d_scale_factor(method, scale, align_corners):
    x = _img((1, 37, 37, 8), seed=1)
    _close(resize.resize2d(torch.from_numpy(x), scale_factor=scale,
                           method=method, align_corners=align_corners),
           jresize.resize2d(jnp.asarray(x), scale_factor=scale,
                            method=method, align_corners=align_corners))


def test_resize2d_same_size_is_identity():
    x = torch.from_numpy(_x((1, 9, 9, 2)))
    assert resize.resize2d(x, size=(9, 9)) is x


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("src,size", [((90, 130), (112, 112)),
                                      ((222, 35), (518, 518)),
                                      ((64, 64), (16, 48))])
def test_resize_nearest(exact, src, size):
    x = _img((2, *src, 1), seed=2)
    _close(resize.resize_nearest(torch.from_numpy(x), size=size,
                                 exact=exact),
           jresize.resize_nearest(jnp.asarray(x), size=size, exact=exact))


@pytest.mark.parametrize("k", [4, 2])
def test_conv_transpose_same_stride(k):
    x = _x((2, 5, 6, 8), seed=3)
    w = _x((8, k, k, 6), seed=4)      # JAX layout [C_in, k, k, C_out]
    b = _x((6,), seed=5)
    ref = jconv.conv_transpose_same_stride({"w": jnp.asarray(w),
                                            "b": jnp.asarray(b)},
                                           jnp.asarray(x), k=k)
    ours = conv.conv_transpose_same_stride(
        torch.from_numpy(x), torch.from_numpy(w.transpose(0, 3, 1, 2).copy()),
        torch.from_numpy(b))
    _close(ours, ref)


def test_layer_norm_2d():
    x = _x((2, 7, 9, 16), seed=6) * 3 + 1
    w, b = _x((16,), seed=7), _x((16,), seed=8)
    ref = jconv.layer_norm_2d({"scale": jnp.asarray(w),
                               "bias": jnp.asarray(b)}, jnp.asarray(x))
    _close(conv.layer_norm_2d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b)), ref)


@pytest.mark.parametrize("width", [3, 5])
def test_box_blur(width):
    x = _x((2, 19, 23, 3), seed=9)
    _close(blend.box_blur(torch.from_numpy(x), width),
           jblend.box_blur(jnp.asarray(x), width))


@pytest.mark.parametrize("filter_width", [3, 5])
def test_median_filter_blend(filter_width):
    rng = np.random.default_rng(10)
    amodal = rng.random((2, 33, 27, 1), dtype=np.float32)
    base = rng.random((2, 33, 27, 1), dtype=np.float32)
    mask = np.zeros((2, 33, 27, 1), np.float32)
    mask[0, 5:20, 4:15] = 1.0
    mask[1] = (rng.random((33, 27, 1)) > 0.7).astype(np.float32)
    ref = jblend.median_filter_blend(jnp.asarray(amodal), jnp.asarray(base),
                                     jnp.asarray(mask),
                                     filter_width=filter_width)
    ours = blend.median_filter_blend(torch.from_numpy(amodal),
                                     torch.from_numpy(base),
                                     torch.from_numpy(mask),
                                     filter_width=filter_width)
    _close(ours, ref)
