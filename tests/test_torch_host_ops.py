"""`heuristics/host_ops.py` against cv2, bit for bit: INTER_LINEAR on uint8
and float32, INTER_AREA on uint8 (integer and non-integer factors, down
and up), INTER_NEAREST and `connectedComponentsWithStats` (8-connectivity,
label order, stats, centroids), on random and edge inputs: odd sizes,
one-pixel rows and columns, upscales and downscales, components touching
the border, more prompts than `max_points`.

Known gap, measured here rather than hidden: on float32 with 3 channels,
cv2 (through Intel IPP) takes another kernel for large upscales from
narrow sources; there `resize_linear` can differ in the last bit (the
sweep below counts such cases and bounds the difference by 4 units in the
last place of the image's largest value)."""

import numpy as np
import pytest

from amodal_depth_anything_tpu_torch.heuristics import host_ops
from amodal_depth_anything_tpu_torch.heuristics.mask_heuristics import \
    get_points_from_components

cv2 = pytest.importorskip("cv2")

# (src h, src w, dst h, dst w): the heuristics' own geometries (SAM's 1024
# input and 256 logits, pix2gestalt's 256, RMBG's 1024, a 600 x 800 scene)
# and odd, one-pixel and exact-factor ones
GEOMETRIES = [(600, 800, 1024, 1024), (600, 800, 256, 256),
              (256, 256, 600, 800), (1024, 1024, 600, 800),
              (256, 256, 1024, 1024), (37, 53, 64, 64), (64, 64, 37, 53),
              (33, 47, 19, 71), (1, 9, 5, 13), (9, 1, 13, 5), (1, 1, 3, 4),
              (40, 60, 20, 30), (45, 60, 15, 20), (12, 18, 3, 9),
              (7, 11, 7, 11), (5, 640, 3, 480)]


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


@pytest.mark.parametrize("h,w,oh,ow", GEOMETRIES)
@pytest.mark.parametrize("ch", [1, 3])
def test_linear_uint8_equals_cv2(h, w, oh, ow, ch):
    img = _u8((h, w, 3) if ch == 3 else (h, w), h * w + ch)
    np.testing.assert_array_equal(host_ops.resize_linear(img, (ow, oh)),
                                  cv2.resize(img, (ow, oh)))


@pytest.mark.parametrize("h,w,oh,ow", GEOMETRIES)
def test_linear_float32_equals_cv2(h, w, oh, ow):
    # one channel (SAM's logits, RMBG's alpha) at every geometry, three
    # (RMBG's input) at the heuristics' own
    img = np.random.default_rng(h + w).standard_normal((h, w)).astype(
        np.float32)
    np.testing.assert_array_equal(host_ops.resize_linear(img, (ow, oh)),
                                  cv2.resize(img, (ow, oh)))
    if min(h, w) >= 37:
        rgb = np.random.default_rng(h).random((h, w, 3)).astype(np.float32)
        np.testing.assert_array_equal(host_ops.resize_linear(rgb, (ow, oh)),
                                      cv2.resize(rgb, (ow, oh)))


def test_linear_float32_sweep_counts_the_known_gap():
    rng = np.random.default_rng(0)
    exact, off = 0, []
    for _ in range(120):
        h, w = rng.integers(2, 60, 2)
        oh, ow = (int(v) for v in rng.integers(1, 90, 2))
        ch = int(rng.choice([1, 3]))
        img = rng.standard_normal((h, w, ch) if ch == 3 else (h, w)).astype(
            np.float32)
        ref = cv2.resize(img, (ow, oh))
        got = host_ops.resize_linear(img, (ow, oh))
        if np.array_equal(ref, got):
            exact += 1
            continue
        # in units of the last place of the image's largest value
        ulp = np.abs(got - ref).max() / np.spacing(np.abs(img).max())
        off.append((int(h), int(w), oh, ow, ch, float(ulp)))
    print(f"float32 INTER_LINEAR sweep: {exact} of 120 bit-exact; "
          f"differing: {off}")
    assert all(case[4] == 3 or min(case[:2]) < 10 for case in off)
    assert all(case[5] <= 4 for case in off)
    assert exact >= 100


@pytest.mark.parametrize("h,w,oh,ow", GEOMETRIES + [(600, 800, 32, 32)])
def test_area_equals_cv2(h, w, oh, ow):
    rng = np.random.default_rng(h * 7 + w)
    mask = (rng.random((h, w)) > 0.5).astype(np.uint8) * 255
    for img in (mask, _u8((h, w, 3), 1)):
        np.testing.assert_array_equal(
            host_ops.resize_area(img, (ow, oh)),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("h,w,oh,ow", GEOMETRIES)
def test_nearest_equals_cv2(h, w, oh, ow):
    f = np.random.default_rng(3).standard_normal((h, w)).astype(np.float32)
    rgb = _u8((h, w, 3), 4)
    for img in (f, rgb):
        np.testing.assert_array_equal(
            host_ops.resize_nearest(img, (ow, oh)),
            cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST))


def _cc_equal(mask):
    ref = cv2.connectedComponentsWithStats(mask, connectivity=8)
    got = host_ops.connected_components_with_stats(mask)
    assert got[0] == ref[0]
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("hw", [(31, 45), (64, 64), (1, 17), (17, 1)])
def test_components_equal_cv2(seed, hw):
    rng = np.random.default_rng(seed)
    # sparse to dense, so that components touch the border and each other
    # only diagonally (8-connectivity joins them)
    mask = (rng.random(hw) > 0.35 + 0.1 * seed).astype(np.uint8) * 255
    _cc_equal(mask)


def test_components_edge_cases():
    _cc_equal(np.zeros((5, 7), np.uint8))
    _cc_equal(np.full((5, 7), 255, np.uint8))
    stairs = np.zeros((9, 9), np.uint8)
    for i in range(9):
        stairs[i, 8 - i] = 1                 # one diagonal component
    stairs[0, 0] = stairs[8, 8] = 1          # corners, alone
    _cc_equal(stairs)


def test_points_from_components_as_the_jax_package_picks_them():
    """More than 64 prompts (the grid over a large component plus many
    small ones, some on the border): the same points, in the same order."""
    from amodal_depth_anything_tpu.heuristics.mask_heuristics import \
        get_points_from_components as jax_points
    mask = np.zeros((120, 160), np.uint8)
    mask[20:100, 30:130] = 255               # > 100 px: an 8 x 10 grid
    rng = np.random.default_rng(5)
    for y, x in rng.integers(0, 118, (40, 2)):
        mask[y:y + 2, (x + 30) % 159:(x + 30) % 159 + 2] = 255
    mask[0, :3] = mask[-1, -2:] = 255        # on the border
    got = get_points_from_components(mask)
    ref = jax_points(mask)
    assert len(got) > 64
    np.testing.assert_array_equal(got, ref)
