"""The port's host libraries (`amodal_depth_anything_tpu_torch/native/`)
against the JAX package's native module, PIL, OpenCV and the port's own
numpy versions, bit for bit.

Both libraries build with g++ into `build/torch_native/`. The codec decodes
PNGs (8- and 16-bit grey, grey + alpha, RGB and RGBA, interlaced) and JPEGs
as the JAX codec and PIL do and rejects what the JAX codec rejects; the
Python-zlib route (a library built without zlib) gives the same arrays. The
resizes, the PIL-bilinear resampler, the PNG row filters and the contour
tracing and drawing equal their numpy and cv2 counterparts on seeded inputs,
and each caller's native route equals its plain route."""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from amodal_depth_anything_tpu import native as jnative
from amodal_depth_anything_tpu.native import imagecodec as jcodec
from amodal_depth_anything_tpu.ops.resize import \
    _nearest_indices as jax_nearest_indices
from amodal_depth_anything_tpu_torch import native
from amodal_depth_anything_tpu_torch.native import _build, imagecodec
from amodal_depth_anything_tpu_torch.utils import host_image
from tests.test_native import _write_adam7_png


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(12)


def _png(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, **kw).save(buf, format="PNG")
    return buf.getvalue()


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def _raw_png(arr: np.ndarray, color: int, depth: int, extra=b"") -> bytes:
    """A PNG with unfiltered rows and optional chunks before IDAT."""
    h, w = arr.shape[:2]
    rows = arr.astype(">u2").view(np.uint8) if depth == 16 else arr
    raw = b"".join(b"\x00" + r.tobytes() for r in rows.reshape(h, -1))
    return (host_image.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                          0, 0, 0))
            + extra + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def test_both_libraries_build_into_the_build_directory():
    for path in (native.require(), imagecodec.require()):
        assert path.startswith(str(_build.BUILD_DIR))
        assert path.endswith(".so")
    assert native.available() and imagecodec.available()
    routes = imagecodec.routes()
    assert routes["png"] in ("zlib", "python-zlib")
    assert routes["jpeg"] == _build.header_found("jpeglib.h")


# ---------------------------------------------------------------- codec

def _cases(rng):
    return {
        "u8_gray": (rng.random((20, 30)) * 255).astype(np.uint8),
        "u8_gray_alpha": (rng.random((17, 13, 2)) * 255).astype(np.uint8),
        "u8_rgb": (rng.random((21, 31, 3)) * 255).astype(np.uint8),
        "u8_rgba": (rng.random((19, 33, 4)) * 255).astype(np.uint8),
        "u16_gray": (rng.random((20, 30)) * 65535).astype(np.uint16),
    }


@pytest.mark.parametrize("name", ["u8_gray", "u8_gray_alpha", "u8_rgb",
                                  "u8_rgba", "u16_gray"])
def test_png_decodes_as_the_jax_codec_and_pil(rng, name):
    arr = _cases(rng)[name]
    data = _png(arr, mode="LA") if name == "u8_gray_alpha" else _png(arr)
    mine = imagecodec.decode(data)
    for ref in (jcodec.decode(data),
                np.asarray(Image.open(io.BytesIO(data)))):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, arr)


@pytest.mark.parametrize("color,channels", [(2, 3), (6, 4), (4, 2)])
def test_16_bit_colour_png_keeps_its_samples_as_the_jax_codec(rng, color,
                                                              channels):
    arr = (rng.random((9, 11, channels)) * 65535).astype(np.uint16)
    data = _raw_png(arr, color, 16)
    mine = imagecodec.decode(data)
    assert mine.dtype == np.uint16
    np.testing.assert_array_equal(mine, jcodec.decode(data))
    np.testing.assert_array_equal(mine, arr)
    # the server's decode keeps PIL's reading: the high byte
    np.testing.assert_array_equal(host_image.decode_png(data),
                                  (arr >> 8).astype(np.uint8))


@pytest.mark.parametrize("hw", [(16, 16), (13, 7), (1, 1), (3, 9)])
def test_interlaced_png_decodes(rng, hw):
    gray = (rng.random(hw) * 255).astype(np.uint8)
    data = _write_adam7_png(gray)
    np.testing.assert_array_equal(imagecodec.decode(data), gray)
    np.testing.assert_array_equal(imagecodec.decode(data),
                                  jcodec.decode(data))


def test_jpeg_decodes_as_the_jax_codec_and_pil(rng):
    if not imagecodec.routes()["jpeg"]:
        pytest.skip("built without libjpeg (no jpeglib.h)")
    for arr in (_cases(rng)["u8_rgb"], _cases(rng)["u8_gray"]):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=90)
        data = buf.getvalue()
        mine = imagecodec.decode(data)
        np.testing.assert_array_equal(mine, jcodec.decode(data))
        np.testing.assert_array_equal(
            mine, np.asarray(Image.open(io.BytesIO(data))))


@pytest.mark.parametrize("kind", ["palette", "1-bit", "gray-trns",
                                  "rgb-trns"])
def test_rejections_match_the_jax_codec(rng, kind):
    im = Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8))
    if kind == "palette":
        buf = io.BytesIO()
        im.convert("P", palette=Image.ADAPTIVE).save(buf, format="PNG")
        data = buf.getvalue()
    elif kind == "1-bit":
        buf = io.BytesIO()
        im.convert("1").save(buf, format="PNG")
        data = buf.getvalue()
    elif kind == "gray-trns":
        data = _raw_png((rng.random((8, 8)) * 254).astype(np.uint8), 0, 8,
                        _chunk(b"tRNS", b"\x00\x07"))
    else:
        data = _raw_png((rng.random((8, 8, 3)) * 254).astype(np.uint8), 2,
                        8, _chunk(b"tRNS", b"\x00\x01\x00\x02\x00\x03"))
    assert jcodec.decode(data) is None
    assert imagecodec.decode(data) is None
    # the server and the loaders take their plain route for these
    np.testing.assert_array_equal(host_image.decode_png(data),
                                  np.asarray(Image.open(io.BytesIO(data))))


def test_python_zlib_route_decodes_the_same(rng, monkeypatch):
    """A library built without zlib (the route where zlib.h is missing):
    the IDAT stream goes through Python's zlib between two calls."""
    lib, extra = _build.load("imagecodec", [((), ())])
    assert extra == () and imagecodec.bind(lib).codec_routes() == 0
    monkeypatch.setattr(imagecodec, "_lib", lib)
    for name, arr in _cases(rng).items():
        data = _png(arr, mode="LA") if name == "u8_gray_alpha" else _png(arr)
        np.testing.assert_array_equal(imagecodec.decode(data), arr,
                                      err_msg=name)
    gray = (rng.random((11, 6)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(imagecodec.decode(_write_adam7_png(gray)),
                                  gray)


def test_decode_png_routes_agree_on_filtered_rows(rng):
    """PNGs whose rows use all five filters (PIL's choice, and libpng's
    Average rows via cv2) decode the same through both routes."""
    smooth = np.cumsum(rng.integers(0, 3, (40, 50, 3)), axis=1).astype(
        np.uint8)
    textured = (rng.random((40, 50, 3)) * 255).astype(np.uint8)
    for arr in (smooth, textured):
        for data in (host_image.encode_png(arr),
                     cv2.imencode(".png", arr[..., ::-1])[1].tobytes()):
            with native.plain_route():
                plain = host_image.decode_png(data)
            np.testing.assert_array_equal(host_image.decode_png(data), plain)
            np.testing.assert_array_equal(plain, arr)


# ------------------------------------------------------- row filters

@pytest.mark.parametrize("name", ["u8_gray", "u8_rgb", "u8_rgba",
                                  "u16_gray"])
def test_filter_rows_and_encode_match_the_numpy_version(rng, name):
    arr = _cases(rng)[name]
    if arr.dtype == np.uint16:
        rows, bpp = arr.astype(">u2").view(np.uint8), 2
    else:
        rows, bpp = arr.reshape(arr.shape[0], -1), \
            1 if arr.ndim == 2 else arr.shape[2]
    rows = rows.reshape(arr.shape[0], -1)
    np.testing.assert_array_equal(imagecodec.filter_rows(rows, bpp),
                                  host_image._filter_rows(rows, bpp))
    with native.plain_route():
        plain = host_image.encode_png(arr)
    assert host_image.encode_png(arr) == plain


# ----------------------------------------------------------- resizes

def _jax_nearest(img, hw):
    rows = jax_nearest_indices(img.shape[0], hw[0], None, True)
    cols = jax_nearest_indices(img.shape[1], hw[1], None, True)
    return img[rows][:, cols]


def test_nearest_exact_resizes_match_the_jax_native_module(rng):
    img = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    for hw in [(64, 64), (17, 23), (37, 53)]:
        mine = native.resize_u8_to_f32(img, hw, scale=1.0 / 255.0)
        np.testing.assert_array_equal(
            mine, jnative.resize_u8_to_f32(img, hw, scale=1.0 / 255.0))
    d16 = (rng.random((41, 29)) * 65535).astype(np.uint16)
    np.testing.assert_array_equal(native.resize_u16_to_f32(d16, (64, 64)),
                                  jnative.resize_u16_to_f32(d16, (64, 64)))
    for f in (rng.random((31, 47, 4)).astype(np.float32),
              rng.random((31, 47)).astype(np.float32)):
        mine = native.resize_f32(f, (20, 24))
        np.testing.assert_array_equal(mine, jnative.resize_f32(f, (20, 24)))
        np.testing.assert_array_equal(mine, _jax_nearest(f, (20, 24)))


def test_dataset_reads_and_resizes_through_the_native_route(rng, tmp_path):
    from amodal_depth_anything_tpu.data.base_depth_dataset import \
        resize_nearest_exact_np as jax_resize
    from amodal_depth_anything_tpu_torch.data.base_depth_dataset import (
        BaseDepthDataset, DatasetMode, DepthFileNameMode,
        resize_nearest_exact_np)

    img = rng.random((33, 44, 3)).astype(np.float32)
    np.testing.assert_array_equal(resize_nearest_exact_np(img, (56, 56)),
                                  jax_resize(img, (56, 56)))
    d16 = (rng.random((12, 14)) * 65535).astype(np.uint16)
    rgb16 = (rng.random((12, 14, 3)) * 65535).astype(np.uint16)
    (tmp_path / "d.png").write_bytes(_png(d16))
    (tmp_path / "c.png").write_bytes(_raw_png(rgb16, 2, 16))
    (tmp_path / "list.txt").write_text("d.png d.png\n")
    ds = BaseDepthDataset(mode=DatasetMode.EVAL,
                          filename_ls_path=str(tmp_path / "list.txt"),
                          dataset_dir=str(tmp_path),
                          name_mode=DepthFileNameMode.id)
    got = ds._read_image("d.png")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, d16)
    # 16-bit colour keeps its samples, as the JAX package's loader reads it
    np.testing.assert_array_equal(ds._read_image("c.png"), rgb16)


@pytest.mark.parametrize("kind", ["u8_rgb", "u8_gray", "f32"])
def test_pil_bilinear_matches_the_numpy_version_and_pil(rng, kind):
    for trial in range(12):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        oh, ow = (int(v) for v in rng.integers(1, 90, 2))
        if kind == "u8_rgb":
            img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        elif kind == "u8_gray":
            img = (rng.random((h, w)) * 255).astype(np.uint8)
        else:
            img = rng.random((h, w)).astype(np.float32)
        mine = native.resize_bilinear(img, (ow, oh))
        np.testing.assert_array_equal(
            mine, host_image.resize_bilinear_plain(img, (ow, oh)))
        pil = np.asarray(Image.fromarray(img).resize((ow, oh),
                                                     Image.BILINEAR))
        np.testing.assert_array_equal(mine, pil)


def test_pil_nearest_gather_matches_the_numpy_version(rng):
    for img in ((rng.random((23, 41, 3)) * 255).astype(np.uint8),
                (rng.random((23, 41)) * 65535).astype(np.uint16),
                rng.random((23, 41)) > 0.5):
        for size in ((64, 48), (7, 5), (41, 23)):
            mine = host_image.resize_nearest(img, size)
            plain = host_image.resize_nearest_plain(img, size)
            assert mine.dtype == plain.dtype
            np.testing.assert_array_equal(mine, plain)


# ---------------------------------------------------------- contours

def _masks(rng, n):
    """Seeded masks with holes, nested rings, one-pixel lines and single
    pixels, touching the borders."""
    for i in range(n):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        m = (rng.random((h, w)) > rng.random()).astype(np.uint8)
        if i % 3 == 0:
            m = cv2.dilate(m, np.ones((3, 3), np.uint8))
        if i % 4 == 1 and min(h, w) > 12:
            m[:] = 0
            cy, cx = h // 2, w // 2
            for r, v in ((min(h, w) // 2 - 1, 1), (min(h, w) // 3, 0),
                         (min(h, w) // 5, 1), (1, 0)):
                cv2.circle(m, (cx, cy), r, v, -1)
        yield m


def test_find_contours_matches_cv2(rng):
    for m in _masks(rng, 120):
        mine = native.find_contours(m)
        ref, _ = cv2.findContours(m, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
        assert sorted(c.tobytes() for c in mine) == sorted(
            np.asarray(c, np.int32).tobytes() for c in ref)


def test_draw_contours_matches_cv2(rng):
    for m in _masks(rng, 120):
        img = (rng.random(m.shape + (3,)) * 255).astype(np.uint8)
        ref, _ = cv2.findContours(m, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
        want = cv2.drawContours(img.copy(), ref, -1, (0, 0, 0), 2)
        np.testing.assert_array_equal(
            native.draw_contours(img.copy(), ref, (0, 0, 0), 2), want)
        np.testing.assert_array_equal(
            native.draw_mask_contours(img.copy(), m, (0, 0, 0), 2), want)
