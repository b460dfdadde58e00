"""The port's host codec pieces that the scripts need on the card's
machine, where PIL, cv2 and the `safetensors` package may be absent:

  * `convert/safetensors.py` against the `safetensors` package, both
    directions, bfloat16 included, and `convert.weights.load_state_dict`
    reading `.safetensors` with the package hidden;
  * PIL's BICUBIC `Image.resize` (`utils.host_image.resize_bicubic`: the
    native resampler and the numpy plain version) against PIL bit for bit
    on uint8 RGB / L and uint16 "I;16" images, up and down, odd sizes;
  * the baseline JPEG decoder (`native.imagecodec.decode_jpeg_baseline`)
    against PIL bit for bit at 4:4:4, 4:2:2 and 4:2:0, greyscale, odd sizes
    and restart intervals, and its refusal of progressive files by name
    (which `decode` leaves to PIL, and `read_image` without PIL raises);
    and the checked-in fixtures under tests/data/ against the sha256 of
    PIL's pixels recorded beside them (what chip_smoke.py checks without
    PIL)."""

import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from amodal_depth_anything_tpu_torch import native
from amodal_depth_anything_tpu_torch.convert import safetensors as st
from amodal_depth_anything_tpu_torch.native import imagecodec
from amodal_depth_anything_tpu_torch.utils import host_image

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
            "f16": torch.randn(4, generator=g).half(),
            "f32": torch.randn(2, 3, 4, generator=g),
            "i64": torch.arange(-3, 4),
            "u8": torch.randint(0, 256, (7,), generator=g,
                                dtype=torch.uint8),
            "bool": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3)}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8) if a.numel() else a.reshape(-1),
        b.reshape(-1).view(torch.uint8) if b.numel() else b.reshape(-1))


@pytest.mark.parametrize("direction", ["ours_to_package", "package_to_ours"])
def test_safetensors_round_trip_with_the_package(tmp_path, direction):
    import safetensors.torch as package
    tensors, path = _tensors(), str(tmp_path / "x.safetensors")
    if direction == "ours_to_package":
        st.save_file(tensors, path, metadata={"format": "pt"})
        back = package.load_file(path)
    else:
        package.save_file(tensors, path, metadata={"format": "pt"})
        back = st.load_file(path)
    assert back.keys() == tensors.keys()
    assert all(_same(back[k], v) for k, v in tensors.items())


def test_load_state_dict_reads_safetensors_without_the_package(
        tmp_path, monkeypatch):
    from amodal_depth_anything_tpu_torch.convert.weights import \
        load_state_dict
    path = str(tmp_path / "model.safetensors")
    st.save_file(_tensors(), path)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    back = load_state_dict(path)
    assert all(_same(back[k], v) for k, v in _tensors().items())
    with pytest.raises(ValueError, match="header"):
        st.load_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{}")


def _image(rng, shape, dtype):
    if dtype == np.uint16:
        a = rng.integers(0, 65536, shape).astype(np.uint16)
        # hard 0 / 65535 edges: the cubic lobes overshoot both ends
        a[:, : shape[1] // 2] = rng.choice([0, 65535], (shape[0],
                                                         shape[1] // 2))
        return a
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGB", "L", "I;16"])
def test_bicubic_resize_equals_pil(mode):
    rng = np.random.default_rng(1)
    channels = (3,) if mode == "RGB" else ()
    dtype = np.uint16 if mode == "I;16" else np.uint8
    overshoot = 0
    for hw in ((17, 23), (5, 3), (64, 48), (1, 9)):
        img = _image(rng, hw + channels, dtype)
        assert Image.fromarray(img).mode == mode
        for out_hw in ((9, 11), (33, 17), (128, 97), (3, 250)):
            ref = np.asarray(Image.fromarray(img).resize(out_hw[::-1]))
            assert ref.dtype == dtype
            for fn in (host_image.resize_bicubic,
                       host_image.resize_bicubic_plain):
                got = fn(img, out_hw[::-1])
                assert got.dtype == dtype and np.array_equal(got, ref), \
                    (fn.__name__, hw, out_hw)
            if mode == "I;16":
                # Pillow clips the high byte and the low byte on their own:
                # an overshoot past 65535 keeps its low byte
                overshoot += int(((ref > 65280) & (ref < 65535)).sum())
    if mode == "I;16":
        assert overshoot > 0
    assert native.available()


def _scene(rng, h, w, c):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (5 + 2 * k)) * 70 + np.cos(yy / (6 + k))
                     * 45 + 128 for k in range(c)], -1)
    a = np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(
        np.uint8)
    return a[..., 0] if c == 1 else a


@pytest.mark.parametrize("subsampling", [0, 1, 2, "L"])
def test_baseline_jpeg_decoder_equals_pil(subsampling):
    rng = np.random.default_rng(2)
    c = 1 if subsampling == "L" else 3
    kw = {} if subsampling == "L" else {"subsampling": subsampling}
    for hw in ((17, 23), (64, 48), (33, 95), (1, 1), (2, 5), (100, 131)):
        for quality in (25, 75, 95):
            for restart in ({}, {"restart_marker_blocks": 1},
                            {"restart_marker_rows": 2}):
                buf = io.BytesIO()
                Image.fromarray(_scene(rng, *hw, c)).save(
                    buf, "JPEG", quality=quality, **kw, **restart)
                data = buf.getvalue()
                ref = np.asarray(Image.open(io.BytesIO(data)))
                got = imagecodec.decode_jpeg_baseline(data)
                assert got.shape == ref.shape and np.array_equal(got, ref), \
                    (hw, quality, restart)


def test_baseline_jpeg_decoder_refuses_progressive_by_name():
    buf = io.BytesIO()
    Image.fromarray(_scene(np.random.default_rng(3), 24, 24, 3)).save(
        buf, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive JPEG"):
        imagecodec.decode_jpeg_baseline(buf.getvalue())
    with pytest.raises(ValueError, match="not a JPEG"):
        imagecodec.decode_jpeg_baseline(b"\x89PNG\r\n\x1a\n")


def test_decode_leaves_refused_jpegs_to_pil(tmp_path, monkeypatch):
    """Without libjpeg, `decode` gives None for what the baseline decoder
    refuses, so `read_image` takes PIL; with PIL hidden too, it raises
    naming the refusal."""
    from amodal_depth_anything_tpu_torch.utils import image as image_util

    buf = io.BytesIO()
    Image.fromarray(_scene(np.random.default_rng(4), 24, 24, 3)).save(
        buf, "JPEG", progressive=True)
    path = tmp_path / "progressive.jpg"
    path.write_bytes(buf.getvalue())
    lib = imagecodec._load()
    monkeypatch.setattr(lib, "codec_routes",
                        lambda: imagecodec.ROUTE_ZLIB)
    assert imagecodec.decode(buf.getvalue()) is None
    ref = np.asarray(Image.open(path))
    assert np.array_equal(image_util.read_image(str(path)), ref)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="progressive JPEG"):
        image_util.read_image(str(path))


def test_jpeg_fixtures_match_their_recorded_pil_pixels():
    meta = json.loads((DATA / "jpeg_fixtures.json").read_text())["files"]
    assert len(meta) == 4
    for name, info in meta.items():
        data = (DATA / name).read_bytes()
        for px in (np.asarray(Image.open(io.BytesIO(data))),
                   imagecodec.decode_jpeg_baseline(data)):
            px = np.ascontiguousarray(px)
            assert list(px.shape) == info["shape"], name
            assert hashlib.sha256(px.tobytes()).hexdigest() == \
                info["sha256"], name
