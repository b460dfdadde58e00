"""The port's renders without cv2, PIL or matplotlib (`utils/image.py`,
`AmodalDepthPipeline.infer_single_image`, `cli.infer`) against those
libraries, bit for bit.

`colorize_depth` indexes a copy of matplotlib's Spectral_r table;
`highlight_target` draws with the C++ port of cv2's findContours +
drawContours; the readers give what `cv2.imread` and `PIL.Image.open` give;
`write_png` writes the pixels `cv2.imwrite` would. `infer_single_image` on
a tiny seeded pipeline writes the renders the cv2 / PIL / matplotlib version
of the same method writes, and `python -m ...cli.infer` runs in a process
where importing cv2, PIL or matplotlib fails."""

import io
import os
import subprocess
import sys

import cv2
import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

from amodal_depth_anything_tpu_torch.ops.resize import resize_nearest
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from amodal_depth_anything_tpu_torch.utils.image import (
    colorize_depth, highlight_target, read_image, read_image_bgr, write_png)
from tests.test_torch_models import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 56


def _mpl_colorize(depth):
    d = np.asarray(depth, np.float32)
    cm = matplotlib.colormaps["Spectral_r"]
    return cm(np.clip(d, 0, 1), bytes=False)[..., :3].astype(np.float32)


def _cv2_highlight(rgb_u8, mask_u8, alpha=0.0):
    mask3 = np.repeat((np.asarray(mask_u8) > 0)[..., None], 3, axis=-1)
    overlay = np.full_like(rgb_u8, 200)
    out = np.where(mask3, rgb_u8,
                   ((1 - alpha) * rgb_u8 + alpha * overlay)).astype(np.uint8)
    contours, _ = cv2.findContours((np.asarray(mask_u8) > 0).astype(
        np.uint8), cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    return cv2.drawContours(out, contours, -1, (0, 0, 0), 2)


def test_spectral_r_table_is_matplotlibs():
    rng = np.random.default_rng(0)
    edges = np.concatenate([np.arange(257, dtype=np.float32) / 256,
                            np.nextafter(np.arange(1, 257, dtype=np.float32)
                                         / 256, np.float32(0)),
                            [-0.5, 0.0, 1.0, 1.5, np.nan]]).astype(
        np.float32)
    for depth in (edges.reshape(1, -1), rng.random((3, 37, 41)).astype(
            np.float32), rng.standard_normal((29, 31)).astype(np.float32)):
        np.testing.assert_array_equal(colorize_depth(depth),
                                      _mpl_colorize(depth))
    # min/max scaling and the valid mask, as the JAX helper applies them
    d = rng.random((20, 30)).astype(np.float32) * 5
    valid = rng.random((20, 30)) > 0.3
    want = _mpl_colorize((d - 1.0) / 3.0)
    want[~valid] = 0
    np.testing.assert_array_equal(
        colorize_depth(d, 1.0, 4.0, valid_mask=valid), want)


def _scene_masks(rng, n):
    """Seeded masks at the renders' size: blobs with holes, nested rings,
    thin strokes, pieces on the borders."""
    for i in range(n):
        m = np.zeros((SIZE, SIZE), np.uint8)
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = (int(v) for v in rng.integers(0, SIZE, 2))
            cv2.circle(m, (cx, cy), int(rng.integers(3, 25)), 255, -1)
        if i % 2:
            cv2.circle(m, (SIZE // 2, SIZE // 2), 9, 0, -1)
            cv2.circle(m, (SIZE // 2, SIZE // 2), 4, 255, -1)
        if i % 3 == 0:
            m[int(rng.integers(0, SIZE)), :] = 255
        yield m


def test_highlight_target_matches_cv2():
    rng = np.random.default_rng(1)
    for m in _scene_masks(rng, 40):
        colored = (colorize_depth(rng.random((SIZE, SIZE))) * 255).astype(
            np.uint8)
        for alpha in (0.0, 0.4):
            np.testing.assert_array_equal(
                highlight_target(colored, m, alpha),
                _cv2_highlight(colored, m, alpha))


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgb", "rgba",
                                  "u16_gray", "u16_rgb", "jpeg"])
def test_readers_match_cv2_and_pil(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = str(tmp_path / ("x.jpg" if kind == "jpeg" else "x.png"))
    shape = {"gray": (13, 17), "gray_alpha": (13, 17, 2), "rgb": (13, 17, 3),
             "rgba": (13, 17, 4), "u16_gray": (13, 17),
             "u16_rgb": (13, 17, 3), "jpeg": (40, 56, 3)}[kind]
    if kind.startswith("u16"):
        arr = (rng.random(shape) * 65535).astype(np.uint16)
        cv2.imwrite(path, arr[..., ::-1] if arr.ndim == 3 else arr)
    else:
        arr = (rng.random(shape) * 255).astype(np.uint8)
        Image.fromarray(arr, "LA" if kind == "gray_alpha" else None).save(
            path, **({"quality": 90} if kind == "jpeg" else {}))
    if kind == "jpeg":
        from amodal_depth_anything_tpu_torch.native import imagecodec
        if not imagecodec.routes()["jpeg"]:
            pytest.skip("built without libjpeg (no jpeglib.h)")
    bgr = read_image_bgr(path)
    assert bgr.dtype == np.uint8 and bgr.flags.c_contiguous
    np.testing.assert_array_equal(bgr, cv2.imread(path))
    np.testing.assert_array_equal(read_image(path),
                                  np.asarray(Image.open(path)))


def test_write_png_pixels_equal_cv2_imwrite(tmp_path):
    rng = np.random.default_rng(3)
    for arr in ((rng.random((21, 34, 3)) * 255).astype(np.uint8),
                (rng.random((21, 34)) * 255).astype(np.uint8),
                (rng.random((21, 34)) * 65535).astype(np.uint16)):
        write_png(str(tmp_path / "mine.png"), arr)
        cv2.imwrite(str(tmp_path / "cv2.png"),
                    arr[..., ::-1] if arr.ndim == 3 else arr)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "mine.png")),
            np.asarray(Image.open(tmp_path / "cv2.png")))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A seeded vitt pipeline at 56 px on the CPU, its weights written as
    the reference's checkpoint files, and a scene (image + mask PNGs)."""
    pipe = AmodalDepthPipeline.init_random(4, encoder="vitt", size=SIZE,
                                           device="cpu")
    root = tmp_path_factory.mktemp("infer")
    base = str(root / "base.pth")
    amodal = str(root / "amodal.pth")
    torch.save(pipe.raw_model.state_dict(), base)
    torch.save(pipe.amodal_model.state_dict(), amodal)
    rng = np.random.default_rng(5)
    img = (rng.random((70, 90, 3)) * 255).astype(np.uint8)
    img[20:50, 30:60] //= 3
    mask = np.zeros((70, 90), np.uint8)
    mask[15:55, 25:70] = 255
    mask[30:40, 40:50] = 0            # a hole: two contours
    Image.fromarray(img).save(root / "scene.png")
    Image.fromarray(mask).save(root / "scene_mask.png")
    return pipe, root, base, amodal


def _reference_infer(pipe, image_path, mask_path):
    """The method's cv2 / PIL / matplotlib version (reference
    infer.py:71-121): the two renders as cv2.imwrite would store them."""
    image = cv2.imread(image_path)
    mask = (np.asarray(Image.open(mask_path)) > 0).astype(np.float32)
    if mask.ndim == 3:
        mask = mask[..., 0]
    base_image = cv2.resize(image, (pipe.size, pipe.size))
    base, blended = pipe(image, mask, base_image=base_image)
    mask_s = resize_nearest(torch.from_numpy(mask[None, :, :, None]),
                            size=(pipe.size, pipe.size))[0, :, :, 0]
    mask_u8 = (mask_s.numpy() > 0).astype(np.uint8) * 255
    h, w = image.shape[:2]

    def render(depth, highlight):
        colored = (_mpl_colorize(depth) * 255).astype(np.uint8)
        if highlight:
            colored = _cv2_highlight(colored, mask_u8)
        colored = cv2.resize(colored, (w, h),
                             interpolation=cv2.INTER_NEAREST)
        return colored[:, :, ::-1]

    return render(base, False), render(blended, True)


def test_infer_single_image_renders_equal_the_library_version(tiny,
                                                              tmp_path):
    pipe, root, _, _ = tiny
    image, mask = str(root / "scene.png"), str(root / "scene_mask.png")
    raw, amodal = pipe.infer_single_image(image, mask, str(tmp_path))
    want_raw, want_amodal = _reference_infer(pipe, image, mask)
    np.testing.assert_array_equal(raw, want_raw)
    np.testing.assert_array_equal(amodal, want_amodal)
    for name, want in (("raw", want_raw), ("amodal", want_amodal)):
        cv2.imwrite(str(tmp_path / f"cv2_{name}.png"), want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path /
                                  f"scene_{name}_depth_rendered.png")),
            np.asarray(Image.open(tmp_path / f"cv2_{name}.png")))


def test_cli_infer_runs_without_cv2_pil_or_matplotlib(tiny, tmp_path):
    pipe, root, base, amodal = tiny
    out = tmp_path / "out"
    code = ("import sys\n"
            "for m in ('cv2', 'PIL', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "from amodal_depth_anything_tpu_torch.cli.infer import main\n"
            f"main({['--input_image_path', str(root / 'scene.png'), '--input_mask_path', str(root / 'scene_mask.png'), '--output_folder', str(out), '--base_ckpt', base, '--amodal_ckpt', amodal, '--size', str(SIZE), '--device', 'cpu']!r})\n"
            "assert all(sys.modules[m] is None for m in "
            "('cv2', 'PIL', 'matplotlib'))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote renders" in proc.stdout
    raw, amodal_r = pipe.infer_single_image(
        str(root / "scene.png"), str(root / "scene_mask.png"),
        str(tmp_path / "inproc"))
    for name, want in (("raw", raw), ("amodal", amodal_r)):
        got = np.asarray(Image.open(io.BytesIO(
            (out / f"scene_{name}_depth_rendered.png").read_bytes())))
        np.testing.assert_array_equal(got, want[:, :, ::-1])
