"""The port's whole slice on the CPU against the JAX package.

`amodal_depth_graph` on the in-repo trained proxies
(`checkpoints/proxy/{raw_base,amodal}.npz`: vitp, 12 layers, width 128,
trained at 112 px, pos-embed for 37x37 patches) against the JAX graph,
max abs <= 1e-4 on both maps; checkpoint loading in the reference's
on-disk formats; and the infer CLI end to end."""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.convert.emit_torch import emit_dav2_sd
from amodal_depth_anything_tpu.models import amodal_dav2 as jdav2
from amodal_depth_anything_tpu.pipeline import amodal_pipeline as jpipe
from amodal_depth_anything_tpu.scripts.train_proxy import \
    load_params_npz as jax_load_params_npz
from amodal_depth_anything_tpu_torch.cli import infer as infer_cli
from amodal_depth_anything_tpu_torch.convert.weights import (
    load_params_npz, params_from_jax)
from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (DAV2Config,
                                                                 build_model)
from amodal_depth_anything_tpu_torch.pipeline.amodal_pipeline import \
    AmodalDepthPipeline
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 1e-4
PROXY = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "proxy")
RAW_CFG = DAV2Config(encoder="vitp", guide_type="none", raw=True)
AMODAL_CFG = DAV2Config(encoder="vitp", guide_type="mask+observation")


def _jcfg(cfg):
    return jdav2.DAV2Config(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def proxy_pipe():
    models = []
    for name, cfg in (("raw_base", RAW_CFG), ("amodal", AMODAL_CFG)):
        model = build_model(cfg)
        model.load_state_dict(params_from_jax(
            load_params_npz(os.path.join(PROXY, f"{name}.npz")), cfg),
            strict=True)
        models.append(model)
    return AmodalDepthPipeline(*models, size=112, device="cpu")


@pytest.fixture(scope="module")
def jax_proxy_params():
    return [jax.tree.map(jnp.asarray, jax_load_params_npz(
        os.path.join(PROXY, f"{name}.npz"))) for name in ("raw_base", "amodal")]


def _image_mask(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random((b, h, w, 3)) * 255).astype(np.float32)
    mask = np.zeros((b, h, w), np.float32)
    mask[:, h // 4: 3 * h // 4, w // 3: 2 * w // 3] = 1.0
    return img, mask


def _jax_graph(params, img, mask, base_image=None):
    base, blended = jpipe.amodal_depth_graph(
        *params, jnp.asarray(img), jnp.asarray(mask[..., None]),
        raw_cfg=_jcfg(RAW_CFG), amodal_cfg=_jcfg(AMODAL_CFG), size=112,
        attn_impl="xla",
        base_image=None if base_image is None else jnp.asarray(base_image))
    return np.asarray(base), np.asarray(blended)


def _assert_close(ours, ref):
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    assert np.isfinite(ours).all()
    assert np.abs(ours - ref).max() <= TOL, np.abs(ours - ref).max()


def test_proxy_graph_matches_jax(proxy_pipe, jax_proxy_params):
    img, mask = _image_mask(2, 90, 130)
    base, blended = proxy_pipe(img, mask)
    ref_base, ref_blended = _jax_graph(jax_proxy_params, img, mask)
    assert base.shape == blended.shape == (2, 112, 112)
    _assert_close(base, ref_base)
    _assert_close(blended, ref_blended)
    assert base.std() > 0.05  # trained weights: a structured depth map


def test_proxy_base_image_branch_matches_jax(proxy_pipe, jax_proxy_params):
    img, mask = _image_mask(1, 70, 70, seed=1)
    base_image = (np.random.default_rng(2).random((1, 112, 112, 3))
                  * 255).astype(np.float32)
    base, blended = proxy_pipe(img, mask, base_image=base_image)
    ref_base, ref_blended = _jax_graph(jax_proxy_params, img, mask,
                                       base_image)
    _assert_close(base, ref_base)
    _assert_close(blended, ref_blended)


def test_single_image_call_squeezes(proxy_pipe):
    img, mask = _image_mask(1, 64, 96, seed=3)
    base, blended = proxy_pipe(img[0], mask[0])
    bbase, bblended = proxy_pipe(img, mask)
    assert base.shape == blended.shape == (112, 112)
    np.testing.assert_array_equal(base, bbase[0])
    np.testing.assert_array_equal(blended, bblended[0])


def _noisy_jax_params(cfg, seed):
    rng = np.random.default_rng(seed)
    tree = jdav2.init_amodal_dav2(jax.random.PRNGKey(seed), _jcfg(cfg))
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), tree)


def _write_checkpoints(tmp_path, sd_raw, sd_amodal):
    """The reference's on-disk formats: the raw base as a torch .pth, the
    AmodalDAv2 as an HF-style directory holding model.safetensors."""
    from safetensors.numpy import save_file
    base = str(tmp_path / "base.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd_raw.items()},
               base)
    ckpt_dir = tmp_path / "amodal_ckpt"
    ckpt_dir.mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in sd_amodal.items()},
              str(ckpt_dir / "model.safetensors"))
    return base, str(ckpt_dir)


def test_from_checkpoints_matches_jax(tmp_path):
    raw_cfg = DAV2Config(encoder="vitt", guide_type="none", raw=True)
    am_cfg = DAV2Config(encoder="vitt", guide_type="mask+observation")
    sd_raw = emit_dav2_sd(_noisy_jax_params(raw_cfg, 1), _jcfg(raw_cfg))
    sd_am = emit_dav2_sd(_noisy_jax_params(am_cfg, 2), _jcfg(am_cfg))
    base, ckpt_dir = _write_checkpoints(tmp_path, sd_raw, sd_am)

    pipe = AmodalDepthPipeline.from_checkpoints(base, ckpt_dir, size=56,
                                                device="cpu")
    assert pipe.raw_cfg == raw_cfg and pipe.amodal_cfg == am_cfg
    ref = jpipe.AmodalDepthPipeline.from_checkpoints(base, ckpt_dir, size=56,
                                                     attn_impl="xla")
    img, mask = _image_mask(2, 60, 44, seed=4)
    for ours, theirs in zip(pipe(img, mask), ref(img, mask)):
        _assert_close(ours, theirs)


def test_from_checkpoints_reads_state_dict_back(tmp_path):
    pipe = AmodalDepthPipeline.init_random(5, size=56, device="cpu")
    base, ckpt_dir = _write_checkpoints(
        tmp_path,
        {k: v.numpy() for k, v in pipe.raw_model.state_dict().items()},
        {k: v.numpy() for k, v in pipe.amodal_model.state_dict().items()})
    loaded = AmodalDepthPipeline.from_checkpoints(
        base, os.path.join(ckpt_dir, "model.safetensors"), size=56,
        device="cpu")
    img, mask = _image_mask(1, 56, 56, seed=6)
    for a, b in zip(pipe(img, mask), loaded(img, mask)):
        np.testing.assert_array_equal(a, b)


def test_init_random_is_seeded_and_mixes_encoders():
    a = AmodalDepthPipeline.init_random(7, size=56, device="cpu")
    b = AmodalDepthPipeline.init_random(7, size=56, device="cpu")
    c = AmodalDepthPipeline.init_random(7, encoder="vitt",
                                        base_encoder="vitp", size=56,
                                        device="cpu")
    assert c.raw_cfg.encoder == "vitp" and c.amodal_cfg.encoder == "vitt"
    img, mask = _image_mask(2, 40, 40, seed=8)
    out_a, out_b, out_c = a(img, mask), b(img, mask), c(img, mask)
    for x, y in zip(out_a, out_b):
        np.testing.assert_array_equal(x, y)
    for out in out_c:
        assert out.shape == (2, 56, 56) and np.isfinite(out).all()


def test_entry_points_default_to_cuda():
    # no CPU fallback: the CPU is used only when the caller asks for it
    assert inspect.signature(
        AmodalDepthPipeline.__init__).parameters["device"].default == "cuda"
    assert inspect.signature(
        AmodalDepthPipeline.init_random).parameters["device"].default == "cuda"
    args = infer_cli.build_parser().parse_args(
        ["--input_image_path", "a", "--input_mask_path", "b",
         "--output_folder", "c"])
    assert args.device == "cuda" and args.size == 518


def test_infer_cli_writes_renders(tmp_path):
    import cv2
    from PIL import Image

    pipe = AmodalDepthPipeline.init_random(9, size=56, device="cpu")
    base, ckpt_dir = _write_checkpoints(
        tmp_path,
        {k: v.numpy() for k, v in pipe.raw_model.state_dict().items()},
        {k: v.numpy() for k, v in pipe.amodal_model.state_dict().items()})
    rng = np.random.default_rng(10)
    img_path, mask_path = str(tmp_path / "scene.png"), str(tmp_path / "m.png")
    cv2.imwrite(img_path, (rng.random((60, 80, 3)) * 255).astype(np.uint8))
    mask = np.zeros((30, 40), np.uint8)
    mask[8:20, 10:30] = 255
    Image.fromarray(mask).save(mask_path)

    out_dir = str(tmp_path / "out")
    infer_cli.main(["--input_image_path", img_path,
                    "--input_mask_path", mask_path,
                    "--output_folder", out_dir, "--base_ckpt", base,
                    "--amodal_ckpt", ckpt_dir, "--size", "56",
                    "--device", "cpu"])
    for name in ("scene_raw_depth_rendered.png",
                 "scene_amodal_depth_rendered.png"):
        render = cv2.imread(os.path.join(out_dir, name))
        assert render is not None and render.shape == (60, 80, 3)
