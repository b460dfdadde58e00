"""The port's data-factory, baseline and checkpoint scripts against the JAX
package's, on the same tiny trees and the same weights (vitt DAV2 written
as a reference `.pth`, a tiny plain DepthFM as `depthfm-v1.ckpt` +
`vae.pth`), float32 on both sides.

Tolerances: float maps 1e-5; the uint16 PNGs the scripts write at most one
code apart (each counted: `record_property`), metrics 1e-4 relative. The
port reads and writes every image through its host codec; the JAX scripts
through PIL."""

import dataclasses
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (DAV2Config,
                                                                build_model,
                                                                init_weights_)
from tests.test_torch_models import few_torch_threads  # noqa: F401

STEMS = ["a1", "b2", "c3", "d4"]


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _scene(rng, hw=40):
    yy, xx = np.mgrid[0:hw, 0:hw]
    img = np.stack([np.sin(xx / (4 + k)) * 70 + np.cos(yy / 5) * 40 + 128
                    for k in range(3)], -1) + rng.normal(0, 12, (hw, hw, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def p2g_tree(tmp_path_factory):
    """The pix2gestalt occlusions layout (4 samples, 40 px) and a seeded
    raw vitt DAV2 as a reference `.pth`."""
    root = tmp_path_factory.mktemp("p2g_tree")
    rng = np.random.default_rng(0)
    for s in STEMS:
        whole = _scene(rng)
        occ = whole.copy()
        occ[:, 24:] = 200
        vis = np.zeros((40, 40), np.uint8)
        vis[8:30, 6:24] = 255
        wm = vis.copy()
        wm[8:30, 6:34] = 255
        _png(f"{root}/whole/{s}_whole.png", whole)
        _png(f"{root}/occlusion/{s}_occlusion.png", occ)
        _png(f"{root}/visible_object_mask/{s}_visible_mask.png", vis)
        _png(f"{root}/whole_mask/{s}_whole_mask.png", wm)
        depth = (rng.random((40, 40)) * 30000 + 20000).astype(np.uint16)
        _png(f"{root}/depth_da_update_combine/{s}_depth.png", depth)
    model = init_weights_(build_model(DAV2Config(
        encoder="vitt", guide_type="none", raw=True)),
        torch.Generator().manual_seed(4))
    ckpt = str(root / "raw_vitt.pth")
    torch.save(model.state_dict(), ckpt)
    return str(root), ckpt


def _read(path):
    return np.asarray(Image.open(path))


def _codes_apart(ours_dir, ref_dir, names, record_property, key):
    """Each PNG of `names` in both dirs at most one code apart; the count
    of differing samples is recorded under `key`."""
    flips = 0
    for name in names:
        a = _read(os.path.join(ours_dir, name)).astype(np.int64)
        b = _read(os.path.join(ref_dir, name)).astype(np.int64)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 1, name
        flips += int((a != b).sum())
    record_property(key, flips)
    return flips


def test_sam_pl_gen_matches_jax(p2g_tree, tmp_path, monkeypatch,
                                record_property):
    """Both mains on the same tree. The uint16 maps each script quantises
    (before its bicubic resize to --out_size) at most one code apart; the
    port's written PNGs are PIL's bicubic resize of its own maps, bit for
    bit; then the float maps of the labellers."""
    import amodal_depth_anything_tpu_torch.utils.image as timage
    from amodal_depth_anything_tpu.convert.torch_to_jax import (
        convert_dav2, infer_dav2_config, load_state_dict)
    from amodal_depth_anything_tpu.scripts import sam_pl_gen as jscript
    from amodal_depth_anything_tpu_torch.scripts import sam_pl_gen

    maps = {"ref": [], "ours": []}
    pil_resize, port_resize = Image.Image.resize, timage.resize_default

    def record_pil(im, *a, **kw):
        maps["ref"].append(np.asarray(im).copy())
        return pil_resize(im, *a, **kw)

    def record_port(img, size):
        maps["ours"].append(img.copy())
        return port_resize(img, size)

    monkeypatch.setattr(Image.Image, "resize", record_pil)
    monkeypatch.setattr(timage, "resize_default", record_port)
    root, ckpt = p2g_tree
    trees = {}
    for name, main, extra in (("ref", jscript.main, []),
                              ("ours", sam_pl_gen.main, ["--device", "cpu"])):
        tree = tmp_path / name
        os.makedirs(tree)
        for sub in ("whole", "occlusion", "visible_object_mask",
                    "whole_mask"):
            os.symlink(os.path.join(root, sub), tree / sub)
        main(["--data_root", str(tree), "--base_ckpt", ckpt, "--size", "56",
              "--out_size", "48", "--batch", "2", "--num_chunks", "2",
              "--data_index", "1"] + extra)
        trees[name] = tree
    monkeypatch.undo()
    # np.array_split: the second of two chunks holds the last two stems
    names = [f"{s}_depth.png" for s in STEMS[2:]]
    for sub in ("depth_da_update_occ", "depth_da_update_combine"):
        assert sorted(os.listdir(trees["ours"] / sub)) == names
    ref_maps = [m for m in maps["ref"] if m.dtype == np.uint16]
    assert len(ref_maps) == len(maps["ours"]) == 4
    flips = 0
    for a, b in zip(maps["ours"], ref_maps):
        assert np.abs(a.astype(np.int64) - b).max() <= 1
        flips += int((a != b).sum())
    record_property("codes_apart", flips)
    # written in the order (stem c3: occ, combined), (stem d4: ...)
    for i, (stem, sub) in enumerate(
            (s, sub) for s in STEMS[2:]
            for sub in ("depth_da_update_occ", "depth_da_update_combine")):
        assert np.array_equal(
            _read(trees["ours"] / sub / f"{stem}_depth.png"),
            np.asarray(Image.fromarray(maps["ours"][i]).resize((48, 48))))

    # the float maps of one batch, labeller against labeller
    rng = np.random.default_rng(1)
    whole, occ = (rng.random((2, 56, 56, 3)).astype(np.float32)
                  for _ in range(2))
    vis = (rng.random((2, 56, 56, 1)) > 0.4).astype(np.float32)
    wm = np.maximum(vis, (rng.random((2, 56, 56, 1)) > 0.5)).astype(
        np.float32)
    sd = load_state_dict(ckpt)
    cfg = infer_dav2_config(sd, raw=True)
    ref = jscript.make_label_fn(cfg, 56)(
        convert_dav2(sd, cfg), *map(jnp.asarray, (whole, occ, vis, wm)))
    label = sam_pl_gen.make_label_fn(sam_pl_gen.load_raw_dav2(
        ckpt, torch.device("cpu")))
    ours = label(*map(torch.from_numpy, (whole, occ, vis, wm)))
    for a, b in zip(ours, ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5


def test_pix2gestalt_eval_single_matches_jax(p2g_tree, tmp_path,
                                             record_property):
    from amodal_depth_anything_tpu.scripts import \
        pix2gestalt_eval_single as jscript
    from amodal_depth_anything_tpu_torch.scripts import \
        pix2gestalt_eval_single

    root, ckpt = p2g_tree
    # the reconstruction as a JPEG (the reference's pred_reconstructions.jpg)
    rec = tmp_path / "rec.jpg"
    Image.open(f"{root}/whole/a1_whole.png").save(rec, quality=90)
    args = ["--reconstruction", str(rec),
            "--raw_depth", f"{root}/depth_da_update_combine/a1_depth.png",
            "--visible_mask", f"{root}/visible_object_mask/a1_visible_mask"
                              ".png",
            "--checkpoint", ckpt, "--size", "56", "--out_size", "48"]
    ref_depth, ref_aligned = jscript.main(
        args + ["--output_dir", str(tmp_path / "ref")])
    depth, aligned = pix2gestalt_eval_single.main(
        args + ["--output_dir", str(tmp_path / "ours"), "--device", "cpu"])
    assert np.abs(depth - np.asarray(ref_depth)).max() <= 1e-5
    assert np.abs(aligned - ref_aligned).max() <= 1e-5
    _codes_apart(tmp_path / "ours", tmp_path / "ref",
                 ["pred_depth.png", "combined_depth.png"], record_property,
                 "codes_apart")


class _Heuristics:
    """A deterministic stand-in for MaskHeuristics (the completion and the
    matting are held against JAX in the heuristics tests): the occluded
    render's top-left 32 px, and an optional matting hook."""

    def __init__(self, matting):
        self.matting_fn = (lambda c: c[..., 0] - 0.5) if matting else None

    def pix2gestalt_completion(self, occ, visible):
        assert visible.shape == (256, 256)
        return occ[:32, :32].astype(np.float32) / 255.0


@pytest.mark.parametrize("matting", [False, True])
def test_pix2gestalt_inpainting_run_matches_jax(p2g_tree, tmp_path, matting,
                                                record_property):
    import argparse

    from amodal_depth_anything_tpu.convert.torch_to_jax import (
        convert_dav2, infer_dav2_config, load_state_dict)
    from amodal_depth_anything_tpu.models.amodal_dav2 import apply_raw_dav2
    from amodal_depth_anything_tpu.ops.resize import resize2d
    from amodal_depth_anything_tpu.scripts import \
        pix2gestalt_inpainting as jscript
    from amodal_depth_anything_tpu_torch.scripts import (
        pix2gestalt_eval_single, pix2gestalt_inpainting, sam_pl_gen)

    root, ckpt = p2g_tree
    split = tmp_path / "split.txt"
    split.write_text("".join(f"sa_{s}.jpg\n" for s in STEMS[:2]))
    sd = load_state_dict(ckpt)
    cfg = infer_dav2_config(sd, raw=True)
    params = convert_dav2(sd, cfg)

    @jax.jit
    def jax_apply(comp_u8):
        x = jnp.asarray(comp_u8, jnp.float32)[None] / 255.0
        x = resize2d(x, size=(56, 56), method="bilinear")
        d = apply_raw_dav2(params, cfg, x)
        return (d - d.min()) / jnp.maximum(d.max() - d.min(), 1e-8)

    port_apply = pix2gestalt_eval_single.make_dav2_apply(
        sam_pl_gen.load_raw_dav2(ckpt, torch.device("cpu")), 56)
    results = {}
    for name, mod, apply in (("ref", jscript, jax_apply),
                             ("ours", pix2gestalt_inpainting, port_apply)):
        args = argparse.Namespace(
            data_dir=root, split=str(split), output_dir=str(tmp_path / name),
            limit=0, metrics=["rmse_linear", "log10", "delta1_acc"])
        results[name] = mod.run(args, _Heuristics(matting), apply)
    (ref_banks, n_ref), (banks, n) = results["ref"], results["ours"]
    assert n == n_ref == 2
    for key, bank in ref_banks.items():
        for metric, val in bank.result().items():
            ours = banks[key].result()[metric]
            if np.isnan(val):   # an empty bucket
                assert np.isnan(ours), (key, metric)
                continue
            assert abs(ours - val) <= 1e-4 * max(1.0, abs(val)), (key, metric)
    for sub, suffix in (("amodal_inpainting", "_amodal_inpainting.png"),
                        ("amodal_mask", "_amodal_mask.png"),
                        ("amodal_depth", "_depth.png"),
                        ("amodal_aligned_depth", "_depth.png")):
        _codes_apart(tmp_path / "ours" / sub, tmp_path / "ref" / sub,
                     [f"{s}{suffix}" for s in STEMS[:2]], record_property,
                     f"{sub}_codes_apart")


def test_pix2gestalt_inpainting_checks_deep_cache_first(tmp_path):
    """A DeepCache interval that does not divide the DDIM steps stops the
    script before any checkpoint is read."""
    from amodal_depth_anything_tpu_torch.scripts import \
        pix2gestalt_inpainting
    with pytest.raises(SystemExit, match="does not divide"):
        pix2gestalt_inpainting.main([
            "--data_dir", str(tmp_path), "--split", "none.txt",
            "--sam_ckpt", "absent.pth", "--dav2_ckpt", "absent.pth",
            "--output_dir", str(tmp_path), "--ddim_steps", "5",
            "--deep_cache", "2", "--device", "cpu"])


def _zeros_init(jmodel):
    """`jmodel` whose `init` gives zeros of the init's shapes and dtypes,
    traced without a compile."""
    def init(key):
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            jax.eval_shape(jmodel.init, key))
    return dataclasses.replace(jmodel, init=init)


def test_batch_inference_matches_jax(tmp_path, monkeypatch):
    import amodal_depth_anything_tpu.models as jmodels
    import amodal_depth_anything_tpu.train as jtrain
    import amodal_depth_anything_tpu_torch.models as tmodels
    import amodal_depth_anything_tpu_torch.train as ttrain
    from amodal_depth_anything_tpu.scripts import batch_inference as jscript
    from amodal_depth_anything_tpu_torch.data.synthetic import \
        make_synthetic_sam_tree
    from amodal_depth_anything_tpu_torch.scripts import batch_inference

    root = tmp_path / "sam"
    split = make_synthetic_sam_tree(str(root), n=8, hw=56)
    model = init_weights_(build_model(DAV2Config(encoder="vitt")),
                          torch.Generator().manual_seed(5))
    # seeded noise on every weight: the init's near-constant prediction
    # makes the aligned metrics an ill-conditioned fit
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    ckpt = str(tmp_path / "guided_vitt.pth")
    torch.save(model.state_dict(), ckpt)
    # vitt, float32 on both sides (the scripts' defaults are vitl, bf16);
    # batch 8 divides the JAX mesh over tests/conftest.py's 8 CPU devices.
    # The JAX script replaces its trainer's initial parameters with the
    # checkpoint's, so the JAX init only lays out zeros (its jit would
    # compile for longer than the script runs)
    for mod in (jmodels, tmodels):
        get = mod.get_model
        monkeypatch.setattr(mod, "get_model",
                            lambda name, _g=get, **kw: _g(name, encoder="vitt",
                                                          **kw))
    jget = jmodels.get_model
    monkeypatch.setattr(jmodels, "get_model", lambda name, **kw: _zeros_init(
        jget(name, **kw)))
    for mod in (jtrain, ttrain):
        tcfg = mod.TrainerConfig
        monkeypatch.setattr(mod, "TrainerConfig", lambda _c=tcfg, **kw: _c(
            **{**kw, "compute_dtype": "float32"}))
    args = ["--checkpoint", ckpt, "--base_data_dir", str(root),
            "--filenames", split, "--batch", "8", "--size", "56"]
    jscript.main(args + ["--output_dir", str(tmp_path / "ref")])
    batch_inference.main(args + ["--output_dir", str(tmp_path / "ours"),
                                 "--device", "cpu"])

    def numbers(name):
        text = (tmp_path / name / "metrics.txt").read_text()
        return [float(v) for v in re.findall(r"nan|-?\d+\.\d+", text)]

    ref, ours = numbers("ref"), numbers("ours")
    assert len(ours) == len(ref) > 0
    assert np.isfinite(ref).sum() >= 40
    for a, b in zip(ours, ref):
        if np.isnan(b):   # an empty bucket
            assert np.isnan(a)
        else:
            assert abs(a - b) <= 1e-4 * max(1.0, abs(b))


def test_sam_pl_gen_depthfm_matches_jax(tmp_path, monkeypatch,
                                       record_property):
    """The JAX script's labels against the port's `label_image` handed the
    JAX draws of each image's key (PRNGKey(seed + i)); then the port's
    `main` writes every label. The JAX script reads the VAE at the SD
    topology; the tiny VAE's is patched in."""
    import dataclasses
    import functools

    import amodal_depth_anything_tpu.convert.depthfm_convert as jconv
    from amodal_depth_anything_tpu.scripts import \
        sam_pl_gen_depthfm as jscript

    load = jconv.load_depthfm_ckpt

    def tiny_load(*a, **kw):
        cfg, params = load(*a, **kw)
        return dataclasses.replace(cfg, vae_channels=(16, 32), vae_layers=1,
                                   context_len=7), params

    monkeypatch.setattr(jconv, "load_depthfm_ckpt", tiny_load)
    monkeypatch.setattr(jconv, "convert_sd_vae", functools.partial(
        jconv.convert_sd_vae, n_down_blocks=2, layers_per_block=1))
    from amodal_depth_anything_tpu_torch.scripts import sam_pl_gen_depthfm
    from amodal_depth_anything_tpu_torch.scripts.verify_checkpoints import \
        write_depthfm_artifacts

    ckpt, vae = write_depthfm_artifacts(str(tmp_path))
    rng = np.random.default_rng(2)
    ids = ["11", "12"]
    for sid, sub in zip(ids, (0, 2)):
        Image.fromarray(_scene(rng, 37)).save(
            tmp_path / f"sa_{sid}.jpg", quality=85, subsampling=sub)
    split = tmp_path / "split.txt"
    split.write_text("\n".join(ids) + "\n")
    args = ["--image_dir", str(tmp_path), "--split", str(split),
            "--ckpt", ckpt, "--vae_ckpt", vae, "--size", "32",
            "--ensemble", "2", "--num_steps", "2", "--dtype", "float32"]
    jscript.main(args + ["--out_dir", str(tmp_path / "ref")])

    model = sam_pl_gen_depthfm.load_model(ckpt, vae, dtype=torch.float32,
                                          device="cpu")
    flips = 0
    for i, sid in enumerate(ids):
        # the tiny VAE downsamples by 2: 16 x 16 latents at 32 px
        noise = np.array(jax.random.normal(jax.random.PRNGKey(i),
                                           (2, 16, 16, 4), jnp.float32))
        depth, u16 = sam_pl_gen_depthfm.label_image(
            model, str(tmp_path / f"sa_{sid}.jpg"), torch.from_numpy(noise),
            size=32, num_steps=2, ensemble=2)
        ref = _read(tmp_path / "ref" / f"{sid}_depth.png").astype(np.int64)
        assert depth.min() == 0.0 and abs(depth.max() - 1.0) <= 1e-6
        assert np.abs(u16.astype(np.int64) - ref).max() <= 1
        flips += int((u16 != ref).sum())
    record_property("codes_apart", flips)
    sam_pl_gen_depthfm.main(args + ["--out_dir", str(tmp_path / "ours"),
                                    "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "ours")) == \
        [f"{sid}_depth.png" for sid in ids]


def test_colorize_depth_matches_jax(tmp_path):
    from amodal_depth_anything_tpu.scripts import colorize_depth as jscript
    from amodal_depth_anything_tpu_torch.scripts import colorize_depth

    rng = np.random.default_rng(3)
    _png(str(tmp_path / "in" / "x_depth.png"),
         (rng.random((24, 30)) * 65535).astype(np.uint16))
    jscript.main(["--input", str(tmp_path / "in"),
                  "--out_dir", str(tmp_path / "ref")])
    (out,) = colorize_depth.main(["--input", str(tmp_path / "in"),
                                  "--out_dir", str(tmp_path / "ours")])
    assert np.array_equal(_read(out),
                          _read(tmp_path / "ref" / "x_depth_rendered.png"))


def test_convert_ckp_strip_matches_jax_and_to_orbax_names_jax(tmp_path):
    from amodal_depth_anything_tpu.scripts import convert_ckp as jscript
    from amodal_depth_anything_tpu_torch.scripts import convert_ckp

    sd = {"pretrained.blocks.0.w": torch.arange(3.0),
          "pretrained.cls_token": torch.ones(1, 2),
          "depth_head.w": torch.ones(2)}
    torch.save(sd, tmp_path / "in.pth")
    jscript.main(["strip", "--input", str(tmp_path / "in.pth"),
                  "--output", str(tmp_path / "ref.pth")])
    convert_ckp.main(["strip", "--input", str(tmp_path / "in.pth"),
                      "--output", str(tmp_path / "ours.pth")])
    ref, ours = (torch.load(tmp_path / f"{n}.pth") for n in ("ref", "ours"))
    assert ref.keys() == ours.keys() == {"blocks.0.w", "cls_token"}
    assert all(torch.equal(ref[k], ours[k]) for k in ref)
    with pytest.raises(SystemExit, match="amodal_depth_anything_tpu"):
        convert_ckp.main(["to_orbax", "--input", "x", "--output", "y"])


def test_slurm_util(monkeypatch):
    from amodal_depth_anything_tpu_torch.utils import slurm_util
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    assert not slurm_util.is_on_slurm()
    monkeypatch.setenv("SLURM_JOB_ID", "7")
    monkeypatch.setenv("TMPDIR", "/scratch/x")
    assert slurm_util.is_on_slurm()
    assert slurm_util.get_local_scratch_dir() == "/scratch/x"


def test_verify_checkpoints_rehearse(tmp_path):
    """The port's kit on its own rehearsal: every row PASS (the full chain
    SKIPs under --skip_chain); then the JAX kit's converters read the same
    files."""
    from amodal_depth_anything_tpu.scripts import \
        verify_checkpoints as jkit
    from amodal_depth_anything_tpu_torch.scripts import verify_checkpoints

    rdir = tmp_path / "ckpts"
    rc = verify_checkpoints.main([
        "--rehearse", str(rdir), "--skip_chain", "--size", "126",
        "--gate_max_abs", "1e9", "--device", "cpu",
        "--output", str(tmp_path / "report.txt")])
    rows = [ln.split() for ln in
            (tmp_path / "report.txt").read_text().splitlines()]
    assert rc == 0
    assert len(rows) == 19
    for name, status, *_ in rows:
        assert status == ("SKIP" if name == "full_chain_1e-3" else "PASS"), \
            name
    rc = jkit.main(["--all", str(rdir), "--tiny", "--skip_chain",
                    "--skip_forward", "--output", str(tmp_path / "jax.txt")])
    assert rc == 0
    jrows = {ln.split()[0]: ln.split()[1] for ln in
             (tmp_path / "jax.txt").read_text().splitlines()}
    for name in ("dav2_base", "dav2_amodal", "depthfm", "sam", "pix2gestalt",
                 "rmbg", "invisible_stitch"):
        assert jrows[f"{name}_convert"] == "PASS", name
