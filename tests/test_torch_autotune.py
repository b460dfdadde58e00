"""`scripts/autotune_serving.py` of the port against the JAX package's.

The candidate lists are the JAX script's; a tiny random sweep on the CPU
gives a report with the JAX report's keys and rows (the weights differ:
torch's and JAX's generators do, so only the plumbing is compared), its
pick is the fastest row under the budget, and `--image` / `--mask` read a
corpus as PIL's convert("RGB") / convert("L") would."""

import argparse

import numpy as np
import pytest
from PIL import Image

from amodal_depth_anything_tpu.scripts import autotune_serving as jtune
from amodal_depth_anything_tpu_torch.scripts import autotune_serving as tune
from tests.test_torch_models import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("family", ["amodal", "depthfm"])
@pytest.mark.parametrize("calibrated", [False, True])
def test_candidate_configs_are_the_jax_scripts(family, calibrated):
    assert tune.candidate_configs(family, calibrated) == \
        jtune.candidate_configs(family, calibrated)


def test_tome_geometry_is_the_jax_scripts():
    from amodal_depth_anything_tpu.models.amodal_dav2 import \
        DAV2Config as JCfg
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import DAV2Config
    for enc in ("vitt", "vitl", "vitg"):
        for size in (56, 518, 1022):
            for frac, late in ((0.45, True), (0.45, False), (0.01, False)):
                assert tune._tome_cfg(DAV2Config(encoder=enc).vit, size,
                                      frac, late) == \
                    jtune._tome_cfg(JCfg(encoder=enc).vit, size, frac, late)


def test_report_has_the_jax_reports_keys_and_rows():
    argv = ["--random", "--batch", "1", "--reps", "1", "--dtype", "float32",
            "--configs", "bf16,tome_both"]
    ref = jtune.run_autotune(jtune.build_parser().parse_args(argv))
    mine = tune.run_autotune(tune.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert sorted(mine) == sorted(ref)
    assert [r["config"] for r in mine["rows"]] == \
        [r["config"] for r in ref["rows"]]
    for m, r in zip(mine["rows"], ref["rows"]):
        assert sorted(m) == sorted(r)
        assert sorted(m["quality_delta"]) == sorted(r["quality_delta"])
    for key in ("family", "batch", "size", "dtype", "quality_budget",
                "random_weights", "weights"):
        assert mine[key] == ref[key], key
    assert mine["rows"][0]["quality_delta"] == {"max_abs": 0.0,
                                                "mean_abs": 0.0}


def test_sweep_picks_the_fastest_row_under_the_budget(capsys):
    report = tune.main(["--random", "--batch", "2", "--reps", "1",
                        "--dtype", "float32", "--device", "cpu",
                        "--quality_budget", "0.5"])
    assert [r["config"] for r in report["rows"]] == \
        tune.candidate_configs("amodal")
    assert capsys.readouterr().out.strip().endswith("}")
    passing = [r for r in report["rows"] if r["passes_budget"]]
    assert report["best"] == max(passing,
                                 key=lambda r: r["img_per_sec"])["config"]
    for row in report["rows"]:
        assert row["img_per_sec"] > 0 and row["p50_batch_ms"] > 0
        assert np.isfinite(row["quality_delta"]["max_abs"])
        assert row["passes_budget"] == (row["quality_delta"]["max_abs"]
                                        <= 0.5)


def test_flag_checks():
    with pytest.raises(SystemExit, match="unknown configs"):
        tune.run_autotune(tune.build_parser().parse_args(
            ["--random", "--configs", "bf16,nope", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="quality_budget"):
        tune.run_autotune(tune.build_parser().parse_args(
            ["--random", "--quality_budget", "-1", "--device", "cpu"]))
    with pytest.raises(SystemExit, match="divisible by the VAE"):
        tune.run_autotune(tune.build_parser().parse_args(
            ["--random", "--family", "depthfm", "--size", "30",
             "--device", "cpu"]))


def test_image_and_mask_read_as_pil_converts_them(tmp_path):
    rng = np.random.default_rng(0)
    rgba = (rng.random((21, 30, 4)) * 255).astype(np.uint8)
    mask = (rng.random((21, 30, 3)) * 255).astype(np.uint8)
    mask[:5] = 0
    Image.fromarray(rgba).save(tmp_path / "img.png")
    Image.fromarray(mask).save(tmp_path / "mask.png")
    args = argparse.Namespace(batch=3, image=str(tmp_path / "img.png"),
                              mask=str(tmp_path / "mask.png"), seed=0)
    imgs, msks = tune._corpus(args, 56)
    want = np.asarray(Image.open(tmp_path / "img.png").convert("RGB"),
                      np.float32)
    luma = np.asarray(Image.open(tmp_path / "mask.png").convert("L"),
                      np.float32)
    assert imgs.shape == (3, 21, 30, 3) and msks.shape == (3, 21, 30)
    np.testing.assert_array_equal(imgs[2], want)
    np.testing.assert_array_equal(msks[1], (luma > 0).astype(np.float32))
    np.testing.assert_array_equal(tune._luma(mask), luma)
