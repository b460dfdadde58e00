"""The port's evaluation on the CPU: the counterpart of
tests/test_eval_cli.py (port `cli.train` on `smoke_synthetic_vitt.yaml`,
then port `cli.eval` on its checkpoint writes an `eval.txt` with the metric
tables), the same weights (noisy JAX init through the bridge) scored by the
JAX and the port `validate_single_dataset` on the same synthetic split,
bucket by bucket, within 1e-4 relative (float32 metric sums in another
order; the aligned bank goes through the float32 least-squares fit, well
conditioned for these noisy weights), and each baseline config
(`configs/{deeplab,jo_baseline,invisible_stitch}.yaml`, unchanged under an
overlay that only asks for the tiny model, a 64 px split and one step)
through both CLIs. The eval CLI's loader on an `.npz` of the JAX tree and
its refusal of a directory it cannot read."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amodal_depth_anything_tpu.data import DataLoader as JaxDataLoader
from amodal_depth_anything_tpu.data import DatasetMode as JaxDatasetMode
from amodal_depth_anything_tpu.data import \
    SAMAmodalDataset as JaxSAMAmodalDataset
from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.parallel import MeshConfig, make_mesh
from amodal_depth_anything_tpu.train import \
    DiscriminativeTrainer as JaxTrainer
from amodal_depth_anything_tpu.train import TrainerConfig as JaxTrainerConfig
from amodal_depth_anything_tpu_torch.cli import eval as eval_cli
from amodal_depth_anything_tpu_torch.cli import train as train_cli
from amodal_depth_anything_tpu_torch.convert.weights import params_from_jax
from amodal_depth_anything_tpu_torch.data import (DataLoader, DatasetMode,
                                                  SAMAmodalDataset)
from amodal_depth_anything_tpu_torch.data.synthetic import \
    make_synthetic_sam_tree
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.train import (DiscriminativeTrainer,
                                                   TrainerConfig)
from tests.test_torch_models import few_torch_threads  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "configs")


@pytest.fixture
def restore_logging():
    """The CLIs configure the root logger; put it back afterwards."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def sam_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sam_eval_torch")
    make_synthetic_sam_tree(str(root), n=16, hw=56)
    return str(root)


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


def test_eval_cli_smoke(sam_tree, tmp_path, restore_logging):
    cfg_path = os.path.join(CONFIGS, "smoke_synthetic_vitt.yaml")
    train_cli.main(["--config", cfg_path, "--base_data_dir", sam_tree,
                    "--output_dir", str(tmp_path / "out"), "--no_wandb",
                    "--device", "cpu"])
    runs = sorted((tmp_path / "out" / "smoke_synthetic_vitt").iterdir())
    ckpt = runs[-1] / "checkpoint" / "latest"
    assert ckpt.exists()
    eval_cli.main(["--config", cfg_path, "--trained_checkpoint", str(ckpt),
                   "--base_data_dir", sam_tree, "--output_dir",
                   str(tmp_path / "eval"), "--device", "cpu"])
    text = (tmp_path / "eval" / "evaluation" / "eval.txt").read_text()
    assert "abs_relative_difference" in text and "align_overall" in text
    assert "sam_synth_val/align_easy" in text


def test_validate_single_dataset_matches_jax(sam_tree):
    rng = np.random.default_rng(0)
    jmodel = jax_get_model("AmodalDAv2", encoder="vitt")
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), _port_seeded_tree(jmodel.config))
    kw = dict(filename_ls_path=os.path.join(sam_tree, "train.txt"),
              dataset_dir=sam_tree, resize_to_hw=(56, 56))
    common = dict(validation_period=0, visualization_period=0, save_period=0,
                  compute_dtype="float32", remat=False)
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(JaxTrainerConfig(attn_impl="xla", **common),
                          jmodel, None, mesh=mesh,
                          params=jax.tree.map(jnp.asarray, params))
    with jax.default_matmul_precision("highest"):
        ref = jtrainer.validate_single_dataset(JaxDataLoader(
            JaxSAMAmodalDataset(mode=JaxDatasetMode.EVAL, **kw),
            batch_size=3, pad_last=True))
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    trainer = DiscriminativeTrainer(
        TrainerConfig(attn_impl="plain", **common), model, None,
        device="cpu", params=params_from_jax(params, model.cfg))
    ours = trainer.validate_single_dataset(DataLoader(
        SAMAmodalDataset(mode=DatasetMode.EVAL, **kw), batch_size=3,
        pad_last=True))
    assert ours.keys() == ref.keys()
    for bucket, metrics in ref.items():
        assert ours[bucket].keys() == metrics.keys(), bucket
        for name, val in metrics.items():
            got = ours[bucket][name]
            assert (np.isnan(val) and np.isnan(got)) or \
                abs(got - val) <= 1e-4 * max(1.0, abs(val)), (bucket, name)
    assert np.isfinite(ref["align_overall"]["abs_relative_difference"])


def test_eval_loader_reads_an_npz_of_the_jax_tree(tmp_path):
    rng = np.random.default_rng(1)
    jmodel = jax_get_model("AmodalDAv2", encoder="vitt")
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                flat[prefix + key] = (np.asarray(val) + rng.standard_normal(
                    np.shape(val))).astype(np.float32)
    walk(_port_seeded_tree(jmodel.config), "")
    np.savez(tmp_path / "tree.npz", **flat)
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    sd = eval_cli.load_state_any(str(tmp_path / "tree.npz"), model,
                                 "AmodalDAv2")
    model.load_state_dict(sd, strict=True)
    with pytest.raises(SystemExit, match="emit_torch"):
        eval_cli.load_state_any(str(tmp_path), model, "AmodalDAv2")


@pytest.mark.parametrize("config", ["deeplab", "jo_baseline",
                                    "invisible_stitch"])
def test_baseline_configs_train_and_evaluate_through_the_cli(
        config, tmp_path, restore_logging):
    root = tmp_path / "data"
    root.mkdir()
    make_synthetic_sam_tree(str(root), n=4, hw=64)
    overlay = tmp_path / f"{config}_tiny.yaml"
    split = "{name: sam, disp_name: %s, filenames: train.txt, " \
            "resize_to_hw: [64, 64]}"
    overlay.write_text(
        f"base_config:\n- {os.path.join(CONFIGS, config + '.yaml')}\n"
        "model:\n  kwargs:\n    tiny: true\n"
        "dataset:\n"
        f"  train: {split % 'synth'}\n"
        f"  val: {split % 'synth_val'}\n"
        f"  vis: {split % 'synth_vis'}\n"
        "dataloader: {num_workers: 0, effective_batch_size: 2, "
        "max_train_batch_size: 2, seed: 0}\n"
        "max_iter: 1\ncompute_dtype: float32\n"
        "trainer: {save_period: 0, validation_period: 0, "
        "visualization_period: 0}\n")
    train_cli.main(["--config", str(overlay), "--base_data_dir", str(root),
                    "--output_dir", str(tmp_path / "out"), "--no_wandb",
                    "--device", "cpu"])
    runs = sorted((tmp_path / "out" / overlay.stem).iterdir())
    ckpt = runs[-1] / "checkpoint" / "latest"
    eval_cli.main(["--config", str(overlay), "--trained_checkpoint",
                   str(ckpt), "--base_data_dir", str(root), "--output_dir",
                   str(tmp_path / "eval"), "--device", "cpu"])
    text = (tmp_path / "eval" / "evaluation" / "eval.txt").read_text()
    assert "synth_val/align_overall" in text
