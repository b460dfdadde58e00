"""The port's baseline trainers on the CPU against the JAX package's:
`AmodalSynthDriveTrainer` on the small ADDeepLab that tests/test_deeplab.py
builds (the port's tiny preset) and `InvisibleStitchTrainer` on the tiny
InvisibleStitch, on the same weights (noisy JAX init through the bridge)
and the same batches of the synthetic SAM tree at 64 px, f32, plain
attention on both sides.

Checked: the loss of one step and every gradient leaf (the JAX step's loss
restated under `jax.value_and_grad`, as tests/test_torch_trainer.py does),
the BatchNorm running statistics after the step, three steps of the JAX
trainer's own jitted step (loss each step, every parameter and running
statistic after each), and the `_eval_forward` prediction on the trained
weights. Tolerances: loss 1e-5, gradients 1e-4 of each
leaf's max abs, running statistics 1e-5, the eval prediction 1e-4;
parameters 1e-5 after the first step and 2 * lr a step after the next two
(Adam lifts rounding-level gradients to steps of up to lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.ops.resize import \
    resize_nearest as jax_resize_nearest
from amodal_depth_anything_tpu.parallel import MeshConfig, make_mesh
from amodal_depth_anything_tpu.train import \
    AmodalSynthDriveTrainer as JaxSynthDriveTrainer
from amodal_depth_anything_tpu.train import \
    InvisibleStitchTrainer as JaxStitchTrainer
from amodal_depth_anything_tpu.train import TrainerConfig as JaxTrainerConfig
from amodal_depth_anything_tpu.train.trainer import \
    _strategy_loss as jax_strategy_loss
from amodal_depth_anything_tpu.utils.loss import get_loss as jax_get_loss
from amodal_depth_anything_tpu_torch.convert.weights import (
    baseline_params_from_jax, baseline_params_to_jax)
from amodal_depth_anything_tpu_torch.data import (DataLoader, DatasetMode,
                                                  SAMAmodalDataset)
from amodal_depth_anything_tpu_torch.data.synthetic import \
    make_synthetic_sam_tree
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.train import (AmodalSynthDriveTrainer,
                                                   InvisibleStitchTrainer,
                                                   TrainerConfig)
from tests.test_deeplab import tiny_model as jax_tiny_deeplab
from tests.test_torch_baselines import noisy_tree
from tests.test_torch_models import few_torch_threads  # noqa: F401

HW = 64
TRAINERS = {"ADDeepLab": (AmodalSynthDriveTrainer, JaxSynthDriveTrainer),
            "InvisibleStitch": (InvisibleStitchTrainer, JaxStitchTrainer)}


@pytest.fixture(scope="module")
def batches(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sam_baselines"))
    list_path = make_synthetic_sam_tree(root, n=8, hw=HW)
    loader = DataLoader(SAMAmodalDataset(
        mode=DatasetMode.TRAIN, filename_ls_path=list_path, dataset_dir=root,
        resize_to_hw=(HW, HW)), batch_size=2, shuffle=True, drop_last=True)
    loader.set_epoch(0)
    return list(loader)[:3]


def _cfg(name, **kw):
    base = dict(loss_strategy=("invisible_part" if name == "InvisibleStitch"
                               else "entire_target_object"),
                max_iter=3, lr=1e-3, lr_warmup_steps=0, validation_period=0,
                visualization_period=0, save_period=0,
                compute_dtype="float32", remat=False,
                eval_metrics=("abs_relative_difference", "delta1_acc"))
    base.update(kw)
    return base


def _jax_model(name):
    if name == "ADDeepLab":
        return jax_tiny_deeplab()
    return jax_get_model("InvisibleStitch", tiny=True)


def _setup(name):
    """(port trainer, JAX trainer, JAX model, noisy JAX tree) on the same
    weights: the port's seeded init taken across by the bridge, with seeded
    noise on every leaf (a JAX init run op by op compiles every draw)."""
    jmodel = _jax_model(name)
    model = get_model(name, tiny=True, device="cpu")
    model.init_weights_(torch.Generator().manual_seed(0))
    tree = noisy_tree(baseline_params_to_jax(name, model.state_dict(),
                                             model.cfg))
    cls, jcls = TRAINERS[name]
    trainer = cls(TrainerConfig(**_cfg(name, attn_impl="plain")), model,
                  None, device="cpu",
                  params=baseline_params_from_jax(name, tree, model.cfg))
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = jcls(JaxTrainerConfig(**_cfg(name, attn_impl="xla")), jmodel,
                    None, mesh=mesh, params=jax.tree.map(jnp.asarray, tree))
    return trainer, jtrainer, jmodel, tree


def _jax_loss_and_grads(name, jmodel, cfg, tree, batch):
    """The JAX trainers' `loss_of`, restated, under `jax.value_and_grad`;
    returns (loss, gradients, new_bn)."""
    loss_fn = jax_get_loss("silog_loss", beta=0.15)  # the configs' loss
    b = {k: jnp.asarray(v) for k, v in batch.items()
         if isinstance(v, np.ndarray) and v.dtype != object}
    rgb = b["rgb_int"] / 255.0
    gt = b["depth_gt"]
    valid = b["valid_mask_raw"] > 0

    if name == "ADDeepLab":
        def loss_of(params):
            (vis, invis), new_bn = jmodel.apply(
                {"params": params, "bn": tree["bn"]}, rgb,
                guide_mask=b["guide"], train=True, attn_impl="xla")
            vis = jax_resize_nearest(vis, size=gt.shape[1:3])
            invis = jax_resize_nearest(invis, size=gt.shape[1:3])
            amodal = b["guide"] > 0
            loss = 0.7 * loss_fn(invis, gt, valid & amodal) + \
                0.3 * loss_fn(vis, gt, valid & ~amodal)
            return jnp.where(jnp.isfinite(loss), loss, 0.0), new_bn
        with jax.default_matmul_precision("highest"):
            (loss, new_bn), grads = jax.value_and_grad(
                loss_of, has_aux=True)(tree["params"])
        return loss, {"params": grads}, new_bn

    def loss_of(params):
        pred = jmodel.apply(params, rgb, invisible_mask=b["invisible_mask"],
                            observation=b["depth_observation"])
        pred = jax_resize_nearest(pred, size=gt.shape[1:3])
        loss = jax_strategy_loss(loss_fn, cfg["loss_strategy"], pred, gt,
                                 valid, b["guide"] > 0,
                                 b["invisible_mask"] > 0,
                                 b["visible_mask"] > 0)
        return jnp.where(jnp.isfinite(loss), loss, 0.0)
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(loss_of)(tree)
    return loss, grads, None


def _leaves(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def _state_tree(name, trainer):
    return baseline_params_to_jax(name, trainer.model.state_dict(),
                                  trainer.model.cfg)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_one_step_loss_gradients_and_bn_match_jax(name, batches):
    trainer, _, jmodel, tree = _setup(name)
    ref_loss, ref_grads, new_bn = _jax_loss_and_grads(
        name, jmodel, _cfg(name), tree, batches[0])
    loss, grads = trainer.loss_and_grads(trainer._device_batch(batches[0]))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    ours = dict(_leaves(baseline_params_to_jax(name, grads,
                                               trainer.model.cfg)))
    ref = dict(_leaves(ref_grads))
    assert set(ours) == set(ref)
    nonzero = 0
    for key, r in ref.items():
        scale = np.abs(r).max()
        assert np.abs(ours[key] - r).max() <= 1e-4 * scale, key
        nonzero += scale > 0
    assert nonzero > 0.9 * len(ref)
    if new_bn is not None:
        bn = dict(_leaves(_state_tree(name, trainer)["bn"]))
        for key, r in _leaves(jax.device_get(new_bn)):
            np.testing.assert_allclose(bn[key], r, rtol=0, atol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_three_steps_and_eval_match_the_jax_trainer(name, batches):
    trainer, jtrainer, _, tree = _setup(name)
    before = dict(_leaves(tree))
    for step, batch in enumerate(batches):
        with jax.default_matmul_precision("highest"):
            jtrainer.state, ref_loss = jtrainer._train_step(
                jtrainer.state, jtrainer._device_batch(batch))
        loss = trainer._train_step(trainer._device_batch(batch))
        assert abs(float(loss) - float(ref_loss)) <= 1e-5
        ours = dict(_leaves(_state_tree(name, trainer)))
        moved = 0.0
        for key, r in _leaves(jax.device_get(jtrainer.state.params)):
            err = np.abs(ours[key] - r).max()
            # the first step is held to 1e-5; from the second on, Adam's
            # normalised step lifts the rounding-level gradients of near-dead
            # channels to steps of up to lr either way, so parameters are
            # held to 2 * lr a step and the running statistics to 1e-5
            bound = 1e-5 if step == 0 or key.startswith("bn/") \
                else 2 * 1e-3 * (step + 1)
            assert err <= bound, (step, key, err)
            moved = max(moved, np.abs(r - before[key]).max())
        assert moved > 1e-4

    # the raw prediction; the aligned one is the least-squares fit to the
    # observation, whose determinant cancels in float32 for the untrained
    # model's nearly constant prediction (ROADMAP, queue 3, known sources)
    with jax.default_matmul_precision("highest"):
        ref_pred, _ = jtrainer._eval_forward(
            jtrainer.state.params, jtrainer._device_batch(batches[0]))
    pred, aligned = trainer._eval_forward(trainer._device_batch(batches[0]))
    ref_pred = np.asarray(ref_pred)
    assert pred.shape == aligned.shape == ref_pred.shape
    assert np.abs(pred.numpy() - ref_pred).max() <= 1e-4
    assert torch.isfinite(aligned).all()


def test_invisible_stitch_refuses_entire_scene():
    model = get_model("InvisibleStitch", tiny=True, device="cpu")
    with pytest.raises(ValueError, match="entire_scene"):
        InvisibleStitchTrainer(TrainerConfig(**_cfg(
            "InvisibleStitch", loss_strategy="entire_scene")), model, None,
            device="cpu")


def test_w_occ_weights_the_two_heads(batches):
    """w_occ = 1 scores the invisible head alone, 0 the visible one."""
    losses = {}
    for w in (0.0, 0.5, 1.0):
        trainer = AmodalSynthDriveTrainer(
            TrainerConfig(**_cfg("ADDeepLab", attn_impl="plain")),
            get_model("ADDeepLab", tiny=True, device="cpu"), None,
            device="cpu", seed=4, w_occ=w)
        with torch.no_grad():
            losses[w] = float(trainer.loss_of(
                trainer._device_batch(batches[0])))
    assert losses[0.5] == pytest.approx(0.5 * (losses[0.0] + losses[1.0]),
                                        abs=1e-5)
    assert losses[0.0] != losses[1.0]


def test_checkpoint_keeps_the_running_statistics(batches, tmp_path):
    trainer, *_ = _setup("ADDeepLab")
    trainer.out_dir_ckpt = str(tmp_path)
    trainer._train_step(trainer._device_batch(batches[0]))
    trainer.save_checkpoint("latest")
    other, *_ = _setup("ADDeepLab")
    other.load_checkpoint(str(tmp_path / "latest"))
    for key, val in trainer.model.state_dict().items():
        assert torch.equal(val, other.model.state_dict()[key]), key
    assert any("running_var" in k for k in trainer.model.state_dict())

