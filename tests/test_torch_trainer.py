"""The port's discriminative trainer on the CPU: one train step against the
JAX package's on the same parameters (through the weight bridge, both ways)
and the same batch, the three `remat` modes against each other, and the
port's counterparts of the JAX trainer tests (finite training, validation
and checkpoint round trip, bitwise resume, the train CLI).

vitt AmodalDAv2 at 56 px on the synthetic SAM tree, f32, plain attention on
both sides. Tolerances: loss 1e-5; every gradient leaf 1e-4 of its max abs
(sums in another order); every parameter 1e-5 after three steps."""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.models import get_model as jax_get_model
from amodal_depth_anything_tpu.parallel import MeshConfig, make_mesh
from amodal_depth_anything_tpu.train import \
    DiscriminativeTrainer as JaxTrainer
from amodal_depth_anything_tpu.train import TrainerConfig as JaxTrainerConfig
from amodal_depth_anything_tpu.train.trainer import \
    _strategy_loss as jax_strategy_loss
from amodal_depth_anything_tpu.utils.loss import get_loss as jax_get_loss
from amodal_depth_anything_tpu_torch.convert.weights import (params_from_jax,
                                                             params_to_jax)
from amodal_depth_anything_tpu_torch.data import (DataLoader, DatasetMode,
                                                  SAMAmodalDataset)
from amodal_depth_anything_tpu_torch.data.synthetic import \
    make_synthetic_sam_tree
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.train import (DiscriminativeTrainer,
                                                   TrainerConfig,
                                                   get_trainer_cls)
from amodal_depth_anything_tpu_torch.train.trainer import (LOSS_STRATEGIES,
                                                           _strategy_loss)
from amodal_depth_anything_tpu_torch.utils.loss import get_loss
from tests.test_torch_models import few_torch_threads  # noqa: F401

HW = 56


@pytest.fixture(scope="module")
def sam_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sam_train_torch")
    list_path = make_synthetic_sam_tree(str(root), n=16, hw=HW)
    return str(root), list_path


def _loaders(root, list_path, batch=2):
    kw = dict(filename_ls_path=list_path, dataset_dir=root,
              resize_to_hw=(HW, HW))
    return (DataLoader(SAMAmodalDataset(mode=DatasetMode.TRAIN, **kw),
                       batch_size=batch, shuffle=True, drop_last=True),
            DataLoader(SAMAmodalDataset(mode=DatasetMode.EVAL, **kw),
                       batch_size=batch, pad_last=True))


def _cfg(**kw):
    base = dict(loss_strategy="entire_target_object", max_iter=2,
                validation_period=0, visualization_period=0, save_period=0,
                log_interval=1, compute_dtype="float32", remat=False,
                attn_impl="plain", eval_metrics=("abs_relative_difference",
                                                 "delta1_acc"))
    base.update(kw)
    return TrainerConfig(**base)


def _trainer(cfg, train_loader, **kw):
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    return DiscriminativeTrainer(cfg, model, train_loader, device="cpu", **kw)


def _batches(sam_tree, n):
    train_loader, _ = _loaders(*sam_tree)
    train_loader.set_epoch(0)
    out = []
    for batch in train_loader:
        out.append(batch)
        if len(out) == n:
            return out
    raise AssertionError("the synthetic tree is too small")


def _noisy_jax_params(jmodel, seed=0):
    """Seeded weights of `jmodel`'s configuration in the JAX layout with
    seeded noise on every leaf, so that biases, layer scales and the
    guidance embed carry gradients: the port's seeded init taken across by
    the bridge (a JAX init run op by op compiles every draw)."""
    from amodal_depth_anything_tpu_torch.models.amodal_dav2 import (
        DAV2Config, build_model, init_weights_)
    cfg = DAV2Config(**dataclasses.asdict(jmodel.config))
    model = init_weights_(build_model(cfg, device="cpu"),
                          torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params_to_jax(model.state_dict(), cfg))


def _jax_loss_and_grads(jmodel, cfg, params, batch):
    """The JAX train step's `loss_of`, under `jax.value_and_grad`."""
    loss_fn = jax_get_loss(cfg.loss_name, **cfg.loss_kwargs)
    b = {k: jnp.asarray(v) for k, v in batch.items()
         if isinstance(v, np.ndarray) and v.dtype != object}

    def loss_of(p):
        pred = jmodel.apply(
            p, b["rgb_int"] / 255.0, guide_rgb=b["guide_rgb_norm"],
            guide_mask=b["guide"] * 2.0 - 1.0,
            observation=b["depth_observation"] * 2.0 - 1.0,
            attn_impl="xla").astype(jnp.float32)
        loss = jax_strategy_loss(
            loss_fn, cfg.loss_strategy, pred, b[cfg.gt_depth_type],
            b[cfg.gt_mask_type] > 0, b["guide"] > 0,
            b["invisible_mask"] > 0, b["visible_mask"] > 0)
        return jnp.where(jnp.isfinite(loss), loss, 0.0)

    with jax.default_matmul_precision("highest"):
        return jax.value_and_grad(loss_of)(params)


def _leaves(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(val)


@pytest.mark.parametrize("strategy", LOSS_STRATEGIES)
def test_strategy_loss_and_its_gradient_match_jax(strategy):
    """Each of the five loss strategies on one seeded prediction, value and
    gradient, <= 1e-6 (relative to the value where it exceeds 1). The ssi
    strategies solve a 2x2 system whose determinant cancels in float32 when
    the prediction is nearly constant, as an untrained model's is; here it
    varies, so the fit is well conditioned and the two packages can be held
    to rounding."""
    rng = np.random.default_rng(5)
    shape = (2, 24, 20, 1)
    pred, gt = (rng.random(shape, dtype=np.float32) * 0.9 + 0.05
                for _ in range(2))
    valid, guide, visible = (rng.random(shape) > t for t in (0.1, 0.4, 0.5))
    visible &= guide
    invisible = guide & ~visible
    masks = (valid, guide, invisible, visible)
    ref, ref_grad = jax.value_and_grad(lambda p: jax_strategy_loss(
        jax_get_loss("silog_loss", beta=0.15), strategy, p, jnp.asarray(gt),
        *map(jnp.asarray, masks)))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    ours = _strategy_loss(get_loss("silog_loss", beta=0.15), strategy, tp,
                          torch.from_numpy(gt), *map(torch.from_numpy, masks))
    ours.backward()
    ref, ref_grad = float(ref), np.asarray(ref_grad)
    assert abs(ours.item() - ref) <= 1e-6 * max(1.0, abs(ref))
    assert np.abs(tp.grad.numpy() - ref_grad).max() <= \
        1e-6 * max(1.0, np.abs(ref_grad).max())


def test_train_step_matches_jax(sam_tree):
    """Loss and every gradient leaf of one step, then every parameter after
    three steps (clip, Adam and the schedule included), port vs JAX, under
    the shipped recipe's strategy."""
    kw = dict(loss_strategy="entire_target_object", lr=1e-3,
              lr_total_iter=100, lr_warmup_steps=1, max_iter=3)
    cfg = _cfg(**kw)
    jcfg = JaxTrainerConfig(**{**dataclasses.asdict(cfg), "attn_impl": "xla"})
    batches = _batches(sam_tree, 3)
    jmodel = jax_get_model("AmodalDAv2", encoder="vitt")
    jparams = _noisy_jax_params(jmodel)
    model = get_model("AmodalDAv2", encoder="vitt", device="cpu")
    trainer = DiscriminativeTrainer(
        cfg, model, None, device="cpu",
        params=params_from_jax(jparams, model.cfg))

    ref_loss, ref_grads = _jax_loss_and_grads(jmodel, jcfg, jparams,
                                              batches[0])
    loss, grads = trainer.loss_and_grads(trainer._device_batch(batches[0]))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5
    ours = dict(_leaves(params_to_jax(grads, model.cfg)))
    ref = dict(_leaves(ref_grads))
    assert set(ours) == set(ref)
    unused = set()
    for name, r in ref.items():
        scale = np.abs(r).max()
        err = np.abs(ours[name] - r).max()
        assert err <= 1e-4 * scale, (name, err, scale)
        if scale == 0:
            unused.add(name)
    # no path reaches the mask token or the deepest fusion block's first
    # residual unit (it fuses one input only)
    assert all(name == "backbone/mask_token" or "refinenet4/resConfUnit1"
               in name for name in unused), unused

    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jcfg, jmodel, None, mesh=mesh,
                          params=jax.tree.map(jnp.asarray, jparams))
    with jax.default_matmul_precision("highest"):
        for batch in batches:
            jtrainer.state, ref_loss = jtrainer._train_step(
                jtrainer.state, jtrainer._device_batch(batch))
            loss = trainer._train_step(trainer._device_batch(batch))
            assert abs(float(loss) - float(ref_loss)) <= 1e-5
    assert trainer.state.step == 3 and trainer.state.opt_state["count"] == 3
    ours = dict(_leaves(params_to_jax(trainer.state.params, model.cfg)))
    before = dict(_leaves(jparams))
    moved = 0.0
    for name, r in _leaves(jax.device_get(jtrainer.state.params)):
        assert np.abs(ours[name] - r).max() <= 1e-5, name
        moved = max(moved, np.abs(r - before[name]).max())
    assert moved > 1e-4   # two updates at lr ~1e-3: the steps did move them


def test_remat_modes_give_identical_loss_and_gradients(sam_tree):
    """`remat` only trades memory for recompute: False, True and "attn"
    (through the kernel dispatch, so that "attn" keeps its residuals) give
    the same loss and the same gradients."""
    batch = _batches(sam_tree, 1)[0]
    results = {}
    for remat in (False, True, "attn"):
        trainer = _trainer(_cfg(remat=remat, attn_impl=None), None, seed=3)
        loss, grads = trainer.loss_and_grads(trainer._device_batch(batch))
        results[remat] = (loss, grads)
    base_loss, base_grads = results[False]
    assert any(g.abs().max() > 0 for g in base_grads.values())
    for remat in (True, "attn"):
        loss, grads = results[remat]
        assert torch.equal(loss, base_loss), remat
        for name, g in grads.items():
            assert torch.equal(g, base_grads[name]), (remat, name)


def test_remat_attn_runs_one_attention_forward_per_block(sam_tree,
                                                         monkeypatch):
    """`remat="attn"` keeps the attention output and LSE: the backward's
    recompute of each block never runs the attention forward again; full
    recompute runs it twice per block."""
    from amodal_depth_anything_tpu_torch.ops import flash_attention as fa
    forwards = []
    plain = fa.mha_reference
    monkeypatch.setattr(fa, "mha_reference", lambda *a, **kw:
                        forwards.append(1) or plain(*a, **kw))
    batch = _batches(sam_tree, 1)[0]
    counts = {}
    for remat in (False, True, "attn"):
        trainer = _trainer(_cfg(remat=remat, attn_impl=None), None, seed=3)
        forwards.clear()
        trainer.loss_and_grads(trainer._device_batch(batch))
        counts[remat] = len(forwards)
    depth = 4   # vitt
    assert counts == {False: depth, True: 2 * depth, "attn": depth}


@pytest.mark.parametrize("strategy", ["entire_target_object",
                                      "ssi invisible_part"])
def test_train_steps_reduce_finite_loss(sam_tree, strategy):
    train_loader, _ = _loaders(*sam_tree)
    trainer = _trainer(_cfg(loss_strategy=strategy), train_loader)
    before = trainer.state.params["encoder.pretrained.cls_token"].clone()
    trainer.train()
    assert trainer.effective_iter == 2
    after = trainer.state.params["encoder.pretrained.cls_token"]
    assert torch.isfinite(after).all()
    assert not torch.equal(after, before)


def test_gradient_accumulation_moves_once_per_effective_step(sam_tree):
    train_loader, _ = _loaders(*sam_tree)
    trainer = _trainer(_cfg(accumulation_steps=2, lr_warmup_steps=0),
                       train_loader)
    trainer.train()
    assert trainer.effective_iter == 2 and trainer.state.step == 4
    assert trainer.state.opt_state["count"] == 2


def test_validation_and_checkpoint_roundtrip(sam_tree, tmp_path):
    train_loader, val_loader = _loaders(*sam_tree)
    trainer = _trainer(_cfg(max_iter=1), train_loader,
                       val_loaders=[val_loader],
                       out_dir_ckpt=str(tmp_path / "ckpt"))
    trainer.train()
    results = trainer.validate()
    bank = results[list(results)[0]]
    assert np.isfinite(bank["align_overall"]["abs_relative_difference"])
    assert 0.0 <= bank["overall"]["delta1_acc"] <= 1.0

    trainer.save_checkpoint("latest")
    # a fresh trainer restores step, optimizer state and parameters exactly
    trainer2 = _trainer(_cfg(max_iter=1), train_loader, seed=1,
                        out_dir_ckpt=str(tmp_path / "ckpt"))
    trainer2.load_checkpoint(str(tmp_path / "ckpt" / "latest"))
    assert trainer2.effective_iter == trainer.effective_iter
    assert trainer2.state.step == trainer.state.step
    for name, p in trainer.state.params.items():
        assert torch.equal(trainer2.state.params[name], p), name
    for a, b in zip(trainer2.state.opt_state["mu"],
                    trainer.state.opt_state["mu"]):
        assert torch.equal(a, b)


def test_exact_resume_bitwise(sam_tree, tmp_path):
    """A restored run reproduces the interrupted run's losses bit for bit:
    the data layer's randomness is index-seeded, the checkpoint restores
    parameters and optimizer state exactly, and the step is deterministic."""
    def run(n_iter, resume_from=None):
        train_loader, _ = _loaders(*sam_tree)
        trainer = _trainer(_cfg(max_iter=n_iter, save_period=2),
                           train_loader, out_dir_ckpt=str(tmp_path / "ckpt"))
        if resume_from:
            trainer.load_checkpoint(resume_from)
        losses = []
        orig = trainer._train_step

        def recording_step(batch):
            loss = orig(batch)
            losses.append(float(loss))
            return loss

        trainer._train_step = recording_step
        trainer.train()
        return losses, trainer

    losses_full, t1 = run(5)
    assert len(losses_full) == 5
    losses_resumed, t2 = run(5, resume_from=str(tmp_path / "ckpt" /
                                                "iter_000002"))
    assert t2.effective_iter == 5
    np.testing.assert_array_equal(np.float64(losses_resumed),
                                  np.float64(losses_full[2:]))
    for name, p in t1.state.params.items():
        assert torch.equal(t2.state.params[name], p), name


def test_step_timer_and_profiler_wiring(sam_tree, tmp_path):
    train_loader, _ = _loaders(*sam_tree)
    prof_dir = str(tmp_path / "profile")
    trainer = _trainer(_cfg(max_iter=2, profile_dir=prof_dir, profile_start=1,
                            profile_steps=1), train_loader)
    trainer.train()
    assert trainer._trace is None and trainer._micro_step_count == 2
    assert os.path.isdir(prof_dir) and os.listdir(prof_dir), \
        "profiler trace not written"


@pytest.fixture
def restore_logging():
    """The CLI configures the root logger (a stream handler on the captured
    stderr, a file handler in the run dir); put it back afterwards."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.handlers[:] = handlers
    root.setLevel(level)


def test_train_cli_smoke(sam_tree, tmp_path, restore_logging):
    from amodal_depth_anything_tpu_torch.cli import train as train_cli

    root, _ = sam_tree
    cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs",
                            "smoke_synthetic_vitt.yaml")
    out = tmp_path / "out"
    train_cli.main(["--config", cfg_path, "--base_data_dir", root,
                    "--output_dir", str(out), "--no_wandb",
                    "--device", "cpu"])
    runs = list((out / "smoke_synthetic_vitt").iterdir())
    assert runs, "run dir created"
    assert (runs[0] / "config.yaml").exists()
    latest = runs[0] / "checkpoint" / "latest"
    assert (latest / "state.pt").exists()
    # --resume_run restores and trains on to the new --max_iter
    train_cli.main(["--config", cfg_path, "--base_data_dir", root,
                    "--output_dir", str(tmp_path / "out2"), "--no_wandb",
                    "--device", "cpu", "--max_iter", "4",
                    "--resume_run", str(latest)])
    runs2 = list((tmp_path / "out2" / "smoke_synthetic_vitt").iterdir())
    state = torch.load(runs2[0] / "checkpoint" / "latest" / "state.pt",
                       weights_only=True)
    assert state["meta"]["effective_iter"] == 4 and state["step"] == 4


def test_train_cli_rejects_a_model_mesh(sam_tree, tmp_path):
    """One process holds no model axis: `--mesh_model 2` asks for a mesh
    of two ranks and the CLI stops before reading anything, with the JAX
    mesh's error. (On two ranks it trains:
    tests/test_torch_parallel_ranks.py.)"""
    from amodal_depth_anything_tpu_torch.cli import train as train_cli

    with pytest.raises(ValueError, match="mesh 0x2x1 != 1 available"):
        train_cli.main(["--config", "unused.yaml", "--base_data_dir",
                        sam_tree[0], "--output_dir", str(tmp_path),
                        "--no_wandb", "--device", "cpu", "--mesh_model", "2"])


@pytest.mark.parametrize("field,value", [
    ("fsdp", True), ("sequence_parallel", True)])
def test_deferred_trainer_config_fields_raise(sam_tree, field, value):
    """`fsdp` and `sequence_parallel` are ported (they raised
    NotImplementedError before the scale-out slice, hence the name). In
    one process, on a 1 x 1 mesh, they shard nothing: a step's loss and
    gradients equal the default trainer's bit for bit. Their effect over
    ranks: tests/test_torch_parallel_ranks.py."""
    batch = _batches(sam_tree, 1)[0]
    results = []
    for kw in ({}, {field: value}):
        trainer = _trainer(_cfg(**kw), None, seed=4)
        results.append(trainer.loss_and_grads(trainer._device_batch(batch)))
    (loss0, grads0), (loss1, grads1) = results
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)


def test_unknown_and_unported_trainers():
    from amodal_depth_anything_tpu_torch.train import (
        AmodalSynthDriveTrainer, DepthFMAmodalTrainer, DepthFMTrainer,
        InvisibleStitchTrainer)
    assert get_trainer_cls("DiscriminativeTrainer") is DiscriminativeTrainer
    assert get_trainer_cls("DepthFMAmodalTrainer") is DepthFMAmodalTrainer
    assert get_trainer_cls("DepthFMTrainer") is DepthFMTrainer
    # every trainer of the JAX package is ported
    assert get_trainer_cls("InvisibleStitchTrainer") is InvisibleStitchTrainer
    assert get_trainer_cls("AmodalSynthDriveTrainer") is \
        AmodalSynthDriveTrainer
    with pytest.raises(ValueError, match="unknown trainer"):
        get_trainer_cls("nope")
    with pytest.raises(ValueError, match="unknown loss strategy"):
        _trainer(_cfg(loss_strategy="nope"), None)
