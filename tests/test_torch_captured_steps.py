"""The train step as one program over static buffers, on the CPU.

On the card `DiscriminativeTrainer` (and every trainer built on it) captures
its step as a CUDA graph over static batch and draw buffers, with the
optimizer's device scalars (`train/state.py`) updated in place. On the CPU
`captured=True` runs that same static-buffer program without a graph. Held
here, at tiny presets in float32: that program against the eager step,
bit for bit, over two steps (losses, every parameter and buffer, the
optimizer state and the device scalars) for the discriminative trainer
(remat True under two-step accumulation), ADDeepLab
(BatchNorm statistics updated in place), DepthFMAmodal and the DDPM
finetune (draws made before the step, copied into static buffers), and a
save -> load -> continue under it, bit for bit; the device scalars and
tables against the host formulas. The eager step's parity with the JAX
trainer is held by `tests/test_torch_trainer.py`,
`test_torch_depthfm_trainer.py` and `test_torch_baseline_trainers.py`."""

import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu_torch.data import DataLoader
from amodal_depth_anything_tpu_torch.models import get_model
from amodal_depth_anything_tpu_torch.train import (AmodalSynthDriveTrainer,
                                                   DepthFMAmodalTrainer,
                                                   DepthFMTrainer,
                                                   DiscriminativeTrainer,
                                                   TrainerConfig,
                                                   make_optimizer)
from tests.test_torch_models import few_torch_threads  # noqa: F401

HW, STEPS = 32, 2


class _Scenes:
    """Seeded in-memory scenes with the keys the trainers read."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.samples = []
        for i in range(n):
            guide = (rng.random((HW, HW, 1)) > 0.4).astype(np.float32)
            visible = guide * (rng.random((HW, HW, 1)) > 0.5)
            rgb = (rng.random((HW, HW, 3)) * 255).round().astype(np.float32)
            self.samples.append({
                "rgb_int": rgb, "rgb_norm": rgb / 127.5 - 1.0,
                "guide_rgb_norm": rgb[::-1].copy() / 127.5 - 1.0,
                "guide": guide, "visible_mask": visible,
                "invisible_mask": guide - visible,
                "depth_observation": rng.random((HW, HW, 1)).astype(
                    np.float32),
                "depth_gt": rng.random((HW, HW, 1)).astype(np.float32) + .1,
                "valid_mask_raw": np.ones((HW, HW, 1), bool), "index": i})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _cfg(**kw):
    base = dict(max_iter=STEPS, validation_period=0, visualization_period=0,
                save_period=0, log_interval=1, compute_dtype="float32",
                lr_warmup_steps=1, lr=1e-3, attn_impl=None)
    base.update(kw)
    return TrainerConfig(**base)


CASES = {
    "vitt-remat-accumulate": lambda c: DiscriminativeTrainer(
        _cfg(remat=True, accumulation_steps=2),
        get_model("AmodalDAv2", encoder="vitt", device="cpu"), None,
        device="cpu", seed=1, captured=c),
    "addeeplab-batchnorm": lambda c: AmodalSynthDriveTrainer(
        _cfg(), get_model("ADDeepLab", tiny=True, device="cpu"), None,
        device="cpu", seed=1, captured=c),
    "depthfm-flow": lambda c: DepthFMAmodalTrainer(
        _cfg(loss_name="l1_loss", loss_kwargs={}),
        get_model("DepthFMAmodal", tiny=True, device="cpu"), None,
        device="cpu", seed=1, captured=c),
    "ddpm-pyramid-noise": lambda c: DepthFMTrainer(
        _cfg(loss_name="mse_loss", loss_kwargs={},
             loss_strategy="entire_scene"),
        get_model("DepthFM", tiny=True, device="cpu"), None, device="cpu",
        seed=1, captured=c,
        multi_res_noise={"strength": 0.9, "annealed": True}),
}


def _batches(trainer, n=STEPS):
    loader = DataLoader(_Scenes(2 * n), batch_size=2, shuffle=True,
                        drop_last=True, seed=0)
    loader.set_epoch(0)
    return [trainer._device_batch(b) for b in loader][:n]


def _state(trainer):
    out = [v.clone() for v in trainer.model.state_dict().values()]
    for key in sorted(trainer.state.opt_state):
        v = trainer.state.opt_state[key]
        out += [x.clone() for x in v] if isinstance(v, list) else [v]
    return out + [v.clone() for v in trainer._scalars.values()]


def _equal(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("case", list(CASES))
def test_static_buffer_step_equals_the_eager_step(case, tmp_path):
    eager, static = CASES[case](False), CASES[case](True)
    assert not eager.captured and static.captured
    batches = _batches(eager)
    losses = []
    for i, b in enumerate(batches):
        if i == 1:   # the eager run's checkpoint after one step
            eager.out_dir_ckpt = str(tmp_path)
            eager.save_checkpoint("one")
        losses.append(float(eager._train_step(b)))
    assert [float(static._train_step(b)) for b in batches] == losses
    assert np.isfinite(losses).all()
    assert _equal(_state(eager), _state(static))
    # load -> the rest under the static program, against the unbroken run
    resumed = CASES[case](True)
    resumed.load_checkpoint(str(tmp_path / "one"))
    assert resumed.state.step == 1
    assert [float(resumed._train_step(b)) for b in batches[1:]] == losses[1:]
    assert _equal(_state(resumed), _state(static))


def test_device_scalars_follow_the_host_formulas():
    """The optimizer's tables hold the schedule and optax's float32 bias
    corrections at every count, constant past the end; `step_` reads them
    at the device count and advances it, `advance` the host integers."""
    tx = make_optimizer(lr=1e-3, total_iter=7, warmup_steps=2,
                        accumulation_steps=2)
    table = tx.tables("cpu")
    n = table.shape[1]
    for i in (0, 1, 2, 5, 7, n - 1):
        assert table[0, i].item() == np.float32(tx.schedule(i))
        for row, b in ((1, 0.9), (2, 0.999)):
            assert table[row, i].item() == np.float32(1.0) - np.float32(
                b) ** np.float32(i)
    assert table[0, -1].item() == np.float32(tx.schedule(10 ** 6))
    assert table[1:, -1].tolist() == [1.0, 1.0]
    p = [torch.zeros(3)]
    state = tx.init(p)
    scalars = tx.scalars(state, "cpu")
    moved = [tx.update(p, [torch.ones(3)], state, scalars) for _ in range(4)]
    assert moved == [False, True, False, True]
    assert state["count"] == 2 and state["mini_step"] == 0
    assert scalars["count"].item() == 2 and scalars["mini_step"].item() == 0
