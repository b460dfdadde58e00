"""Discriminative trainer: one eager train step, torch.save checkpoints.

Port of the JAX package's `train/trainer.py`, its re-design of the reference
trainer (`src/trainer/discriminative_trainer.py:36-770`):

  * The train step -- forward that keeps the attention LSE, loss-strategy
    masking, SSI alignment, backward through the hand-written attention
    kernels, NaN guard, global-norm clip, Adam update -- stays on the
    device. The reference's ssi strategies round-trip predictions to CPU
    numpy inside the step (:235-241); here the least-squares fit is a
    closed-form on-device solve (`utils.alignment.fit_scale_shift`).
  * Precision: float32 master weights and Adam state; with
    `compute_dtype="bfloat16"` the inputs are cast and every module casts
    its weights at use, LayerNorm runs in float32, and the prediction is
    cast back to float32 before the loss.
  * Order in the step: non-finite loss -> 0; non-finite gradient entries
    -> 0; the mean over `accumulation_steps` micro-batches; the clip (on
    the averaged gradient); Adam; `params += update` (`train/state.py`).
  * The JAX trainer's single-device memory knobs: the optimizer ("adam",
    "adam-bf16mu", "adafactor", `train/state.py`) and `head_tile`, the DPT
    head run over batch chunks with each chunk's forward recomputed in the
    backward (`models/dpt.py`; a model whose forward has no
    `head_batch_tile` raises ValueError, as in the JAX trainer).
  * Scale-out over `mesh` (`parallel.make_mesh`; default every rank of the
    process group on ``data``, a 1 x 1 mesh without one). Each data rank
    takes its rows of the global batch the loader yields (every rank's
    loader reads the same index-seeded batch, so resume is exact on any
    mesh). The loss is the global batch's: its sums and counts, and batch
    norms' statistics, are summed over the data ranks before the division
    (`parallel.comm.data_reduction`), so a step on D ranks of B / D rows
    equals one step on B rows; each rank differentiates loss / D and the
    gradients are summed over ``data``. A ``model`` axis > 1 runs the trunk
    tensor-parallel, and with `sequence_parallel` its token stream split
    between the matmuls (the block norms' and biases' gradients then summed
    over ``model``). `fsdp`: parameters and optimizer state in 1/data
    pieces, gathered at use, gradients reduce-scattered
    (`parallel.sharding`). Checkpoints hold the full tensors whatever the
    mesh; rank 0 writes them and every rank meets at a barrier.
  * One program per step. On the card the step -- forward, backward, the
    guarded gradients, the clip, Adam and the float32-master update -- is
    captured as one CUDA graph (`_StepPrograms`), as the JAX trainer jits it
    whole: the batch and the step's random draws are copied into static
    buffers, the parameters, the optimizer state and the step's device
    scalars (`train/state.py`) are updated in place, and a replay launches
    the whole step. One graph per batch signature and per kind of
    micro-step (accumulate only, or accumulate and apply), at most
    `MAX_STEP_PROGRAMS` kept, as `jit` retraces for a new shape. The eager
    step runs the same device program op by op (`captured=False`, and the
    default on the CPU), so the two are bitwise equal.
  * Checkpoint/resume via `torch.save`: params, optimizer state, step,
    epoch, batch-in-epoch, best metric, in_evaluation flag -- the reference
    saves the same set (:709-727). Resume is exact: all data randomness is
    index-seeded, and the state is restored bit for bit.
  * Loss strategies (reference :216-276): invisible_part,
    entire_target_object, entire_scene, ssi invisible_part,
    ssi entire_target_object.

Validation protocol (reference :470-670): per-sample prediction, least-
squares alignment of pred to the *observation* over the visible mask,
difficulty binning by visibility ratio (>0.75 easy / >0.5 mid / else
hard), the 10-metric suite on the invisible region, raw + aligned
tracker banks, best-model selection on the aligned-overall main metric.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import inspect
import logging
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..ops.precision import apply_precision_policy
from ..ops.resize import resize_nearest
from ..parallel.comm import all_gather, all_reduce_, batch_sum, data_reduction
from ..parallel.mesh import (axis_group, axis_size, capturable,
                             check_capturable, make_mesh)
from ..parallel.multihost import (is_main_process, local_device,
                                  sync_processes)
from ..parallel.sharding import (Placement, seq_partial, shard_batch,
                                 shard_params, shard_tensor, unshard_tensor)
from ..utils.alignment import fit_scale_shift
from ..utils.loss import get_loss
from ..utils.metrics import (METRIC_FNS, MetricTracker,
                             compute_metrics_per_sample)
from ..utils.profiling import StepTimer, start_trace, stop_trace
from ..utils.graphs import capture
from .state import Adafactor, create_train_state, make_optimizer

__all__ = ["DiscriminativeTrainer", "TrainerConfig", "LOSS_STRATEGIES"]

LOGGER = logging.getLogger(__name__)

LOSS_STRATEGIES = ("invisible_part", "entire_target_object", "entire_scene",
                   "ssi invisible_part", "ssi entire_target_object")

CHECKPOINT_FILE = "state.pt"
MAX_STEP_PROGRAMS = 4   # captured train steps kept per trainer


@dataclasses.dataclass
class TrainerConfig:
    loss_strategy: str = "entire_target_object"
    loss_name: str = "silog_loss"
    loss_kwargs: dict = dataclasses.field(default_factory=lambda: {"beta": 0.15})
    lr: float = 3e-5
    lr_total_iter: int = 50000
    lr_final_ratio: float = 0.01
    lr_warmup_steps: int = 100
    max_grad_norm: float = 0.01
    max_iter: int = 60000
    max_epoch: int = 10000
    accumulation_steps: int = 1
    gt_depth_type: str = "depth_gt"
    gt_mask_type: str = "valid_mask_raw"
    init_seed: int | None = 2024
    val_init_seed: int = 2024
    eval_metrics: Sequence[str] = tuple(METRIC_FNS)
    main_val_metric: str = "abs_relative_difference"
    main_val_metric_goal: str = "minimize"
    save_period: int = 20000
    backup_period: int = 20000
    validation_period: int = 10000
    visualization_period: int = 10000
    log_interval: int = 200
    compute_dtype: str = "float32"  # 'bfloat16' for speed on the card
    # update rule: "adam" (reference recipe), "adam-bf16mu", "adafactor"
    optimizer: str = "adam"
    # False | True (full per-block recompute) | "attn" (keep the attention
    # output and LSE, so the backward never re-runs the forward kernel)
    remat: "bool | str" = "attn"
    attn_impl: str | None = None
    # ZeRO-3-style parameter/optimizer sharding over the mesh's data axis
    # (parallel/sharding.py); composes with the model axis
    fsdp: bool = False
    # Megatron-SP: the trunk's token stream split over the model axis
    # between the matmuls; a no-op unless the mesh's model axis is > 1
    sequence_parallel: bool = False
    # torch.profiler trace capture: write a Chrome trace of micro steps
    # [profile_start, profile_start + profile_steps) to this dir
    profile_dir: str | None = None
    profile_start: int = 50
    profile_steps: int = 5
    # run the DPT head over batch chunks of this size, each chunk's
    # forward recomputed in the backward: caps the head's activations
    head_tile: int | None = None


def _strategy_loss(loss_fn, strategy: str, pred, gt, valid, guide, invisible,
                   visible):
    """pred/gt [B,H,W,1]; masks [B,H,W,1] bool. Returns scalar loss."""
    if strategy == "invisible_part":
        return loss_fn(pred, gt, valid & invisible)
    if strategy == "entire_target_object":
        return loss_fn(pred, gt, valid & guide)
    if strategy == "entire_scene":
        return loss_fn(pred, gt)
    if strategy in ("ssi invisible_part", "ssi entire_target_object"):
        # closed-form scale/shift fit over the visible region, then masked
        # L1 on the target region
        scale, shift = fit_scale_shift(pred[..., 0], gt[..., 0],
                                       visible[..., 0])
        aligned = pred * scale[:, None, None, None] + shift[:, None, None, None]
        region = valid & (invisible if "invisible" in strategy else guide)
        m = region.to(pred.dtype)
        n = batch_sum(m.sum()).clamp_min(1.0)
        return batch_sum(((aligned - gt).abs() * m).sum()) / n
    raise ValueError(f"unknown loss strategy: {strategy}")


def _resolve_captured(device: torch.device, mesh, captured) -> bool:
    """Whether the train step runs captured: the caller's choice, else on
    the card wherever the mesh's collectives can be captured."""
    if captured is None:
        return device.type == "cuda" and capturable(mesh)
    if captured and device.type == "cuda":
        check_capturable(mesh, "the train step")
    return bool(captured)


class DiscriminativeTrainer:
    """Trainer for AmodalDAv2-style pixel-space models.

    `model`: the module to train (`models.get_model`); the trainer moves it
    to `device` in float32 and owns it from then on. Without `params` (a
    state dict) the weights are drawn from `seed`. `captured`: run each
    train step as one program over static buffers, captured as a CUDA graph
    on the card (default: on the card, unless the mesh's collectives run
    over gloo, which a graph cannot hold: then eager; False runs the same
    step eagerly; on the CPU, True runs the static-buffer program without a
    graph; True over a gloo group on the card raises ValueError, see
    `parallel.mesh.check_capturable`). `mesh`: see the module docstring;
    in a process group "cuda" is this rank's card."""

    # the submodule the optimizer moves (None: every parameter); the others
    # keep requires_grad=False and stay out of the optimizer state
    trainable: str | None = None

    def __init__(self, cfg: TrainerConfig, model: torch.nn.Module,
                 train_loader, val_loaders=None, vis_loaders=None, *,
                 device="cuda", out_dir_ckpt=None, out_dir_eval=None,
                 out_dir_vis=None, params=None, seed: int = 0,
                 captured: bool | None = None, mesh=None):
        if cfg.loss_strategy not in LOSS_STRATEGIES:
            raise ValueError(f"unknown loss strategy: {cfg.loss_strategy}")
        if cfg.head_tile and "head_batch_tile" not in inspect.signature(
                model.forward).parameters:
            raise ValueError(
                f"TrainerConfig.head_tile is not supported by model "
                f"{type(model).__name__!r} (forward() has no "
                f"head_batch_tile)")
        self.cfg = cfg
        self.device = local_device(device)
        self.mesh = mesh if mesh is not None else make_mesh()
        self._data_group = axis_group(self.mesh, "data")
        self._n_data = axis_size(self.mesh, "data")
        self.dtype = getattr(torch, cfg.compute_dtype)
        apply_precision_policy(self.dtype)
        if self.device.type == "cuda":
            # deterministic cuDNN backward algorithms: a step gives the
            # same bits every time, eagerly or replayed
            torch.backends.cudnn.deterministic = True
        self.train_loader = train_loader
        self.val_loaders = val_loaders or []
        self.vis_loaders = vis_loaders or []
        self.out_dir_ckpt = out_dir_ckpt
        self.out_dir_eval = out_dir_eval
        self.out_dir_vis = out_dir_vis

        self.model = model.to(device=self.device, dtype=torch.float32)
        if params is None:
            self._init_weights(torch.Generator(
                device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(params, strict=True)
        if self.trainable is not None:
            for name, p in self.model.named_parameters():
                p.requires_grad_(name.startswith(self.trainable + "."))
        layout = None
        if cfg.optimizer == "adafactor":
            # adafactor factors and normalises on the JAX package's layout
            from ..convert.weights import jax_param_layout
            table = jax_param_layout(self.model)
            layout = [table.get(name, (None, None))
                      for name, p in self.model.named_parameters()
                      if p.requires_grad]
        # the full weights, cut down to this rank's pieces
        full_shapes = {n: tuple(p.shape)
                       for n, p in self.model.named_parameters()}
        self.placements = shard_params(self.mesh, self.model, fsdp=cfg.fsdp)
        self.tx = make_optimizer(
            lr=cfg.lr, total_iter=cfg.lr_total_iter,
            final_ratio=cfg.lr_final_ratio, warmup_steps=cfg.lr_warmup_steps,
            max_grad_norm=cfg.max_grad_norm,
            accumulation_steps=cfg.accumulation_steps,
            optimizer=cfg.optimizer, layout=layout)
        trained = [n for n, p in self.model.named_parameters()
                   if p.requires_grad]
        self._grad_sync = self._plan_grad_sync(trained)
        if any(self._grad_sync["splits"]):
            self.tx.shard_(self._grad_sync["splits"],
                           [full_shapes[n] for n in trained])
        self.state = create_train_state(self.model, self.tx)
        self.loss_fn = get_loss(cfg.loss_name, **(cfg.loss_kwargs or {}))

        # metric trackers: {bucket or overall} x {raw, aligned}
        names = list(cfg.eval_metrics)
        self.metric_banks = {
            key: MetricTracker(*names)
            for key in ("overall", "easy", "mid", "diff",
                        "align_overall", "align_easy", "align_mid",
                        "align_diff")
        }
        self.train_metrics = MetricTracker("loss")
        goal_min = cfg.main_val_metric_goal == "minimize"
        self.best_metric = float("inf") if goal_min else -float("inf")
        self._goal_min = goal_min

        self.epoch = 0
        self.n_batch_in_epoch = 0
        self.effective_iter = 0
        self.in_evaluation = False

        self.step_timer = StepTimer()
        self._micro_step_count = 0
        self._trace = None
        self.captured = _resolve_captured(self.device, self.mesh, captured)
        self._scalars = None      # the optimizer's device scalars
        self._programs = _StepPrograms(self)

    def _init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights for a run without `params`: the model's own
        `init_weights_` (the baselines), else the DAV2 scheme."""
        if hasattr(self.model, "init_weights_"):
            self.model.init_weights_(generator)
            return
        from ..models.amodal_dav2 import init_weights_
        init_weights_(self.model, generator)

    # ------------------------------------------------------------ scale-out

    def _plan_grad_sync(self, names: list[str]) -> dict:
        """Per trained parameter (`names`): the groups its gradient is
        summed over ("data" unless FSDP reduce-scattered it already;
        "model" for the block parameters that see token slices under
        sequence parallelism) and the {dim: group} it is split along."""
        data, model = self._data_group, axis_group(self.mesh, "model")
        sp = self._act_sharding() is not None
        sums, splits = [], []
        for name in names:
            pl = self.placements[name]
            groups = [] if pl.dim("data") is not None or data is None \
                else [data]
            if sp and seq_partial(name):
                groups.append(model)
            sums.append(groups)
            splits.append({pl.dim(a): axis_group(self.mesh, a)
                           for a in ("model", "data")
                           if pl.dim(a) is not None})
        return {"sums": sums, "splits": splits}

    def _act_sharding(self):
        """The mesh for sequence parallelism when it is asked for and the
        model axis is > 1, else None (JAX `_act_sharding`)."""
        if not self.cfg.sequence_parallel or \
                axis_size(self.mesh, "model") <= 1:
            return None
        return self.mesh

    def full_state_dict(self) -> dict:
        """The model's state dict with every sharded tensor whole (every
        rank calls it: it gathers)."""
        sd = self.model.state_dict()
        return {k: unshard_tensor(v, self.placements[k], self.mesh)
                if k in self.placements and not self.placements[k].replicated
                else v for k, v in sd.items()}

    # ----------------------------------------------------------- the steps

    def _device_batch(self, batch: dict) -> dict:
        """This rank's rows of a host batch, on the device."""
        return {k: torch.from_numpy(np.ascontiguousarray(
                    shard_batch(self.mesh, v))).to(self.device,
                                                   non_blocking=True)
                for k, v in batch.items()
                if isinstance(v, np.ndarray) and v.dtype != object}

    def _forward(self, batch: dict, remat) -> torch.Tensor:
        """The model's prediction on one device batch (the baselines'
        trainers call their models their own way)."""
        dtype = self.dtype
        extra = {}
        if self.cfg.head_tile:
            extra["head_batch_tile"] = self.cfg.head_tile
        if self._act_sharding() is not None:
            extra["act_sharding"] = self._act_sharding()
        return self.model(
            (batch["rgb_int"] / 255.0).to(dtype),
            guide_rgb=batch["guide_rgb_norm"].to(dtype),
            guide_mask=(batch["guide"] * 2.0 - 1.0).to(dtype),
            observation=(batch["depth_observation"] * 2.0 - 1.0).to(dtype),
            attn_impl=self.cfg.attn_impl, remat=remat, **extra)

    def _predict(self, batch: dict, remat) -> torch.Tensor:
        """Float32 prediction at the ground truth's size."""
        pred = self._forward(batch, remat).float()
        gt = batch[self.cfg.gt_depth_type]
        if pred.shape[1:3] != gt.shape[1:3]:
            pred = resize_nearest(pred, size=tuple(gt.shape[1:3]))
        return pred

    def _step_draws(self, batch: dict) -> dict:
        """The random draws of the next train step, made before it runs
        (none here; the DepthFM trainers draw their noise and timesteps)."""
        return {}

    def loss_of(self, batch: dict, draws: dict | None = None) -> torch.Tensor:
        """The guarded scalar loss of one device batch."""
        cfg = self.cfg
        pred = self._predict(batch, cfg.remat)
        loss = _strategy_loss(
            self.loss_fn, cfg.loss_strategy, pred, batch[cfg.gt_depth_type],
            batch[cfg.gt_mask_type] > 0, batch["guide"] > 0,
            batch["invisible_mask"] > 0, batch["visible_mask"] > 0)
        # NaN guard (reference zero-loss fallback, :246-251)
        return torch.where(torch.isfinite(loss), loss, 0.0)

    def loss_and_grads(self, batch: dict, draws: dict | None = None):
        """(loss, gradients by parameter name), the gradients guarded:
        non-finite entries are 0, as are those of unused parameters.
        `draws`: the step's random draws (default: `_step_draws`). Under a
        mesh: the global batch's loss and gradients (module docstring)."""
        if draws is None:
            draws = self._step_draws(batch)
        params = self.state.params
        with data_reduction(self._data_group):
            loss = self.loss_of(batch, draws)
        scaled = loss / self._n_data if self._n_data > 1 else loss
        grads = torch.autograd.grad(scaled, list(params.values()),
                                    allow_unused=True)
        guarded = {}
        for (name, p), g, groups in zip(params.items(), grads,
                                        self._grad_sync["sums"]):
            g = torch.zeros_like(p) if g is None else g
            for group in groups:
                all_reduce_(g, group)
            guarded[name] = torch.nan_to_num_(g, nan=0.0, posinf=0.0,
                                              neginf=0.0)
        return loss.detach(), guarded

    def _step_body(self, batch: dict, draws: dict, apply: bool):
        """The device program of one micro-step: loss, guarded gradients
        and the optimizer's `step_`. Reads no host value of the step."""
        loss, grads = self.loss_and_grads(batch, draws)
        self.tx.step_(list(self.state.params.values()), list(grads.values()),
                      self.state.opt_state, self._scalars, apply)
        return loss

    def _train_step(self, batch: dict) -> torch.Tensor:
        opt_state = self.state.opt_state
        if self._scalars is None:
            self._scalars = self.tx.scalars(opt_state, self.device)
        draws = self._step_draws(batch)
        apply = self.tx.applies(opt_state)
        if self.captured:
            loss = self._programs.run(batch, draws, apply)
        else:
            loss = self._step_body(batch, draws, apply)
        self.tx.advance(opt_state, apply)
        self.state.step += 1
        return loss

    @torch.no_grad()
    def _eval_forward(self, batch: dict):
        pred = self._predict(batch, False)
        # on-device alignment of pred to observation over visible mask
        scale, shift = fit_scale_shift(
            pred[..., 0], batch["depth_observation"][..., 0],
            batch["visible_mask"][..., 0])
        aligned = pred * scale[:, None, None, None] + \
            shift[:, None, None, None]
        return pred, aligned

    @torch.no_grad()
    def _batch_metrics(self, pred, aligned, gt, mask):
        """The whole metric suite for BOTH banks of a batch, [B, n_metrics]
        raw + aligned, on the device: one pass per metric, no loop over
        samples."""
        names = tuple(self.cfg.eval_metrics)
        # +1e-5 shift matches the reference's epsilon on both operands
        m_raw = compute_metrics_per_sample(pred + 1e-5, gt + 1e-5, mask, names)
        m_al = compute_metrics_per_sample(aligned + 1e-5, gt + 1e-5, mask,
                                          names)
        return m_raw, m_al

    # ---------------------------------------------------------------- train

    def train(self, t_end: float | None = None) -> None:
        """Run until max_iter effective iters (or wall-clock t_end, epoch
        semantics as in reference :143-407)."""
        if self.in_evaluation:
            LOGGER.info("finishing interrupted evaluation before training")
            self.validate()
            self.in_evaluation = False
            self.save_checkpoint("latest")
        self.train_metrics.reset()
        try:
            self._train_loop(t_end)
        finally:
            self._stop_profile()

    def _train_loop(self, t_end):
        cfg = self.cfg
        micro_count = 0
        for epoch in range(self.epoch, cfg.max_epoch + 1):
            self.epoch = epoch
            self.train_loader.set_epoch(epoch)
            if self.n_batch_in_epoch:
                self.train_loader.skip_first_batches(self.n_batch_in_epoch)
            for batch in self.train_loader:
                dev_batch = self._device_batch(batch)
                self._profile_tick()
                with self.step_timer.step():
                    loss = float(self._train_step(dev_batch))  # device sync
                self._micro_step_count += 1
                self.n_batch_in_epoch += 1
                micro_count += 1
                self.train_metrics.update("loss", loss)

                if micro_count >= cfg.accumulation_steps:
                    micro_count = 0
                    self.effective_iter += 1
                    if self.effective_iter % cfg.log_interval == 0:
                        LOGGER.info("iter %d loss %.5f", self.effective_iter,
                                    self.train_metrics.avg("loss"))
                        from ..utils.logging_util import tb_logger
                        scalars = {"train/loss":
                                   self.train_metrics.avg("loss")}
                        timing = self.step_timer.summary()
                        if timing:
                            scalars["perf/step_p50_s"] = timing["p50_s"]
                            scalars["perf/steps_per_sec"] = \
                                timing["steps_per_sec"]
                        tb_logger.log_dic(scalars, self.effective_iter)
                        self.train_metrics.reset()
                    self._periodic_callbacks()
                    if self.effective_iter >= cfg.max_iter:
                        self.save_checkpoint("latest")
                        return
                if t_end is not None and time.time() >= t_end:
                    LOGGER.info("time limit reached; saving latest checkpoint")
                    self.save_checkpoint("latest")
                    return
            self.n_batch_in_epoch = 0
        self.save_checkpoint("latest")

    def _profile_tick(self) -> None:
        """Start/stop the torch.profiler trace window."""
        cfg = self.cfg
        if not cfg.profile_dir:
            return
        if self._micro_step_count == cfg.profile_start and self._trace is None:
            self._trace = start_trace()
        elif self._trace is not None and self._micro_step_count >= \
                cfg.profile_start + cfg.profile_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self._trace is not None:
            trace, self._trace = self._trace, None
            stop_trace(trace, self.cfg.profile_dir)

    def _periodic_callbacks(self) -> None:
        cfg = self.cfg
        it = self.effective_iter
        if cfg.validation_period and it % cfg.validation_period == 0 \
                and self.val_loaders:
            self.in_evaluation = True
            self.save_checkpoint("latest")
            self.validate()
            self.in_evaluation = False
            self.save_checkpoint("latest")
        if cfg.save_period and it % cfg.save_period == 0:
            self.save_checkpoint(f"iter_{it:06d}")
        if cfg.visualization_period and it % cfg.visualization_period == 0 \
                and self.vis_loaders:
            self.visualize()

    # ------------------------------------------------------------- validate

    def validate(self) -> dict:
        results = {}
        for loader in self.val_loaders:
            name = getattr(loader.dataset, "disp_name", "val")
            results[name] = self.validate_single_dataset(loader, eval=True)
            main = self.metric_banks["align_overall"].avg(
                self.cfg.main_val_metric)
            if np.isfinite(main):
                better = main < self.best_metric if self._goal_min \
                    else main > self.best_metric
                if better:
                    self.best_metric = main
                    LOGGER.info("new best %s = %.6f",
                                self.cfg.main_val_metric, main)
                    if self.out_dir_ckpt:
                        self.save_checkpoint("best")
        return results

    def validate_single_dataset(self, data_loader, save_to_dir=None,
                                eval: bool = True) -> dict:
        for bank in self.metric_banks.values():
            bank.reset()
        # All randomness is index-seeded in the datasets/loader
        # ((seed, epoch, index), data/base_depth_dataset.py), so replay is
        # deterministic by construction.
        names = list(self.cfg.eval_metrics)
        # each data rank scores its rows; the rows are gathered in order
        gather = functools.partial(all_gather, group=self._data_group)
        for batch in data_loader:
            dev_batch = self._device_batch(batch)
            pred_d, aligned_d = self._eval_forward(dev_batch)
            if eval:
                # Amodal batches score the invisible region; plain depth
                # batches (no amodal keys) score the whole valid mask.
                valid = dev_batch[self.cfg.gt_mask_type] > 0
                invisible = dev_batch.get("invisible_mask")
                mask = (invisible > 0) & valid if invisible is not None \
                    else valid
                m_raw, m_al = self._batch_metrics(
                    pred_d[..., 0], aligned_d[..., 0],
                    dev_batch[self.cfg.gt_depth_type][..., 0], mask[..., 0])
                m_raw, m_al = (gather(m).cpu().numpy() for m in (m_raw, m_al))
            pred = gather(pred_d).cpu().numpy()

            has_buckets = "guide" in batch and "visible_mask" in batch
            for b in range(pred.shape[0]):
                mask_ok = batch.get("__sample_mask__")
                if mask_ok is not None and not mask_ok[b]:
                    continue
                if has_buckets:
                    guide = batch["guide"][b] > 0
                    visible = batch["visible_mask"][b] > 0
                    obj_px = float(guide.sum())
                    vis_ratio = float(visible.sum()) / max(obj_px, 1.0)
                    bucket = "easy" if vis_ratio > 0.75 else \
                        "mid" if vis_ratio > 0.5 else "diff"
                    raw_keys = ("overall", bucket)
                    al_keys = ("align_overall", f"align_{bucket}")
                else:
                    raw_keys = ("overall",)
                    al_keys = ("align_overall",)

                if eval:
                    self._track_sample(m_raw[b], names, raw_keys)
                    self._track_sample(m_al[b], names, al_keys)

                if save_to_dir is not None and is_main_process():
                    self._save_prediction(save_to_dir, batch, b, pred[b])

        return {k: bank.result() for k, bank in self.metric_banks.items()}

    def _track_sample(self, values, names, bank_keys) -> None:
        for name, val in zip(names, values):
            if not np.isfinite(val):
                continue  # skip-nan (reference :600-603)
            for key in bank_keys:
                self.metric_banks[key].update(name, float(val))

    def _save_prediction(self, save_to_dir, batch, b, pred) -> None:
        from ..utils.image import write_png
        os.makedirs(save_to_dir, exist_ok=True)
        rel = batch["rgb_relative_path"][b].replace("/", "_")
        out = (np.clip(pred[..., 0], 0, 1) * 65535).astype(np.uint16)
        write_png(os.path.join(save_to_dir, f"{rel}.png"), out)

    # ------------------------------------------------------------ visualize

    def visualize(self) -> None:
        if not (self.out_dir_vis and self.vis_loaders):
            return
        from ..utils.image import colorize_depth, write_png
        out_dir = os.path.join(self.out_dir_vis,
                               f"iter_{self.effective_iter:06d}")
        os.makedirs(out_dir, exist_ok=True)
        for loader in self.vis_loaders:
            for batch in loader:
                pred, _ = self._eval_forward(self._device_batch(batch))
                pred = all_gather(pred, self._data_group).cpu().numpy()
                if not is_main_process():
                    continue
                for b in range(pred.shape[0]):
                    gt = batch[self.cfg.gt_depth_type][b][..., 0]
                    rgb = (batch["rgb_int"][b] / 255.0)
                    masked_rgb = rgb * batch["guide"][b]
                    panel = np.concatenate([
                        np.concatenate([colorize_depth(pred[b][..., 0]),
                                        colorize_depth(gt)], axis=1),
                        np.concatenate([rgb, masked_rgb], axis=1),
                    ], axis=0)
                    rel = batch["rgb_relative_path"][b].replace("/", "_")
                    write_png(os.path.join(out_dir, f"{rel}.png"),
                              (panel * 255).astype(np.uint8))

    # ----------------------------------------------------------- checkpoint

    def save_checkpoint(self, tag: str) -> None:
        """Write `<out_dir_ckpt>/<tag>/state.pt`: the model's state dict
        (every parameter, the frozen ones too, and the BatchNorm running
        statistics of the baselines), optimizer state, step and the resume
        metadata. Under a mesh the sharded tensors are gathered whole, rank
        0 writes, and every rank meets at a barrier: the file is the same
        whatever the mesh."""
        if not self.out_dir_ckpt:
            return
        path = os.path.abspath(os.path.join(self.out_dir_ckpt, tag))
        tree = {
            "params": {k: v.detach()
                       for k, v in self.full_state_dict().items()},
            "opt_state": self._opt_state_pieces(unshard_tensor),
            "step": self.state.step,
            "meta": {
                "epoch": self.epoch,
                "n_batch_in_epoch": self.n_batch_in_epoch,
                "effective_iter": self.effective_iter,
                "best_metric": self.best_metric,
                "in_evaluation": self.in_evaluation,
            },
        }
        if is_main_process():
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
            torch.save(tree, tmp)
            os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
            LOGGER.info("saved checkpoint %s", path)
        sync_processes(f"ckpt_{tag}")

    def _opt_state_pieces(self, fn, state: dict | None = None) -> dict:
        """The optimizer state with `fn(tensor, placement, mesh)` applied to
        each tensor of a sharded parameter (`unshard_tensor` to write,
        `shard_tensor` to read): a moment shaped as its parameter takes the
        parameter's placement, an Adafactor statistic that placement less
        the axis it reduced."""
        state = self.state.opt_state if state is None else state
        names = list(self.state.params)
        plan = self.tx.plan(list(self.state.params.values()))[0] \
            if isinstance(self.tx, Adafactor) else [None] * len(names)
        out = {}
        for key, value in state.items():
            if not isinstance(value, list):
                out[key] = value
                continue
            pieces = []
            for name, t, fd in zip(names, value, plan):
                pl = self.placements[name]
                if pl.replicated or t.numel() == 1:   # Adafactor's [1]
                    pieces.append(t)
                    continue
                if key in ("v_row", "v_col") and fd is not None:
                    gone = fd[1] if key == "v_row" else fd[0]
                    pl = Placement(pl.spec[:gone] + pl.spec[gone + 1:],
                                   pl.parts)
                pieces.append(fn(t, pl, self.mesh))
            out[key] = pieces
        return out

    def load_checkpoint(self, path: str, *,
                        resume_training: bool = True) -> None:
        """Restore a `save_checkpoint` directory, exactly."""
        tree = torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                          map_location=self.device, weights_only=True)
        params = self.model.state_dict()
        if set(tree["params"]) != set(params):
            raise ValueError("checkpoint parameters do not match the model")
        with torch.no_grad():
            for name, p in params.items():
                full = tree["params"][name]
                pl = self.placements.get(name)
                p.copy_(full if pl is None or pl.replicated
                        else shard_tensor(full, pl, self.mesh))
        self._load_opt_state(self._opt_state_pieces(shard_tensor,
                                                    tree["opt_state"]))
        self.state.step = int(tree["step"])
        if resume_training:
            meta = tree["meta"]
            self.epoch = int(meta["epoch"])
            self.n_batch_in_epoch = int(meta["n_batch_in_epoch"])
            self.effective_iter = int(meta["effective_iter"])
            self.best_metric = float(meta["best_metric"])
            self.in_evaluation = bool(meta["in_evaluation"])
        LOGGER.info("restored checkpoint %s (iter %d)", path,
                    self.effective_iter)

    @torch.no_grad()
    def _load_opt_state(self, loaded: dict) -> None:
        """Restore the optimizer state in place (captured steps keep their
        addresses), and the device scalars from its host integers."""
        state = self.state.opt_state
        if set(loaded) != set(state) or any(
                len(loaded[k]) != len(v) for k, v in state.items()
                if isinstance(v, list)):
            raise ValueError("checkpoint optimizer state does not match the "
                             "trainer's")
        for key, value in loaded.items():
            if isinstance(value, list):
                for dst, src in zip(state[key], value):
                    dst.copy_(src)
            else:
                state[key] = int(value)
        if self._scalars is not None:
            for key, t in self.tx.scalars(state, self.device).items():
                self._scalars[key].copy_(t)


class _StepPrograms:
    """A trainer's train step as programs over static buffers, one per
    (micro-step kind, batch signature, draw signature): captured as CUDA
    graphs on the card, sharing one memory pool (a replay's loss is read
    before the next replay), and run eagerly over the same buffers on the
    CPU. At most `MAX_STEP_PROGRAMS` are kept; the oldest goes first."""

    def __init__(self, trainer: DiscriminativeTrainer):
        self.trainer = trainer
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.pool = None

    @staticmethod
    def _leaves(tree: dict) -> list:
        out = []
        for key in sorted(tree):
            v = tree[key]
            out.extend(v if isinstance(v, list) else [v])
        return out

    def run(self, batch: dict, draws: dict, apply: bool) -> torch.Tensor:
        leaves = self._leaves(batch) + self._leaves(draws)
        key = (apply, tuple(sorted(batch)), tuple(sorted(draws)),
               tuple((tuple(t.shape), t.dtype) for t in leaves))
        entry = self.entries.get(key)
        if entry is None:
            entry = self._make(batch, draws, apply)
            self.entries[key] = entry
            while len(self.entries) > MAX_STEP_PROGRAMS:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
        statics, fn, graph, loss = entry
        for static, t in zip(statics, leaves):
            static.copy_(t)
        if graph is None:
            return fn()
        graph.replay()
        return loss.clone()

    def _make(self, batch: dict, draws: dict, apply: bool):
        t = self.trainer
        static_batch = {k: v.clone() for k, v in batch.items()}
        static_draws = {k: [x.clone() for x in v] if isinstance(v, list)
                        else v.clone() for k, v in draws.items()}
        statics = self._leaves(static_batch) + self._leaves(static_draws)

        def fn():
            return t._step_body(static_batch, static_draws, apply)

        if t.device.type != "cuda":
            return statics, fn, None, None
        # the warm-up runs real steps: what they change is put back
        moved = ([p for p in t.state.params.values()]
                 + [b for b in t.model.buffers()]
                 + self._leaves({k: v for k, v in t.state.opt_state.items()
                                 if isinstance(v, list)})
                 + list(t._scalars.values()))
        saved = [x.detach().to("cpu", copy=True) for x in moved]

        def restore():
            with torch.no_grad():
                for x, s in zip(moved, saved):
                    x.copy_(s)

        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph, loss = capture(fn, device=t.device, pool=self.pool,
                              restore=restore)
        return statics, fn, graph, loss
