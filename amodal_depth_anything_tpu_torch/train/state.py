"""Train state & optimizer assembly.

Reference training recipe (`discriminative_trainer.py:72-81`,
`config/train_discriminative_vitl.yaml:35,45-61`): Adam, IterExponential
LR (warmup 100, decay to 1% over 50k), global-norm grad clip 0.01. The JAX
package builds that as one optax chain; this module writes the same update
out on lists of tensors, formula by formula, because the library
counterparts differ where it matters at this recipe's settings:

  * the clip is optax's `g / max(norm, max_norm) * max_norm`;
    `torch.nn.utils.clip_grad_norm_` scales by `max_norm / (norm + 1e-6)`,
    and at clip 0.01 nearly every step clips;
  * Adam is optax's: b1 0.9, b2 0.999, eps 1e-8 added outside the square
    root, bias correction on both moments, and the schedule is read at the
    count BEFORE the update, so the first update has lr(0);
  * gradient accumulation is optax's `MultiSteps`: a running mean over the
    micro-batches, then clip and Adam once per effective step.

Parameters, moments and the accumulator stay float32 whatever the compute
dtype. The update is applied in place.

The update reads nothing of the step from the host: the update count and
the micro-step within an accumulation live in device scalars
(`Optimizer.scalars`), updated in place, and the learning rate and Adam's
float32 bias corrections are gathered from device tables of the host
formulas' values (`Optimizer.tables`: the schedule's float32 values and
1 - b ** count for every count up to where all three stay constant). So the
same device program serves every step, eagerly or replayed as a CUDA graph
(`train/trainer.py`), and the two are bitwise equal. The state keeps its
host integers "count" and "mini_step" (the checkpoint format), advanced by
`advance` beside the device scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.lr_schedule import iter_exponential

__all__ = ["TrainState", "Optimizer", "make_optimizer", "create_train_state",
           "global_norm", "clip_by_global_norm"]

DEFERRED_OPTIMIZERS = ("adam-bf16mu", "adafactor")


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]   # the model's own parameters, by name
    opt_state: dict[str, Any]
    step: int = 0                     # micro-steps taken


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), float32 scalar."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None) -> None:
    """optax.clip_by_global_norm, in place: g / norm * max_norm when the
    norm reaches max_norm, untouched below it."""
    norm = global_norm(grads) if norm is None else norm
    divisor = torch.where(norm < max_norm, torch.ones_like(norm),
                          norm / max_norm)
    torch._foreach_div_(grads, divisor)


class Optimizer:
    """clip_by_global_norm -> Adam(schedule), under MultiSteps when
    `accumulation_steps > 1`. State is a plain dict of ints and tensor
    lists, so it checkpoints with `torch.save`. `schedule_constant_from`:
    the count from which `schedule` no longer changes."""

    def __init__(self, schedule, max_grad_norm: float,
                 accumulation_steps: int = 1, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 schedule_constant_from: int):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = int(accumulation_steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        # the schedule's value no longer changes from this count on
        self.schedule_constant_from = int(schedule_constant_from)
        self._tables: dict = {}

    def init(self, params: list[torch.Tensor]) -> dict[str, Any]:
        state = {"count": 0, "mini_step": 0,
                 "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.accumulation_steps > 1:
            state["acc_grads"] = [torch.zeros_like(p) for p in params]
        return state

    def tables(self, device) -> torch.Tensor:
        """[3, L] float32 on `device`: row 0 the schedule at count i, rows
        1-2 the bias corrections 1 - b1 ** i and 1 - b2 ** i in float32, as
        optax takes them (at count 1, 1 - float32(0.999) is 1.3e-5 off
        0.001). L is where all three have stopped changing; a count past
        the end reads the last column."""
        key = str(torch.device(device))
        if key not in self._tables:
            f32 = np.float32
            bs = (f32(self.b1), f32(self.b2))

            def correction(b, i):
                return float(f32(1.0) - b ** f32(i))

            n = self.schedule_constant_from + 1
            while any(correction(b, n) != 1.0 for b in bs):
                n += 64
            cols = [[self.schedule(i)] + [correction(b, i) for b in bs]
                    for i in range(n + 1)]
            self._tables[key] = torch.tensor(
                np.asarray(cols, np.float32).T.copy(), device=device)
        return self._tables[key]

    def scalars(self, state: dict, device) -> dict[str, torch.Tensor]:
        """The device scalars of `state`'s host integers: "count" (int64)
        and "mini_step" (float32), updated in place by `step_`."""
        return {"count": torch.full((), state["count"], dtype=torch.int64,
                                    device=device),
                "mini_step": torch.full((), state["mini_step"],
                                        dtype=torch.float32, device=device)}

    def applies(self, state: dict) -> bool:
        """Whether the next micro-step moves the parameters (always, without
        accumulation; every k-th call with it)."""
        k = self.accumulation_steps
        return k == 1 or state["mini_step"] == k - 1

    def advance(self, state: dict, applied: bool) -> None:
        """The host integers after one micro-step."""
        if self.accumulation_steps > 1:
            state["mini_step"] = (state["mini_step"] + 1) % \
                self.accumulation_steps
        if applied:
            state["count"] += 1

    @torch.no_grad()
    def step_(self, params: list[torch.Tensor], grads: list[torch.Tensor],
              state: dict[str, Any], scalars: dict[str, torch.Tensor],
              apply: bool) -> None:
        """One micro-step on the device alone (`apply`: whether it is the
        last of an accumulation, `applies`). `grads` (already guarded
        against non-finite entries) may be overwritten. Reads no host
        integer of `state`: capturable."""
        if self.accumulation_steps > 1:
            acc, mini = state["acc_grads"], scalars["mini_step"]
            # running mean: acc + (g - acc) / (n + 1)
            torch._foreach_sub_(grads, acc)
            torch._foreach_div_(grads, mini + 1.0)
            torch._foreach_add_(acc, grads)
            if not apply:
                mini.add_(1.0)
                return
            mini.zero_()
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        clip_by_global_norm(grads, self.max_grad_norm)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        # the schedule at the count BEFORE the update, the corrections at
        # the count after it
        table = self.tables(params[0].device)
        last = table.shape[1] - 1
        count = scalars["count"]
        lr = table[0].index_select(0, count.clamp(max=last).view(1))
        c1, c2 = table[1:].index_select(
            1, (count + 1).clamp(max=last).view(1)).unbind(0)
        # u = (mu / c1) / (sqrt(nu / c2) + eps);  p += -lr * u
        denom = torch._foreach_div(nu, c2[0])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, c1[0])
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, -lr[0])
        torch._foreach_add_(params, updates)
        count.add_(1)

    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: dict[str, Any],
               scalars: dict[str, torch.Tensor] | None = None) -> bool:
        """One micro-step, eagerly: `step_` then `advance`. `scalars`: the
        caller's device scalars of `state` (kept in step with it); without
        them they are made from the host integers for this call. Returns
        whether the parameters moved."""
        if scalars is None:
            scalars = self.scalars(state, params[0].device)
        apply = self.applies(state)
        self.step_(params, grads, state, scalars, apply)
        self.advance(state, apply)
        return apply


def make_optimizer(*, lr: float, total_iter: int, final_ratio: float = 0.01,
                   warmup_steps: int = 100, max_grad_norm: float = 0.01,
                   accumulation_steps: int = 1,
                   optimizer: str = "adam") -> Optimizer:
    """`optimizer`: "adam", the reference recipe. The JAX package's
    memory-saving rules "adam-bf16mu" and "adafactor" are not ported yet."""
    if optimizer in DEFERRED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer={optimizer!r} is not ported yet; use 'adam'")
    if optimizer != "adam":
        raise ValueError(f"unknown optimizer: {optimizer!r}")
    schedule = iter_exponential(lr, total_iter, final_ratio, warmup_steps)
    return Optimizer(schedule, max_grad_norm, accumulation_steps,
                     schedule_constant_from=max(total_iter, warmup_steps))


def create_train_state(model: torch.nn.Module, tx: Optimizer) -> TrainState:
    """State over the trainable parameters of `model`, which must be
    float32 (the master weights; compute may run in bfloat16)."""
    params = {name: p for name, p in model.named_parameters()
              if p.requires_grad}
    for name, p in params.items():
        if p.dtype != torch.float32:
            raise ValueError(f"parameter {name} is {p.dtype}; training keeps "
                             f"float32 master weights")
    return TrainState(params=params, opt_state=tx.init(list(params.values())))
