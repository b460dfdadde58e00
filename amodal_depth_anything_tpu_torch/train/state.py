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
    lists, so it checkpoints with `torch.save`."""

    def __init__(self, schedule, max_grad_norm: float,
                 accumulation_steps: int = 1, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = int(accumulation_steps)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: list[torch.Tensor]) -> dict[str, Any]:
        state = {"count": 0, "mini_step": 0,
                 "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.accumulation_steps > 1:
            state["acc_grads"] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def update(self, params: list[torch.Tensor], grads: list[torch.Tensor],
               state: dict[str, Any]) -> bool:
        """One micro-step. `grads` (already guarded against non-finite
        entries) may be overwritten. Returns whether the parameters moved
        (always, without accumulation; every k-th call with it)."""
        k = self.accumulation_steps
        if k > 1:
            acc, n = state["acc_grads"], state["mini_step"]
            # running mean: acc + (g - acc) / (n + 1)
            torch._foreach_sub_(grads, acc)
            torch._foreach_div_(grads, float(n + 1))
            torch._foreach_add_(acc, grads)
            state["mini_step"] = (n + 1) % k
            if n != k - 1:
                return False
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        clip_by_global_norm(grads, self.max_grad_norm)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        # u = (mu / c1) / (sqrt(nu / c2) + eps);  p += -lr * u. The bias
        # corrections c = 1 - b ** count are taken in float32, as optax takes
        # them: at count 1, 1 - float32(0.999) is 1.3e-5 off 0.001
        c1, c2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(count))
                  for b in (self.b1, self.b2))
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(params, updates, alpha=-lr)
        state["count"] = count
        return True


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
    return Optimizer(schedule, max_grad_norm, accumulation_steps)


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
