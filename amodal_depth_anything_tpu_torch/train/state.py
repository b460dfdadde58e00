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

The JAX package's two memory-saving rules are here too:

  * "adam-bf16mu" (`optax.adam(mu_dtype=bfloat16)`): the first moment is
    stored bfloat16. optax multiplies the stored moment by b1 as a
    bfloat16 constant (the Python float takes the moment's dtype: 0.9 ->
    0.8984375) and, jitted, adds the float32 0.1 * g in one rounding (a
    fused multiply-add); the port computes that sum in float64 and rounds
    it once to float32. The update reads that float32 moment, and the
    stored moment is its bfloat16 rounding.
  * "adafactor" (`optax.adafactor(clipping_threshold=None,
    min_dim_size_to_factor=128)`, `Adafactor`): the factored second moment,
    its decay 1 - (count + 1) ** -0.8 computed on the device from the
    count, the schedule's learning rate, and the update scaled by
    max(rms(p), 1e-3) over each JAX leaf. optax picks the factored axes
    and the RMS blocks on the JAX package's layout (linear kernels
    [in, out], convolutions HWIO, the ViT blocks stacked [L, ...]); the
    port's tensors are [out, in] / OIHW, one per block, so `Adafactor` is
    made with the layout (`convert.weights.jax_param_layout`), factors the
    same logical axes, and takes a stacked leaf's RMS over all its blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.lr_schedule import iter_exponential

__all__ = ["TrainState", "Optimizer", "Adafactor", "make_optimizer",
           "create_train_state", "global_norm", "clip_by_global_norm"]

OPTIMIZERS = ("adam", "adam-bf16mu", "adafactor")


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]   # the model's own parameters, by name
    opt_state: dict[str, Any]
    step: int = 0                     # micro-steps taken


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), float32 scalar: optax's
    sqrt of the summed per-leaf sums of squares (a sum of per-tensor
    norms squared would round each norm first)."""
    flat = [t.reshape(-1) for t in tensors]
    return torch.stack([torch.dot(t, t) for t in flat]).sum().sqrt()


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None) -> None:
    """optax.clip_by_global_norm, in place: (g / norm) * max_norm when the
    norm reaches max_norm, untouched below it."""
    norm = global_norm(grads) if norm is None else norm
    clip = norm >= max_norm
    divisor = torch.where(clip, norm, torch.ones_like(norm))
    torch._foreach_div_(grads, divisor)
    torch._foreach_mul_(grads, torch.where(
        clip, torch.full_like(norm, max_norm), torch.ones_like(norm)))


class Optimizer:
    """clip_by_global_norm -> Adam(schedule), under MultiSteps when
    `accumulation_steps > 1`. State is a plain dict of ints and tensor
    lists, so it checkpoints with `torch.save`. `schedule_constant_from`:
    the count from which `schedule` no longer changes. `mu_dtype`: the
    stored first moment's dtype (bfloat16 for "adam-bf16mu")."""

    def __init__(self, schedule, max_grad_norm: float,
                 accumulation_steps: int = 1, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 schedule_constant_from: int,
                 mu_dtype: torch.dtype = torch.float32):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.accumulation_steps = int(accumulation_steps)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype
        # the schedule's value no longer changes from this count on
        self.schedule_constant_from = int(schedule_constant_from)
        self._tables: dict = {}

    def init(self, params: list[torch.Tensor]) -> dict[str, Any]:
        state = {"count": 0, "mini_step": 0, **self._init_rule(params)}
        if self.accumulation_steps > 1:
            state["acc_grads"] = [torch.zeros_like(p) for p in params]
        return state

    def _init_rule(self, params) -> dict[str, list]:
        return {"mu": [torch.zeros_like(p, dtype=self.mu_dtype)
                       for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

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
        self._rule_(params, grads, state, scalars["count"])
        scalars["count"].add_(1)

    def _lr(self, table: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """[1]: the schedule at the count BEFORE the update."""
        last = table.shape[1] - 1
        return table[0].index_select(0, count.clamp(max=last).view(1))

    def _rule_(self, params, grads, state, count) -> None:
        """Adam on the clipped gradients, in place."""
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        # the schedule at the count BEFORE the update, the corrections at
        # the count after it
        table = self.tables(params[0].device)
        last = table.shape[1] - 1
        lr = self._lr(table, count)
        c1, c2 = table[1:].index_select(
            1, (count + 1).clamp(max=last).view(1)).unbind(0)
        if self.mu_dtype != torch.float32:
            self._low_mu_rule_(params, grads, mu, nu, lr[0], c1[0], c2[0])
            return
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        # u = (mu / c1) / (sqrt(nu / c2) + eps);  p += -lr * u
        denom = torch._foreach_div(nu, c2[0])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, c1[0])
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, -lr[0])
        torch._foreach_add_(params, updates)

    def _low_mu_rule_(self, params, grads, mu, nu, lr, c1, c2) -> None:
        """Adam's moment and update with a low-precision stored first
        moment, one tensor at a time (the float32 moment of one tensor
        alive at once). optax: b1 takes the stored moment's dtype, and the
        jitted 0.1 * g + b1 * mu rounds once (an FMA): exact in float64,
        then rounded to float32."""
        b1 = float(torch.tensor(self.b1, dtype=self.mu_dtype))
        a = float(np.float32(1.0 - self.b1))
        for p, g, m, v in zip(params, grads, mu, nu):
            m32 = (g.double() * a + m.double() * b1).float()
            u = (m32 / c1).div_((v / c2).sqrt_().add_(self.eps))
            p.add_(u.mul_(-lr))
            m.copy_(m32)

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


class Adafactor(Optimizer):
    """clip_by_global_norm -> optax.adafactor(schedule,
    clipping_threshold=None, min_dim_size_to_factor=128) (decay rate 0.8,
    eps 1e-30 on g ** 2, update scaled by max(rms(p), 1e-3)), under
    MultiSteps when `accumulation_steps > 1`. The state holds optax's
    FactoredState leaves per parameter: "v_row" and "v_col" for a factored
    one, "v" for the others, [1] placeholders where a leaf is unused.
    `layout`: one (dims, stack) per parameter, in the order of the
    parameter lists it is given (`convert.weights.jax_param_layout`); None
    takes each parameter as a JAX leaf of its own, laid out as in the
    port."""

    # the JAX recipe's `optax.adafactor` arguments
    DECAY_RATE, FACTOR_EPS, MIN_DIM_SIZE_TO_FACTOR, MIN_SCALE = \
        0.8, 1e-30, 128, 1e-3

    def __init__(self, *args, layout: list | None = None, **kw):
        super().__init__(*args, **kw)
        self.layout = None if layout is None else list(layout)

    def factored_dims(self, shape, dims=None) -> tuple[int, int] | None:
        """optax's `_factored_dims` on the JAX layout's shape (`dims`: the
        permutation that takes the tensor to it), returned as the tensor's
        own axes (d1, d0): d0 the largest, reduced for the row moment."""
        jshape = tuple(shape) if dims is None else \
            tuple(shape[d] for d in dims)
        if len(jshape) < 2:
            return None
        order = np.argsort(jshape)
        if jshape[order[-2]] < self.MIN_DIM_SIZE_TO_FACTOR:
            return None
        d1, d0 = int(order[-2]), int(order[-1])
        return (d1, d0) if dims is None else (dims[d1], dims[d0])

    def plan(self, params) -> tuple[list, int]:
        """([(factored dims or None, RMS group)] per parameter, the number
        of groups): a stacked JAX leaf's blocks share one group."""
        layout = self.layout or [(None, None)] * len(params)
        if len(layout) != len(params):
            raise ValueError(f"{len(layout)} layout entries for "
                             f"{len(params)} parameters")
        stacks: dict = {}
        plan = []
        for i, (p, (dims, stack)) in enumerate(zip(params, layout)):
            group = stacks.setdefault(i if stack is None else ("s", stack),
                                      len(stacks))
            plan.append((self.factored_dims(p.shape, dims), group))
        return plan, len(stacks)

    def _init_rule(self, params) -> dict[str, list]:
        v_row, v_col, v = [], [], []
        for p, (fd, _) in zip(params, self.plan(params)[0]):
            if fd is None:
                v_row.append(p.new_zeros(1))
                v_col.append(p.new_zeros(1))
                v.append(torch.zeros_like(p))
                continue
            shape = list(p.shape)
            v_row.append(p.new_zeros(shape[:fd[1]] + shape[fd[1] + 1:]))
            v_col.append(p.new_zeros(shape[:fd[0]] + shape[fd[0] + 1:]))
            v.append(p.new_zeros(1))
        return {"v_row": v_row, "v_col": v_col, "v": v}

    def _rule_(self, params, grads, state, count) -> None:
        device = params[0].device
        lr = self._lr(self.tables(device), count)[0]
        t = (count + 1).to(torch.float32)
        decay = 1.0 - t.pow(-self.DECAY_RATE)
        keep = 1.0 - decay
        # max(rms, min_scale) of each parameter block (a stacked JAX leaf
        # is one block), from the parameters before the update
        # (summed in a fixed order: no atomics, the same bits every replay)
        plan, n_groups = self.plan(params)
        sq: list = [None] * n_groups
        numel = [0] * n_groups
        for p, (_, group) in zip(params, plan):
            s = p.square().sum()
            sq[group] = s if sq[group] is None else sq[group] + s
            numel[group] += p.numel()
        rms = [(s / n).sqrt().clamp_min(self.MIN_SCALE)
               for s, n in zip(sq, numel)]
        for i, (p, g, (fd, group)) in enumerate(zip(params, grads, plan)):
            g2 = g.square().add_(self.FACTOR_EPS)
            if fd is None:
                v = state["v"][i]
                v.mul_(decay).add_(g2.mul_(keep))
                u = g * v.pow(-0.5)
            else:
                d1, d0 = fd
                v_row, v_col = state["v_row"][i], state["v_col"][i]
                v_row.mul_(decay).add_(g2.mean(d0).mul_(keep))
                v_col.mul_(decay).add_(g2.mean(d1).mul_(keep))
                rd1 = d1 - 1 if d1 > d0 else d1
                row = (v_row / v_row.mean(rd1, keepdim=True)).pow(-0.5)
                u = g * row.unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
            u.mul_(lr).mul_(rms[group])
            p.sub_(u)


def make_optimizer(*, lr: float, total_iter: int, final_ratio: float = 0.01,
                   warmup_steps: int = 100, max_grad_norm: float = 0.01,
                   accumulation_steps: int = 1, optimizer: str = "adam",
                   layout: list | None = None) -> Optimizer:
    """`optimizer`: "adam" (the reference recipe), "adam-bf16mu" (Adam with
    a bfloat16 first moment) or "adafactor" (factored second moment, no
    first moment), as the JAX package's `make_optimizer`. `layout`: the
    trained parameters' JAX layout, which only "adafactor" reads
    (`Adafactor`)."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer: {optimizer!r}")
    schedule = iter_exponential(lr, total_iter, final_ratio, warmup_steps)
    kw = dict(schedule_constant_from=max(total_iter, warmup_steps))
    if optimizer == "adafactor":
        return Adafactor(schedule, max_grad_norm, accumulation_steps,
                         layout=layout, **kw)
    if optimizer == "adam-bf16mu":
        kw["mu_dtype"] = torch.bfloat16
    return Optimizer(schedule, max_grad_norm, accumulation_steps, **kw)


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
