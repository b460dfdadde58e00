"""Sharding rules: where each parameter and each batch row lives on the mesh.

Port of the JAX package's `parallel/sharding.py`. There the rules are
NamedShardings and XLA's partitioner inserts the collectives; here
`param_sharding` gives a `Placement` per parameter, `shard_params` cuts a
model that holds its full weights down to this rank's pieces, and the
modules run their collectives themselves (`models/layers.py`,
`parallel/comm.py`).

Data parallelism: batches split on axis 0 over ``data``; parameters
replicate. Tensor parallelism (``model`` axis > 1) splits the ViT trunk's
blocks Megatron-style. Torch weights are [out, in]:

  * attention qkv weight [3D, D] (bias [3D]) -> dim 0, column-parallel
  * attention proj weight [D, D]             -> dim 1, row-parallel
  * mlp fc1 / w12 weight [H, D] (bias [H])   -> dim 0, column-parallel
  * mlp fc2 / w3 weight [D, H]               -> dim 1, row-parallel

Whole heads per rank: qkv's 3D rows are q, k and v one after the other,
and each is split by heads (rank r holds q_r, k_r, v_r), and w12's two
halves (`SwiGLUFFNFused` chunks them) are each split, so that every rank
runs the attention kernel on whole heads and the SwiGLU on matching
halves. A model axis that does not divide the heads or the hidden width
raises ValueError. (The JAX package splits the concatenated axis in
contiguous blocks, which its partitioner keeps exact for any split.)
Everything else replicates; the DPT heads are batch-bound.

FSDP (`fsdp=True`): ZeRO-3 over ``data``. Every leaf of at least
`FSDP_MIN_ELEMENTS` (counted on the JAX leaf, a ViT block's tensors
stacked [L, ...]) keeps a 1/data slice on each rank along the JAX rule's
axis: the largest free one that the data size divides, on the JAX
package's layout (`convert.weights.jax_param_layout`), never the stacked
layer axis. `shard_params` makes each such parameter a slice and the
module reads it through an all-gather at every use (its gradient is
reduce-scattered back onto the slice), so parameters, gradients and the
optimizer state the trainer keeps per parameter are 1/data a rank.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn as nn

from . import comm
from .mesh import axis_group, axis_rank, axis_size

__all__ = ["Placement", "param_sharding", "batch_sharding", "replicate",
           "shard_params", "shard_batch", "shard_tensor", "unshard_tensor",
           "FSDP_MIN_ELEMENTS", "seq_partial"]

# (name pattern, dim of the torch weight, equal parts split within) -- the
# first match wins. The patterns name the trunk's blocks
# (`models/layers.py`), as the JAX rules do ("blocks.attn.qkv.w", ...).
_TP_RULES: tuple[tuple[str, int, int], ...] = (
    (r"blocks\.\d+\.attn\.qkv\.(weight|bias)$", 0, 3),
    (r"blocks\.\d+\.attn\.proj\.weight$", 1, 1),
    (r"blocks\.\d+\.mlp\.fc1\.(weight|bias)$", 0, 1),
    (r"blocks\.\d+\.mlp\.fc2\.weight$", 1, 1),
    (r"blocks\.\d+\.mlp\.w12\.(weight|bias)$", 0, 2),
    (r"blocks\.\d+\.mlp\.w3\.weight$", 1, 1),
)

# block parameters that act on the token slices under sequence
# parallelism: their gradients are partial sums over the model ranks
_SEQ_PARTIAL = re.compile(
    r"blocks\.\d+\.(norm1|norm2|ls1|ls2)\.|"
    r"blocks\.\d+\.(attn\.proj|mlp\.fc2|mlp\.w3)\.bias$")

# Leaves smaller than this replicate even under FSDP: gathering a few-KB
# norm scale costs more in collective latency than the memory it saves.
FSDP_MIN_ELEMENTS = 2 ** 16


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter's pieces live: `spec[d]` names the mesh axis that
    splits torch dim d ("model", "data") or None. `parts`: the model dim
    holds this many equal parts, each split across the model ranks (q, k, v
    of qkv: 3; w12's halves: 2)."""
    spec: tuple
    parts: int = 1

    def dim(self, axis: str) -> int | None:
        return self.spec.index(axis) if axis in self.spec else None

    @property
    def replicated(self) -> bool:
        return all(s is None for s in self.spec)


def seq_partial(name: str) -> bool:
    """Whether parameter `name`'s gradient is a partial sum over the model
    ranks under sequence parallelism (all-reduced by the trainer)."""
    return bool(_SEQ_PARTIAL.search(name))


def _tp_rule(name: str):
    for pattern, dim, parts in _TP_RULES:
        if re.search(pattern, name):
            return dim, parts
    return None


def _layout(model: nn.Module) -> dict:
    from ..convert.weights import jax_param_layout
    return jax_param_layout(model)


def _fsdp_dim(shape, spec, jax_dims, stack_len: int,
              data_size: int) -> int | None:
    """The JAX `_fsdp_extend` rule on the JAX layout, as a torch dim."""
    numel = int(np.prod(shape)) * stack_len
    if numel < FSDP_MIN_ELEMENTS or data_size <= 1:
        return None
    order = list(range(len(shape))) if jax_dims is None else list(jax_dims)
    candidates = [d for d in order
                  if spec[d] is None and shape[d] % data_size == 0]
    if not candidates:
        return None
    return max(candidates, key=lambda d: shape[d])


def param_sharding(mesh, model: nn.Module, *,
                   tensor_parallel: bool | None = None,
                   fsdp: bool = False) -> dict[str, Placement]:
    """{parameter name: Placement} for `model`'s full-size parameters.

    The TP rules apply iff the mesh's model axis is > 1 (or when asked);
    `fsdp=True` adds the data axis on every large enough leaf: a qkv weight
    [3D, D] on a 4 x 2 mesh gets ("model", "data")."""
    tp = axis_size(mesh, "model") > 1 if tensor_parallel is None \
        else tensor_parallel
    data_size = axis_size(mesh, "data")
    layout = _layout(model) if fsdp else {}
    stacks: dict = {}
    for dims, stack in layout.values():
        if stack is not None:
            stacks[stack] = stacks.get(stack, 0) + 1
    out = {}
    for name, p in model.named_parameters():
        spec = [None] * p.ndim
        parts = 1
        rule = _tp_rule(name) if tp else None
        if rule is not None:
            spec[rule[0]], parts = "model", rule[1]
        if fsdp:
            dims, stack = layout.get(name, (None, None))
            d = _fsdp_dim(tuple(p.shape), spec, dims,
                          stacks.get(stack, 1) if stack is not None else 1,
                          data_size)
            if d is not None:
                spec[d] = "data"
        out[name] = Placement(tuple(spec), parts)
    return out


def replicate() -> Placement:
    return Placement(())


def _check_divides(name, size, n, what):
    if size % n:
        raise ValueError(f"{name}: the model axis ({n}) does not divide "
                         f"the {what} ({size})")


def shard_tensor(t: torch.Tensor, placement: Placement, mesh) -> torch.Tensor:
    """This rank's piece of the full tensor `t`."""
    d = placement.dim("model")
    if d is not None:
        n, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
        k = placement.parts
        parts = t.unflatten(d, (k, t.shape[d] // k))
        step = parts.shape[d + 1] // n
        t = parts.narrow(d + 1, r * step, step).flatten(d, d + 1)
    d = placement.dim("data")
    if d is not None:
        n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")
        step = t.shape[d] // n
        t = t.narrow(d, r * step, step)
    return t.contiguous()


def unshard_tensor(t: torch.Tensor, placement: Placement, mesh) -> torch.Tensor:
    """The full tensor from this rank's piece `t` (every rank calls it)."""
    d = placement.dim("data")
    if d is not None:
        t = comm.all_gather(t, axis_group(mesh, "data"), d)
    d = placement.dim("model")
    if d is not None:
        n, k = axis_size(mesh, "model"), placement.parts
        full = comm.all_gather(t, axis_group(mesh, "model"), d)
        # [n ranks x k parts x piece] -> [k parts x n ranks x piece]
        full = full.unflatten(d, (n, k, t.shape[d] // k))
        t = full.transpose(d, d + 1).flatten(d, d + 2)
    return t.contiguous()


class _GatherParam(torch.autograd.Function):
    """A data-sharded parameter read whole: all-gather forward, its
    gradient reduce-scattered (summed over the data ranks) back."""

    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return comm.all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, g):
        return comm.reduce_scatter(g.contiguous(), ctx.group, ctx.dim), \
            None, None


def _fsdp_class(cls, names: tuple[str, ...]):
    """A subclass of `cls` whose parameters `names` read as the all-gather
    of the slice registered under the same name."""
    def prop(name):
        def get(self):
            shard = self._parameters[name]
            group, dim = self._fsdp[name]
            return _GatherParam.apply(shard, group, dim)
        return property(get)
    return type(f"FSDP{cls.__name__}", (cls,),
                {n: prop(n) for n in names})


def _set_tp(model: nn.Module, mesh, group) -> None:
    """Tell the trunk's attention and FFN modules that they hold this
    rank's heads and hidden units, checking that the model axis divides
    them."""
    from ..models.layers import Attention, Mlp, SwiGLUFFNFused
    n = axis_size(mesh, "model")
    for name, m in model.named_modules():
        if not re.search(r"blocks\.\d+\.(attn|mlp)$", name):
            continue
        if isinstance(m, Attention):
            _check_divides(name, m.num_heads, n, "attention heads")
            m.num_heads //= n
        elif isinstance(m, (Mlp, SwiGLUFFNFused)):
            hidden = (m.fc1 if isinstance(m, Mlp) else m.w3).weight.shape
            _check_divides(name, hidden[0 if isinstance(m, Mlp) else 1], n,
                           "hidden width")
        else:
            continue
        m.tp_group = group


@torch.no_grad()
def shard_params(mesh, model: nn.Module, *,
                 tensor_parallel: bool | None = None,
                 fsdp: bool = False) -> dict[str, Placement]:
    """Cut `model`, which holds its full weights (loaded, drawn or carried
    across from the JAX package by `convert/weights.py`), down to this
    rank's pieces, in place; returns the placements (`param_sharding`).
    Tensor-parallel modules then run on their heads and hidden units;
    data-sharded parameters are read through an all-gather. A model this
    call already cut for `mesh` with the same request is left as it is
    (its placements are returned); one cut for another mesh or another
    request raises ValueError."""
    tp = axis_size(mesh, "model") > 1 if tensor_parallel is None \
        else bool(tensor_parallel)
    request = (mesh, tp, bool(fsdp))
    done = getattr(model, "_placements", None)
    if done is not None and not all(p.replicated for p in done.values()):
        cut_mesh, cut_tp, cut_fsdp = model._placements_request
        if cut_mesh is not mesh:
            raise ValueError("the model is already sharded over another "
                             "mesh; shard a model that holds its full "
                             "weights")
        if (cut_tp, cut_fsdp) != request[1:]:
            raise ValueError(
                f"the model is already sharded with tensor_parallel="
                f"{cut_tp}, fsdp={cut_fsdp}; this call asks for "
                f"tensor_parallel={tp}, fsdp={bool(fsdp)}: shard a model "
                f"that holds its full weights")
        return done
    placements = param_sharding(mesh, model, tensor_parallel=tp, fsdp=fsdp)
    if any(p.dim("model") is not None for p in placements.values()):
        _set_tp(model, mesh, axis_group(mesh, "model"))
    fsdp_names: dict[nn.Module, list] = {}
    modules = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        pl = placements[name]
        if pl.replicated:
            continue
        owner, _, attr = name.rpartition(".")
        m = modules[owner]
        piece = nn.Parameter(shard_tensor(p.data, pl, mesh),
                             requires_grad=p.requires_grad)
        m._parameters[attr] = piece
        if pl.dim("data") is not None:
            fsdp_names.setdefault(m, []).append((attr, pl.dim("data")))
    group = axis_group(mesh, "data")
    for m, entries in fsdp_names.items():
        m._fsdp = {attr: (group, d) for attr, d in entries}
        m.__class__ = _fsdp_class(type(m), tuple(a for a, _ in entries))
    model._placements, model._placements_request = placements, request
    return placements


def batch_sharding(mesh) -> tuple[int, int]:
    """(this rank's index, number of pieces) of the batch over ``data``."""
    return axis_rank(mesh, "data"), axis_size(mesh, "data")


def shard_batch(mesh, batch):
    """This rank's rows of a global batch (a tensor, array or dict of
    them): rows [r * B / D, (r + 1) * B / D) of the data axis's D ranks."""
    r, n = batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if n == 1 or not hasattr(batch, "shape") or not batch.shape:
        return batch
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} does not divide over "
                         f"{n} data ranks")
    step = batch.shape[0] // n
    return batch[r * step:(r + 1) * step]
