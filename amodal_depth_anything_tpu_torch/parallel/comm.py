"""The port's collectives: thin calls on `torch.distributed`, and the
differentiable pairs that tensor, sequence and data parallelism need.

Every helper takes a process group (an axis of the mesh, `parallel/mesh.py`)
and is the identity when the group is None (an axis of one rank), so the
single-card paths pay nothing.

Backends: NCCL takes CUDA tensors and is captured inside CUDA graphs. gloo
runs on the CPU, and takes CUDA tensors only for some collectives; where it
does not (`gloo_cuda_support` probes each once, all ranks together), the
helper stages the tensor through pinned host memory, for gloo only, and
logs that once. gloo has no reduce-scatter: it is an all-reduce and a
slice there. Point-to-point transfers over gloo are always staged.

The differentiable pairs (Megatron's f / g, and the sequence-parallel pair):

  * `copy_to_group`: identity forward, all-reduce backward -- the input of
    a column-parallel layer, whose ranks each see part of the consumers.
  * `reduce_from_group`: all-reduce forward, identity backward -- the
    output of a row-parallel layer, which every rank then uses alike.
  * `gather_seq` / `reduce_scatter_seq`: all-gather forward with a
    reduce-scatter backward, and the reverse: the token stream into and out
    of the matmuls under sequence parallelism.
  * `split_seq` / `gather_seq_replicated`: a replicated stream into its
    rank's slice (backward: all-gather), and the slices back into a
    replicated stream (backward: the rank's slice of the gradient).

`batch_sum(x)`: a sum over the rows of the global batch. Inside
`data_reduction(group)` it adds the data ranks' partial sums, forward and
backward (the gradient of a sum that every rank's rows feed and every
rank's rows use), so that a masked mean, a variance or a batch norm's
statistics equal those of one process holding every row. The loss is then
the same number on every data rank; differentiating it divided by the
number of data ranks gives each rank the gradient of its rows' share, and
the trainer sums those over the data ranks (`train/trainer.py`).
"""

from __future__ import annotations

import contextlib
import logging

import torch
import torch.distributed as dist

__all__ = ["all_reduce_", "all_gather", "reduce_scatter", "broadcast_",
           "send", "recv", "copy_to_group", "reduce_from_group",
           "gather_seq", "reduce_scatter_seq", "split_seq",
           "gather_seq_replicated", "data_reduction", "batch_sum",
           "batch_count", "reduction_group", "gloo_cuda_support"]

LOGGER = logging.getLogger(__name__)

GLOO_PROBED_OPS = ("all_reduce", "broadcast", "all_gather")
_GLOO_CUDA: dict[str, bool] = {}
_STAGING_LOGGED: set = set()
_REDUCTION_GROUP = None


def _is_gloo(group) -> bool:
    return group is not None and dist.get_backend(group) == "gloo"


def gloo_cuda_support(group=None) -> dict[str, bool]:
    """{collective: whether gloo takes CUDA tensors for it} on this build,
    probed once on a tiny CUDA tensor by every rank of `group` (the default
    group when None) together. Send and receive are not probed: gloo takes
    them only from host memory."""
    if not _GLOO_CUDA:
        x = torch.ones(2, device="cuda")
        for op in GLOO_PROBED_OPS:
            try:
                if op == "all_reduce":
                    dist.all_reduce(x, group=group)
                elif op == "broadcast":
                    dist.broadcast(x, src=dist.get_global_rank(group, 0)
                                   if group is not None else 0, group=group)
                else:
                    parts = [torch.empty_like(x) for _ in range(
                        dist.get_world_size(group))]
                    dist.all_gather(parts, x, group=group)
                torch.cuda.synchronize()
                _GLOO_CUDA[op] = True
            except (RuntimeError, ValueError):
                _GLOO_CUDA[op] = False
    return dict(_GLOO_CUDA)


def _staged(op: str, group, x: torch.Tensor) -> bool:
    """Whether `op` on `x` over `group` goes through host memory."""
    if not (x.is_cuda and _is_gloo(group)):
        return False
    if op in GLOO_PROBED_OPS and gloo_cuda_support(group).get(op, False):
        return False
    if op not in _STAGING_LOGGED:
        _STAGING_LOGGED.add(op)
        LOGGER.warning("gloo %s takes no CUDA tensors here: staged through "
                       "pinned host memory (gloo only, never NCCL)", op)
    return True


def _host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return buf.copy_(x)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum `x` over `group`, in place."""
    if group is None:
        return x
    if _staged("all_reduce", group, x):
        h = _host(x)
        dist.all_reduce(h, group=group)
        return x.copy_(h)
    dist.all_reduce(x, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """`x` of global rank `src` into every rank of `group`, in place."""
    if group is None:
        return x
    if _staged("broadcast", group, x):
        h = _host(x)
        dist.broadcast(h, src=src, group=group)
        return x.copy_(h)
    dist.broadcast(x, src=src, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along `dim`, rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    x = x.contiguous()
    if _staged("all_gather", group, x):
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts, dim).to(x.device)
    if _is_gloo(group):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n, 0), dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over `group` of `x`, this rank's 1/n slice along `dim`."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of {x.shape[dim]} rows over "
                         f"{n} ranks")
    if _is_gloo(group):   # gloo has no reduce-scatter
        full = all_reduce_(x.clone(), group)
        return full.narrow(dim, r * (x.shape[dim] // n),
                           x.shape[dim] // n).contiguous()
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // n,) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def send(x: torch.Tensor, dst: int) -> None:
    """Point-to-point to global rank `dst` (default group)."""
    if _staged("send", dist.group.WORLD, x):
        x = _host(x)
    dist.send(x.contiguous(), dst)


def recv(shape, dtype: torch.dtype, device, src: int) -> torch.Tensor:
    """A tensor of `shape` and `dtype` on `device` from global rank `src`
    (default group)."""
    buf = torch.empty(shape, dtype=dtype, device=device)
    if _staged("recv", dist.group.WORLD, buf):
        h = _host(buf)
        dist.recv(h, src)
        return buf.copy_(h)
    dist.recv(buf, src)
    return buf


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad_reduce):
        ctx.group, ctx.dim, ctx.grad_reduce = group, dim, grad_reduce
        ctx.n = x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_reduce:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None, None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"{x.shape[dim]} tokens over {n} ranks")
        step = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * step, step).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to_group(x, group):
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_seq(x, group, dim: int = 1):
    return x if group is None else _GatherSeq.apply(x, group, dim, True)


def gather_seq_replicated(x, group, dim: int = 1):
    return x if group is None else _GatherSeq.apply(x, group, dim, False)


def reduce_scatter_seq(x, group, dim: int = 1):
    return x if group is None else _ReduceScatterSeq.apply(x, group, dim)


def split_seq(x, group, dim: int = 1):
    return x if group is None else _SplitSeq.apply(x, group, dim)


@contextlib.contextmanager
def data_reduction(group):
    """Within: `batch_sum` adds the partial sums of `group`'s ranks."""
    global _REDUCTION_GROUP
    saved, _REDUCTION_GROUP = _REDUCTION_GROUP, group
    try:
        yield
    finally:
        _REDUCTION_GROUP = saved


def reduction_group():
    """The group `batch_sum` reduces over now (None: this rank alone)."""
    return _REDUCTION_GROUP


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """`x`, a sum over this rank's rows, as the sum over the global batch."""
    g = _REDUCTION_GROUP
    return x if g is None else _AllReduceSum.apply(x, g)


def batch_count(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch's extent along `dim` of `x` (this rank's rows), as a
    float32 scalar tensor."""
    n = torch.full((), float(x.shape[dim]), device=x.device)
    return all_reduce_(n, _REDUCTION_GROUP) if _REDUCTION_GROUP is not None \
        else n
