"""Pipeline parallelism for the ViT trunk: a GPipe schedule over the mesh's
``pipe`` ranks, on point-to-point sends and receives.

Port of the JAX package's `parallel/pipeline.py`. Stage s of S holds blocks
[s L/S, (s + 1) L/S); the batch splits into M microbatches that stream
through the stages, one hop at a time, so the schedule spans M + S - 1
ticks: rank 0 takes microbatch m at tick m, rank s at tick m + s. Each rank
walks its microbatches in order -- receive from s - 1 (rank 0: take the
microbatch), run the stage, send to s + 1 -- and the blocking transfers
give the ticks their order.

The backward pass is pipelined backprop, as `jax.grad` of the JAX scan is:
the receive of an activation is an autograd node whose backward sends the
activation's gradient back to s - 1, and the send is one whose backward
receives the gradient from s + 1. The autograd engine runs the nodes in
reverse creation order, so every rank walks its microbatches backwards and
the transfers pair up. `loss.backward()` then leaves each block's gradient
on the rank of its stage (zero elsewhere; `reduce_stage_grads` sums them
over the pipe ranks) and the gradient of the input tokens on every rank.

Taps (the DPT head needs four depths): each tap depth lives on one stage,
which banks the activation after that block; at the end the final output
(from the last stage) and each tap (from its stage) are broadcast to every
pipe rank, as the JAX `psum` of the masked banks replicates them. The
batch stays split over ``data`` (each data rank pipelines its own rows);
FSDP of the stage weights is not composed, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import comm
from .mesh import axis_group, axis_rank, axis_size

__all__ = ["pipeline_vit_blocks", "pipeline_spec", "stage_params",
           "reduce_stage_grads"]


def pipeline_spec(depth: int, n_stages: int) -> int:
    """Layers per stage; depth must split evenly (contiguous stages)."""
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    return depth // n_stages


def stage_params(blocks, n_stages: int) -> list[list]:
    """The blocks (a sequence of modules or tensors) in S contiguous
    stages of L/S each."""
    blocks = list(blocks)
    lp = pipeline_spec(len(blocks), n_stages)
    return [blocks[s * lp:(s + 1) * lp] for s in range(n_stages)]


class _Recv(torch.autograd.Function):
    """Receive an activation from `src`; backward sends its gradient back."""

    @staticmethod
    def forward(ctx, anchor, like, src):
        ctx.src = src
        return comm.recv(like.shape, like.dtype, like.device, src)

    @staticmethod
    def backward(ctx, g):
        comm.send(g.contiguous(), ctx.src)
        return None, None, None


class _Send(torch.autograd.Function):
    """Send an activation to `dst`; returns a 0-d token for the graph, whose
    backward receives the activation's gradient from `dst`."""

    @staticmethod
    def forward(ctx, x, dst):
        ctx.dst, ctx.meta = dst, (x.shape, x.dtype, x.device)
        comm.send(x, dst)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return comm.recv(*ctx.meta, ctx.dst), None


class _Broadcast(torch.autograd.Function):
    """`x` of global rank `src` to every rank of `group`. Every rank uses
    the result alike, so the gradient is the source's own."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.owner = dist.get_rank() == src
        return comm.broadcast_(x.detach().clone(), src, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.owner else torch.zeros_like(g)), None, None


class _PipeIn(torch.autograd.Function):
    """The tokens into the pipeline: rank 0 consumes them, so their
    gradient, there alone, is summed to every pipe rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_(g.contiguous().clone(), ctx.group), None


def _run_stage(blocks, x, block_fn, tap_locals):
    """The stage's blocks on x; (out, {local index: activation})."""
    taps = {}
    for i, blk in enumerate(blocks):
        x = block_fn(blk, x)
        if i in tap_locals:
            taps[i] = x
    return x, taps


def pipeline_vit_blocks(blocks, tokens: torch.Tensor, block_fn, *, mesh,
                        n_microbatches: int, taps: tuple[int, ...] = (),
                        axis: str = "pipe", batch_axis: str | None = "data"):
    """Run the ViT blocks as a GPipe pipeline over the mesh's `axis`.

    blocks: the trunk's L block modules (every rank holds them; stage s
    runs its L/S); tokens: [B, N, D], this data rank's rows, B divisible
    by `n_microbatches`; block_fn: (block, x) -> x; taps: global block
    indices whose outputs to return. `batch_axis`: the axis the rows are
    split over, which each data rank pipelines alone (the JAX spec's
    batch axis).

    Returns (final [B, N, D], [tap outputs [B, N, D] in `taps` order]),
    replicated over the pipe ranks. A mesh whose `axis` has one rank runs
    the blocks in order."""
    del batch_axis  # the data ranks hold their own rows already
    blocks = list(blocks)
    n_stages = axis_size(mesh, axis)
    lp = pipeline_spec(len(blocks), n_stages)
    b = tokens.shape[0]
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by {m} microbatches")
    taps = tuple(taps)
    if n_stages == 1:
        out, banks = _run_stage(blocks, tokens, block_fn, set(taps))
        return out, [banks[t] for t in taps]

    group = axis_group(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    s = axis_rank(mesh, axis)
    prev = ranks[s - 1] if s > 0 else None
    nxt = ranks[s + 1] if s < n_stages - 1 else None
    mine = blocks[s * lp:(s + 1) * lp]
    my_taps = {t - s * lp for t in taps if t // lp == s}

    pin = _PipeIn.apply(tokens, group)
    x_mb = pin.chunk(m, 0)
    anchor = tokens.new_zeros((), requires_grad=torch.is_grad_enabled())
    outs, tokens_out = [], []
    tap_banks = {t: [] for t in my_taps}
    for i in range(m):
        x = x_mb[i] if prev is None else _Recv.apply(anchor, x_mb[i], prev)
        y, stage_taps = _run_stage(mine, x, block_fn, my_taps)
        for t, v in stage_taps.items():
            tap_banks[t].append(v)
        if nxt is None:
            outs.append(y)
        else:
            tokens_out.append(_Send.apply(y, nxt))

    def replicated(owner: int, parts):
        """The concatenated banks of stage `owner`, broadcast over pipe.
        The send tokens and the input join the graph here on every rank, so
        that the backward runs every send's gradient receive and the
        input's all-reduce (last, as the input was made first)."""
        if s == owner:
            local = torch.cat(parts, 0)
        else:
            local = torch.zeros_like(tokens)
        for tok in tokens_out + [pin.flatten()[:1].sum()]:
            local = local + tok * 0
        return _Broadcast.apply(local, ranks[owner], group)

    out = replicated(n_stages - 1, outs)
    tap_outs = [replicated(t // lp, tap_banks.get(t - s * lp, []))
                for t in taps]
    return out, tap_outs


@torch.no_grad()
def reduce_stage_grads(blocks, mesh, axis: str = "pipe") -> None:
    """After a pipelined backward: each block's gradients, held by its
    stage's rank, summed onto every pipe rank (in place, `.grad`)."""
    group = axis_group(mesh, axis)
    if group is None:
        return
    for blk in blocks:
        for p in blk.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            comm.all_reduce_(p.grad, group)
