"""CUDA-graph capture of a whole device program.

`capture(fn, pool=...)` runs `fn()` eagerly `warmup` times on a side stream
(the kernel libraries load and set their shared-memory attributes at their
first launch, cuBLAS and cuDNN settle their choices, the autograd engine
starts its device threads), then records one call of `fn()` into a
`torch.cuda.CUDAGraph` and returns (graph, outputs). A replay re-runs the
recorded kernels on the same addresses: `fn` must read its inputs from
tensors the caller keeps and refills in place, and must not copy from
pageable host memory, synchronise or read a device value on the host.
`torch.backends.cudnn.benchmark` stays off, so the algorithm cuDNN picked at
warm-up is the one captured. A program that changes state (a train step)
passes `restore=`, called after the warm-up so that the warm-up leaves no
trace.

Nothing here falls back: a failed capture raises.
"""

from __future__ import annotations

import torch

__all__ = ["capture", "WARMUP_CALLS"]

WARMUP_CALLS = 2   # eager calls on a side stream before each capture


def capture(fn, *, device, pool=None, warmup: int = WARMUP_CALLS,
            restore=None):
    """Warm `fn` up on a side stream, then capture one call of it.
    Returns (graph, what that call returned)."""
    device = torch.device(device)
    if torch.backends.cudnn.benchmark:
        raise RuntimeError("torch.backends.cudnn.benchmark is on: the "
                           "captured algorithm could differ from the eager "
                           "one; turn it off before capturing")
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    if restore is not None:
        restore()
        torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        out = fn()
    torch.cuda.synchronize(device)
    return graph, out
