"""Captured serving programs: one CUDA graph per batch bucket.

Port of the serving half of the JAX package's `pipeline/aot.py`. There,
`jax.export` lowers each inference pipeline once per static batch bucket
and a replica calls that one compiled program. On the card the counterpart
is a CUDA graph: `capture_amodal_program` and `capture_depthfm_program`
run the pipeline's device program (`amodal_depth_graph`, `depthfm_generate`
with its preprocessing) once per bucket under stream capture, and a call
replays it. A replay launches the whole program, every hand-written
attention kernel included, without one Python dispatch or one launch from
the host per op.

Each bucket holds static device inputs and outputs, pinned host buffers
for the copies in and out, and its graph. A call copies the host arrays
into the pinned buffers and on to the static inputs, replays the graph on
the calling thread's current stream, copies the outputs back and returns
numpy arrays, exactly as the eager `__call__` does. Capture comes after an
eager warm-up on a side stream (the kernel libraries load and set their
attributes, cuDNN and cuBLAS settle their choices), under
`torch.inference_mode()`. Buckets of one handle share one graph memory
pool: a handle serialises its calls, and behind `MicroBatcher` its single
dispatch thread makes every replay. Static buckets are the contract: front
a handle with `pipeline.server.MicroBatcher`, which pads every request
stream to the bucket.

DepthFM's q_sample noise is drawn on the host from `seed` at every eager
call. The seed is fixed, so every call draws the same noise: each bucket
draws it once before capture into a static device tensor
(`DepthFMPipeline.seeded_noise`) and the replay equals the eager call.

There is no fallback. A handle of a pipeline on "cuda" captures or raises;
a failed capture or replay raises. Only a pipeline the caller built on
"cpu" gives a handle that runs the same program eagerly, bucket by bucket.

The kernel wrappers count launches in Python (`mha.launches`), so they
count at warm-up and capture, never at a replay; the graph's kernel nodes
show in a `torch.profiler` trace.

Not ported: the serialised programs (`save_*_artifact`,
`Exported*Serving.load`), a `torch.export` job.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["capture_amodal_program", "capture_depthfm_program",
           "CapturedAmodalServing", "CapturedDepthFMServing",
           "depthfm_inputs"]

WARMUP_CALLS = 2   # eager calls on a side stream before each capture


def depthfm_inputs(cfg) -> list[str]:
    """The inputs a DepthFM program of `cfg.guide_type` takes, in order."""
    g = cfg.guide_type
    names = ["image"]
    if "mask" in g:
        names.append("mask")
    if "observation" in g:
        names.append("observation")
    if "image" in g:
        names.append("guide_rgb")
    return names


def _channels(name: str) -> int:
    return 3 if name in ("image", "guide_rgb") else 1


class _Bucket:
    """One batch bucket: the program over static device inputs, and on the
    card its graph, static outputs and pinned host buffers."""

    def __init__(self, fn, inputs: list, device: torch.device, pool):
        self.fn, self.inputs = fn, inputs
        self.graph = None
        if device.type != "cuda":
            return
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            outs = fn(*inputs)
        torch.cuda.synchronize(device)
        self.graph = graph
        self.outputs = outs if isinstance(outs, tuple) else (outs,)
        self.host_in = [torch.empty(t.shape, dtype=torch.float32,
                                    pin_memory=True) for t in inputs]
        self.host_out = [torch.empty(t.shape, dtype=torch.float32,
                                     pin_memory=True) for t in self.outputs]

    def __call__(self, arrays: list) -> list:
        if self.graph is None:   # on the CPU, by the caller's request
            for static, a in zip(self.inputs, arrays):
                static.copy_(torch.from_numpy(a))
            outs = self.fn(*self.inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            return [o.numpy() for o in outs]
        for host, static, a in zip(self.host_in, self.inputs, arrays):
            host.numpy()[...] = a
            static.copy_(host, non_blocking=True)
        self.graph.replay()
        for host, out in zip(self.host_out, self.outputs):
            host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.inputs[0].device).synchronize()
        return [host.numpy().copy() for host in self.host_out]


class _CapturedServing:
    """Shared handle machinery: one `_Bucket` per batch, bucket lookup, the
    host-array surface of the JAX package's `_ExportedServing`."""

    def __init__(self, pipe, batches, hw, names: list[str], make_fn):
        device = torch.device(pipe.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA graph capture needs a CUDA device and none is "
                "available; build the pipeline with device='cpu' to run "
                "the program eagerly instead")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.pipeline = pipe
        self.device = device
        self._hw = (int(hw[0]), int(hw[1]))
        self._names = names
        self._lock = threading.Lock()
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" \
            else None
        self.buckets = {}
        with torch.inference_mode():
            for b in sorted({int(x) for x in np.atleast_1d(batches)}):
                inputs = [torch.zeros((b, *self._hw, _channels(n)),
                                      device=device, dtype=pipe.dtype)
                          for n in names]
                self.buckets[b] = _Bucket(make_fn(b), inputs, device, pool)

    @property
    def batches(self) -> list[int]:
        return sorted(self.buckets)

    @property
    def size(self) -> int:
        """Output square size: lets the handle drop into surfaces that
        expect a live pipeline (e.g. `cli.serve.build_server`)."""
        return int(self.pipeline.size)

    @property
    def hw(self) -> tuple[int, int]:
        return self._hw

    def _run(self, arrays: dict) -> list:
        batch = arrays[self._names[0]].shape[0]
        if batch not in self.buckets:
            raise ValueError(f"batch {batch} not in compiled buckets "
                             f"{self.batches} (front with MicroBatcher)")
        ordered = []
        for n in self._names:
            want = (batch, *self._hw, _channels(n))
            a = np.asarray(arrays[n], np.float32)
            if a.ndim == 3 and _channels(n) == 1:
                a = a[..., None]
            if a.shape != want:
                raise ValueError(f"{n} has shape {a.shape}, the program was "
                                 f"captured for {want}")
            ordered.append(a)
        with self._lock, torch.inference_mode():
            return self.buckets[batch](ordered)


class CapturedAmodalServing(_CapturedServing):
    """The amodal pipeline's program captured per batch bucket. Call it as
    `AmodalDepthPipeline.__call__` on batched host arrays: image [B,H,W,3]
    in [0,255], mask [B,H,W] or [B,H,W,1], B a bucket and (H, W) = `hw`.
    Returns (base, blended) float32 numpy arrays [B,S,S]."""

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        base, blended = self._run({"image": image, "mask": mask})
        return base, blended


class CapturedDepthFMServing(_CapturedServing):
    """The DepthFM pipeline's program captured per batch bucket. Call it as
    `DepthFMPipeline.__call__` with the guide inputs its config takes
    (`depthfm_inputs`), batched, (H, W) = `hw`. Returns amodal depth
    [B,S,S] float32 in [0,1]."""

    def __call__(self, image: np.ndarray, mask: np.ndarray | None = None,
                 observation: np.ndarray | None = None,
                 guide_rgb: np.ndarray | None = None) -> np.ndarray:
        given = {"image": image, "mask": mask, "observation": observation,
                 "guide_rgb": guide_rgb}
        for n in self._names:
            if given[n] is None:
                raise ValueError(f"guide_type "
                                 f"{self.pipeline.cfg.guide_type!r} "
                                 f"requires {n}")
        (depth,) = self._run(given)
        return depth


def capture_amodal_program(pipe, *, batch, hw: tuple[int, int]
                           ) -> CapturedAmodalServing:
    """`pipe` (an `AmodalDepthPipeline`) captured at each batch of `batch`
    (an int or several) for inputs of height and width `hw`: the
    counterpart of the JAX package's `export_amodal_program` plus its
    replica handle."""
    return CapturedAmodalServing(pipe, batch, hw, ["image", "mask"],
                                 lambda b: pipe._graph)


def capture_depthfm_program(pipe, *, batch, hw: tuple[int, int]
                            ) -> CapturedDepthFMServing:
    """`pipe` (a `DepthFMPipeline`) captured at each batch of `batch` for
    inputs of height and width `hw`, its seeded noise drawn once per bucket
    into a static device tensor: the counterpart of the JAX package's
    `export_depthfm_program` plus its replica handle. DeepCache and the
    step count are taken from the pipeline as it is now."""
    names = depthfm_inputs(pipe.cfg)

    def make_fn(b):
        noise = pipe.seeded_noise(b)

        def fn(*inputs):
            given = dict(zip(names, inputs))
            return pipe._generate(given["image"], given.get("mask"),
                                  given.get("observation"),
                                  given.get("guide_rgb"), noise)
        return fn

    return CapturedDepthFMServing(pipe, batch, hw, names, make_fn)
