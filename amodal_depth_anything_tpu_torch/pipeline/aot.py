"""Serving programs: one CUDA graph per batch bucket, serialised by
`torch.export`.

Port of the JAX package's `pipeline/aot.py`. There, `jax.export` lowers
each inference pipeline once per static batch bucket and a replica calls
that one compiled program. On the card the in-process counterpart is a
CUDA graph: `capture_amodal_program` and `capture_depthfm_program`
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

A compressed pipeline (`quantize_int8`, ToMe, `head_batch_tile`) captures
as it stands: the int8 products, the dynamic scales (device reductions, no
host sync) and the token merges (fixed shapes, a sorted accumulating
`index_put_` in place of an atomic scatter-add) are ordinary stream work,
so a replay equals its eager call bit for bit.

Serialised programs (`save_amodal_artifact` / `save_depthfm_artifact`,
`ExportedAmodalServing` / `ExportedDepthFMServing`, the JAX package's
surface): `torch.export` traces the same device program per bucket, the
hand-written kernels as the `adat::` custom ops, with the models'
`state_dict()`s as program inputs (`torch.func.functional_call`), so the
artifact -- `meta.json` and one `batch_{N}.pt2` per bucket -- holds no
weights. `meta.json` records the artifact version, the family, buckets,
`hw`, size and dtype, the torch and CUDA versions, the device and kernel
target (`sm_90a`) and a hash of `csrc/`; `load` refuses a mismatch
(`check_platform=False` forces). `bind` takes the states (e.g. of a
pipeline restored from a serving state) and captures each loaded program
as a CUDA graph on the card, or runs it eagerly on the CPU: a replay is
bit-identical to the in-process capture. DepthFM's seeded noise is a
constant of its program, as JAX's in-graph PRNG seed is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import flash_attention, fused_epilogue  # noqa: F401 (adat:: ops)
from ..ops.precision import apply_precision_policy
from ..utils.graphs import capture

__all__ = ["capture_amodal_program", "capture_depthfm_program",
           "CapturedAmodalServing", "CapturedDepthFMServing",
           "depthfm_inputs", "export_amodal_program", "save_amodal_artifact",
           "ExportedAmodalServing", "export_depthfm_program",
           "save_depthfm_artifact", "ExportedDepthFMServing",
           "ARTIFACT_VERSION", "KERNEL_ARCH", "csrc_digest"]

ARTIFACT_VERSION = 1
KERNEL_ARCH = "sm_90a"   # the target `ops/_build.py` compiles csrc/ for

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
        graph, outs = capture(lambda: fn(*inputs), device=device, pool=pool)
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
    host-array surface of the JAX package's `_ExportedServing`.
    `make_fn(b)`: the device program of bucket `b`, a function of its
    inputs (`names`, [b, H, W, c] in `dtype`)."""

    def __init__(self, *, device, dtype, size: int, batches, hw,
                 names: list[str], make_fn, pipeline=None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA graph capture needs a CUDA device and none is "
                "available; build the pipeline with device='cpu' to run "
                "the program eagerly instead")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        if device.type == "cuda":
            from ..parallel.mesh import check_capturable
            check_capturable(getattr(pipeline, "mesh", None),
                             "the serving program")
        self.pipeline = pipeline
        self.device = device
        self._size = int(size)
        self._hw = (int(hw[0]), int(hw[1]))
        self._names = list(names)
        self._lock = threading.Lock()
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" \
            else None
        self.buckets = {}
        with torch.inference_mode():
            for b in sorted({int(x) for x in np.atleast_1d(batches)}):
                inputs = [torch.zeros((b, *self._hw, _channels(n)),
                                      device=device, dtype=dtype)
                          for n in names]
                self.buckets[b] = _Bucket(make_fn(b), inputs, device, pool)

    @property
    def batches(self) -> list[int]:
        return sorted(self.buckets)

    @property
    def size(self) -> int:
        """Output square size: lets the handle drop into surfaces that
        expect a live pipeline (e.g. `cli.serve.build_server`)."""
        return self._size

    @property
    def hw(self) -> tuple[int, int]:
        return self._hw

    def _run(self, arrays: dict) -> list:
        for n in self._names:
            if arrays.get(n) is None:
                raise ValueError(f"this program requires {n} (its "
                                 f"inputs: {self._names})")
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
        (depth,) = self._run({"image": image, "mask": mask,
                              "observation": observation,
                              "guide_rgb": guide_rgb})
        return depth


def _depthfm_fn(pipe, names: list[str], batch: int):
    """DepthFM's device program of one bucket, its seeded noise drawn once
    into a device tensor."""
    noise = pipe.seeded_noise(batch)

    def fn(*inputs):
        given = dict(zip(names, inputs))
        return pipe._generate(given["image"], given.get("mask"),
                              given.get("observation"),
                              given.get("guide_rgb"), noise)
    return fn


def capture_amodal_program(pipe, *, batch, hw: tuple[int, int]
                           ) -> CapturedAmodalServing:
    """`pipe` (an `AmodalDepthPipeline`) captured at each batch of `batch`
    (an int or several) for inputs of height and width `hw`: the
    in-process counterpart of the JAX package's `export_amodal_program`
    plus its replica handle."""
    return CapturedAmodalServing(
        device=pipe.device, dtype=pipe.dtype, size=pipe.size, batches=batch,
        hw=hw, names=["image", "mask"], make_fn=lambda b: pipe._graph,
        pipeline=pipe)


def capture_depthfm_program(pipe, *, batch, hw: tuple[int, int]
                            ) -> CapturedDepthFMServing:
    """`pipe` (a `DepthFMPipeline`) captured at each batch of `batch` for
    inputs of height and width `hw`, its seeded noise drawn once per bucket
    into a static device tensor: the in-process counterpart of the JAX
    package's `export_depthfm_program` plus its replica handle. DeepCache
    and the step count are taken from the pipeline as it is now."""
    names = depthfm_inputs(pipe.cfg)
    return CapturedDepthFMServing(
        device=pipe.device, dtype=pipe.dtype, size=pipe.size, batches=batch,
        hw=hw, names=names, make_fn=lambda b: _depthfm_fn(pipe, names, b),
        pipeline=pipe)


# ------------------------------------------------------ serialised programs

def csrc_digest() -> str:
    """sha256 over the kernel sources (`csrc/`, names and bytes): what an
    artifact's custom ops run is only the same where this is."""
    h = hashlib.sha256()
    csrc = Path(__file__).resolve().parent.parent / "csrc"
    for f in sorted(csrc.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()


def _platform(device: torch.device) -> dict:
    """What a program exported on `device` needs of the host that runs it."""
    return {"device": device.type,
            "arch": KERNEL_ARCH if device.type == "cuda" else None,
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda if device.type == "cuda"
            else None,
            "csrc_sha256": csrc_digest()}


def _weights(model) -> dict:
    """A model's program inputs: its persistent state (parameters and
    buffers, `state_dict()`), detached. The rest (non-persistent buffers
    such as the input normalisation) is part of the program."""
    return {k: v.detach() for k, v in model.state_dict().items()}


def _spec(state: dict) -> dict:
    return {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in state.items()}


class _Program(torch.nn.Module):
    """`graph_fn` over `models`, with every model's persistent state taken
    as an input (`torch.func.functional_call`), so that an export holds no
    weights. The models are not submodules: nothing of them is lifted."""

    def __init__(self, models: dict, graph_fn):
        super().__init__()
        holder = torch.nn.Module()
        for name, model in models.items():
            holder.add_module(name, model)
        holder.forward = graph_fn
        object.__setattr__(self, "_holder", holder)
        self._names = list(models)

    def forward(self, states: dict, *inputs):
        flat = {f"{name}.{k}": v for name in self._names
                for k, v in states[name].items()}
        return torch.func.functional_call(self._holder, flat, inputs,
                                          strict=False)


def _export(program: _Program, states: dict, inputs: list):
    # no Python stack trace on every node: a third of the tracing time,
    # and nothing the replica reads
    fx_config = torch.fx.config
    keep = getattr(fx_config, "do_not_emit_stack_traces", None)
    if keep is not None:
        fx_config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            ep = torch.export.export(program, (states, *inputs),
                                     strict=False)
    finally:
        if keep is not None:
            fx_config.do_not_emit_stack_traces = keep
    ep.example_inputs = None   # they hold the weights: not saved
    return ep


def _input_tensors(pipe, names: list[str], batch: int, hw) -> list:
    return [torch.zeros((batch, int(hw[0]), int(hw[1]), _channels(n)),
                        device=pipe.device, dtype=pipe.dtype) for n in names]


def export_amodal_program(pipe, *, batch: int, hw: tuple[int, int]):
    """`torch.export` the amodal pipeline's device program (the captured
    handle's: resize, both trunks and heads, the blend) at one static
    shape. Returns the `ExportedProgram`, whose signature is
    ``({"raw": raw_state, "amodal": amodal_state}, image[B,H,W,3],
    mask[B,H,W,1]) -> (base[B,S,S], blended[B,S,S])``: the states are the
    two models' `state_dict()`s, in the live pipeline's dtypes (so an int8
    pipeline exports the int8 program), and the hand-written kernels are
    the `adat::` custom ops."""
    program = _Program({"raw": pipe.raw_model, "amodal": pipe.amodal_model},
                       lambda image, mask: pipe._graph(image, mask))
    states = {"raw": _weights(pipe.raw_model),
              "amodal": _weights(pipe.amodal_model)}
    return _export(program, states,
                   _input_tensors(pipe, ["image", "mask"], batch, hw))


def export_depthfm_program(pipe, *, batch: int, hw: tuple[int, int]):
    """`torch.export` DepthFM's amodal-generate program (preprocess -> VAE
    encode -> Euler ODE -> decode) at one static shape. Signature:
    ``({"model": state}, image[B,H,W,3], <guide inputs per
    cfg.guide_type: mask/observation [B,H,W,1], guide_rgb [B,H,W,3]>) ->
    depth [B,S,S]``; the seeded noise, the step count, ToMe and DeepCache
    are baked in from the live pipeline."""
    names = depthfm_inputs(pipe.cfg)
    program = _Program({"model": pipe.model},
                       _depthfm_fn(pipe, names, batch))
    return _export(program, {"model": _weights(pipe.model)},
                   _input_tensors(pipe, names, batch, hw))


def _save(path: str, export_fn, pipe, batches, hw, meta: dict) -> dict:
    os.makedirs(path, exist_ok=True)
    seconds = {}
    for b in batches:
        t0 = time.perf_counter()
        torch.export.save(export_fn(pipe, batch=int(b), hw=hw),
                          os.path.join(path, f"batch_{int(b)}.pt2"))
        seconds[str(int(b))] = time.perf_counter() - t0
    from .serving_ckpt import dtype_name
    meta = {"artifact_version": ARTIFACT_VERSION, **meta,
            **_platform(torch.device(pipe.device)),
            "batches": [int(b) for b in batches],
            "hw": [int(hw[0]), int(hw[1])], "size": int(pipe.size),
            "dtype": dtype_name(pipe.dtype), "export_seconds": seconds}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return meta


def save_amodal_artifact(pipe, path: str, *, batches=(1, 8),
                         hw: tuple[int, int] = (1022, 1022)) -> dict:
    """Write the serving artifact directory: ``meta.json`` plus one
    ``batch_{N}.pt2`` per bucket. No weights: a replica binds them from a
    serving state. Returns the meta dict."""
    return _save(path, export_amodal_program, pipe, batches, hw, {
        "kind": "amodal_serving_program",
        "raw_cfg": dataclasses.asdict(pipe.raw_cfg),
        "amodal_cfg": dataclasses.asdict(pipe.amodal_cfg),
        "inputs": ["image", "mask"],
        "states": {"raw": _spec(_weights(pipe.raw_model)),
                   "amodal": _spec(_weights(pipe.amodal_model))}})


def save_depthfm_artifact(pipe, path: str, *, batches=(1, 8),
                          hw: tuple[int, int] = (512, 512)) -> dict:
    """DepthFM counterpart of `save_amodal_artifact`."""
    return _save(path, export_depthfm_program, pipe, batches, hw, {
        "kind": "depthfm_serving_program",
        "cfg": dataclasses.asdict(pipe.cfg),
        "inputs": depthfm_inputs(pipe.cfg),
        "num_steps": int(pipe.num_steps), "seed": int(pipe.seed),
        "deep_cache": pipe.deep_cache, "tome": pipe.tome,
        "states": {"model": _spec(_weights(pipe.model))}})


class _ExportedServing:
    """Shared replica-side machinery: meta and the per-bucket programs
    (read at `bind`), the platform guard, `bind`. Bound, a handle captures
    each bucket's loaded program as a CUDA graph (on the card) and serves
    it as the captured handles do; subclasses set `_KIND`, `_STATES` and
    `_HANDLE`."""

    _KIND = None
    _STATES: tuple = ()

    def __init__(self, meta: dict, path: str):
        self.meta = meta
        self.path = path
        self.programs: dict = {}   # {batch: ExportedProgram}, read at bind
        self._served = None

    @classmethod
    def load(cls, path: str, *, check_platform: bool = True):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("kind") != cls._KIND:
            raise ValueError(f"{path} holds {meta.get('kind')!r}, "
                             f"expected {cls._KIND!r}")
        if meta.get("artifact_version") != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {meta.get('artifact_version')}"
                             f", this build reads {ARTIFACT_VERSION}")
        if check_platform:
            device = torch.device(meta["device"])
            if device.type == "cuda":
                if not torch.cuda.is_available():
                    raise ValueError("artifact exported for cuda, but this "
                                     "host has no CUDA device "
                                     "(check_platform=False to force)")
                cap = torch.cuda.get_device_capability()
                if f"sm_{cap[0]}{cap[1]}a" != meta["arch"]:
                    raise ValueError(
                        f"artifact exported for {meta['arch']}, but this "
                        f"card is sm_{cap[0]}{cap[1]} "
                        f"(check_platform=False to force)")
            here = _platform(device)
            for key in ("torch_version", "cuda_version", "csrc_sha256"):
                if here[key] != meta[key]:
                    raise ValueError(
                        f"artifact exported for {key} {meta[key]!r}, this "
                        f"host has {here[key]!r} "
                        f"(check_platform=False to force)")
        for b in meta["batches"]:
            if not os.path.exists(os.path.join(path, f"batch_{int(b)}.pt2")):
                raise ValueError(f"{path} lacks the program of bucket {b}")
        return cls(meta, path)

    def _bind(self, states: dict):
        want = self.meta["states"]
        for name in self._STATES:
            got = _spec(states[name])
            if got != want[name]:
                missing = sorted(set(want[name]) ^ set(got))[:3]
                odd = [k for k in want[name] if k in got
                       and got[k] != want[name][k]][:3]
                raise ValueError(f"{name} state does not match the "
                                 f"artifact's inputs (keys only on one "
                                 f"side: {missing}; other shape or dtype: "
                                 f"{odd})")
        # in the export's order: the program flattens its inputs by it
        states = {name: {k: states[name][k] for k in want[name]}
                  for name in self._STATES}
        devices = {v.device for st in states.values() for v in st.values()}
        if len(devices) != 1:
            raise ValueError(f"bind the states on one device, got {devices}")
        (device,) = devices
        from .serving_ckpt import _FLOATS
        dtype = _FLOATS[self.meta["dtype"]]
        apply_precision_policy(dtype)
        for b in self.batches:
            if b not in self.programs:
                self.programs[b] = torch.export.load(
                    os.path.join(self.path, f"batch_{b}.pt2"))
        served = self._HANDLE(
            device=device, dtype=dtype, size=self.meta["size"],
            batches=self.meta["batches"], hw=self.meta["hw"],
            names=self.meta["inputs"],
            make_fn=lambda b: self._bucket_fn(b, states))
        self._served = served
        return self

    def _bucket_fn(self, batch: int, states: dict):
        module = self.programs[batch].module()

        def fn(*inputs):
            return module(states, *inputs)
        return fn

    def _handle(self):
        if self._served is None:
            raise RuntimeError("call .bind(...) before serving")
        return self._served

    @property
    def batches(self) -> list[int]:
        return sorted(int(b) for b in self.meta["batches"])

    @property
    def size(self) -> int:
        """Output square size: lets the handle drop into surfaces that
        expect a live pipeline (e.g. `cli.serve.build_server`)."""
        return int(self.meta["size"])

    @property
    def hw(self) -> tuple[int, int]:
        return tuple(int(x) for x in self.meta["hw"])


class ExportedAmodalServing(_ExportedServing):
    """A replica-side handle: the loaded programs and bound weights.

    ``load(dir)`` -> handle; ``bind(raw_state, amodal_state)`` attaches the
    two models' `state_dict()`s (e.g. of `AmodalDepthPipeline.load_serving`
    or of a serving state's trees through `convert.weights.params_from_jax`)
    on the device to serve on, and captures each bucket's program there;
    calling the bound handle serves the exact-batch program (no padding
    here: front with `MicroBatcher`)."""

    _KIND = "amodal_serving_program"
    _STATES = ("raw", "amodal")
    _HANDLE = CapturedAmodalServing

    def bind(self, raw_state: dict, amodal_state: dict):
        return self._bind({"raw": dict(raw_state),
                           "amodal": dict(amodal_state)})

    def __call__(self, image: np.ndarray, mask: np.ndarray):
        """image [B,H,W,3], mask [B,H,W] or [B,H,W,1]; B a compiled bucket.
        Returns (base, blended) float32 numpy arrays, like
        `AmodalDepthPipeline.__call__`."""
        served = self._handle()
        if image.shape[0] not in served.buckets:
            raise ValueError(f"batch {image.shape[0]} not in compiled "
                             f"buckets {self.batches} (front with "
                             f"MicroBatcher)")
        return served(image, mask)


class ExportedDepthFMServing(_ExportedServing):
    """Replica handle for the generative family: ``load(dir)`` then
    ``bind(state)`` (the model's `state_dict()`, e.g. of
    `DepthFMPipeline.load_serving`). Call it as `DepthFMPipeline.__call__`
    with the guide inputs recorded at export (``meta['inputs']``); returns
    batched amodal depth [B,S,S] in [0,1]."""

    _KIND = "depthfm_serving_program"
    _STATES = ("model",)
    _HANDLE = CapturedDepthFMServing

    def bind(self, state: dict):
        return self._bind({"model": dict(state)})

    def __call__(self, image: np.ndarray, mask: np.ndarray | None = None,
                 observation: np.ndarray | None = None,
                 guide_rgb: np.ndarray | None = None) -> np.ndarray:
        served = self._handle()
        given = {"image": image, "mask": mask, "observation": observation,
                 "guide_rgb": guide_rgb}
        for n in self.meta["inputs"]:
            if given[n] is None:
                raise ValueError(f"artifact requires input {n!r} (exported "
                                 f"guide inputs: {self.meta['inputs']})")
        return served(image, mask, observation, guide_rgb)
