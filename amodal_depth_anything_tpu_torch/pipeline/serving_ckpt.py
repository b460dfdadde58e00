"""Serving-state checkpoints: persist a READY-TO-SERVE pipeline.

Port of the JAX package's `pipeline/serving_ckpt.py`, on its flat sidecar
format, so that one serving state feeds both packages:

  <path>/flat/plan.json      leaf keys + (chunk, offset, size, shape, dtype)
  <path>/flat/chunk_<i>.bin  raw concatenated same-dtype leaf bytes
  <path>/serving_meta.json   pipeline kind + configs + runtime knobs

Leaf keys stay in the JAX package's layout ("raw/...", "amodal/...",
"params/..."; blocks stacked [L, ...], linear weights [in, out], convs HWIO):
the pipelines map them through `convert.weights` (`params_to_jax` and
back). The JAX package restores a state written here through its flat path;
the port writes no Orbax `params/` directory, and reads only the flat
sidecar. numpy and torch only: a bfloat16 chunk is read as uint16 and
viewed as `torch.bfloat16`. Dtypes are kept exactly, with no cast.

Compressed states (`quantize_int8` of either package) hold int8 codes,
int32 `w4_group` and bool `use_q` leaves beside float32 scale leaves
(`w_scale`, `act_scale`, `smooth`, `w4_scale`) in a state of another
compute dtype; the ToMe and `head_batch_tile` knobs ride in the meta. Both
packages read both.

On the card, `restore_serving_state` copies each chunk to the device
through two pinned host buffers that take turns (the next chunk is read
from disk while the previous one is still on its way), the counterpart of
the JAX package's `bulk_to_device`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

__all__ = ["save_serving_state", "restore_serving_state", "cfg_from_dict",
           "flatten_tree", "unflatten_tree", "attn_impl_to_jax",
           "attn_impl_from_jax", "dtype_name", "serving_dtype",
           "refuse_quantized", "CHUNK_BYTES"]

_META = "serving_meta.json"
_FLAT = "flat"
# the JAX package's chunk size; a leaf larger than a chunk gets one alone
CHUNK_BYTES = 64 * 1024 * 1024
# bytes a pinned staging buffer moves per host-to-device copy
_STAGE_BYTES = 64 * 1024 * 1024

# dtype name in plan.json (numpy's, and ml_dtypes' for bfloat16) <-> torch:
# the floating dtypes a pipeline serves in, and the quantised layers'
# codes, group sizes and per-layer masks
_FLOATS = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}
_DTYPES = {**_FLOATS, "int8": torch.int8, "int32": torch.int32,
           "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
# float32 leaves of a quantised layer, in a state of any compute dtype
_SCALE_LEAVES = ("w_scale", "act_scale", "smooth", "w4_scale")

# attention impl names: the port's <-> the JAX package's
_IMPL_TO_JAX = {None: None, "kernel": "pallas", "plain": "xla"}
_IMPL_FROM_JAX = {v: k for k, v in _IMPL_TO_JAX.items()}


def attn_impl_to_jax(impl: str | None) -> str | None:
    """The port's attention impl ("kernel" / "plain" / None) under the JAX
    package's name ("pallas" / "xla" / None)."""
    return _IMPL_TO_JAX[impl]


def attn_impl_from_jax(impl: str | None) -> str | None:
    """The inverse of `attn_impl_to_jax`."""
    if impl not in _IMPL_FROM_JAX:
        raise ValueError(f"unknown attention impl in serving state: {impl!r}")
    return _IMPL_FROM_JAX[impl]


def dtype_name(dtype: torch.dtype) -> str:
    """A compute dtype under the JAX package's name ("float32", ...)."""
    return _NAMES[dtype]


def serving_dtype(meta: dict, trees: dict) -> torch.dtype:
    """The compute dtype of a restored state: its meta's, which every
    floating leaf but a quantised layer's scales must have (a pipeline
    casts nothing it restores)."""
    dtype = _FLOATS[meta["dtype"]]
    for key, leaf in flatten_tree(trees).items():
        if key.rpartition("/")[2] in _SCALE_LEAVES:
            continue
        if leaf.is_floating_point() and leaf.dtype != dtype:
            raise ValueError(f"leaf {key!r} is {leaf.dtype} in a "
                             f"{meta['dtype']} serving state")
    return dtype


def cfg_from_dict(cls, d: dict):
    """Rebuild a flat config dataclass from its JSON dict (tuples come back
    as lists: coerce; unknown keys are ignored so configs can grow)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in d.items() if k in names}
    return cls(**kw)


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": leaf}, keys in the JAX package's flatten
    order (sorted at every level)."""
    flat = {}
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            flat.update(flatten_tree(tree[k], key + "/"))
        else:
            flat[key] = tree[k]
    return flat


def unflatten_tree(flat: dict) -> dict:
    """The inverse of `flatten_tree`."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _plan(leaves: list, chunk_bytes: int):
    """Pack leaves, in order, into same-dtype chunks of <= chunk_bytes (the
    JAX package's `_plan`). Returns (plans, chunk_dtypes): plans[i] =
    (chunk, offset, size, shape) in elements."""
    plans, chunk_dtypes, open_chunks = [], [], {}
    for leaf in leaves:
        dt = leaf.dtype
        per = max(1, chunk_bytes // leaf.element_size())
        cur = open_chunks.get(dt)
        if cur is None or cur[1] + leaf.numel() > per:
            chunk_dtypes.append(dt)
            cur = open_chunks[dt] = [len(chunk_dtypes) - 1, 0]
        plans.append((cur[0], cur[1], leaf.numel(), tuple(leaf.shape)))
        cur[1] += leaf.numel()
    return plans, chunk_dtypes


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a chunk of `name` is read as (bfloat16 as uint16)."""
    return np.dtype("uint16") if name == "bfloat16" else np.dtype(name)


def save_serving_state(path: str, trees: dict, meta: dict) -> None:
    """trees: {name: nested dict of tensors (or numpy arrays) in the JAX
    layout}; meta: JSON-able construction info, with "kind".

    Writes the flat sidecar and the meta, each file through a temporary
    name and an atomic rename."""
    flat = {k: torch.as_tensor(v).detach()
            for k, v in flatten_tree(trees).items()}
    for key, leaf in flat.items():
        if leaf.dtype not in _NAMES:
            raise ValueError(f"leaf {key!r} has dtype {leaf.dtype}, which "
                             f"a serving state cannot hold")
    keys = list(flat)
    leaves = [flat[k] for k in keys]
    plans, chunk_dtypes = _plan(leaves, CHUNK_BYTES)
    flat_dir = os.path.join(os.path.abspath(path), _FLAT)
    os.makedirs(flat_dir, exist_ok=True)
    for cid, dt in enumerate(chunk_dtypes):
        parts = [leaf.reshape(-1).cpu() for leaf, p in zip(leaves, plans)
                 if p[0] == cid]
        buf = torch.cat(parts) if len(parts) > 1 else parts[0]
        tmp = os.path.join(flat_dir, f"chunk_{cid}.bin.tmp")
        with open(tmp, "wb") as f:
            # bytes as they lie in memory (little-endian, as numpy writes)
            buf.contiguous().view(torch.uint8).numpy().tofile(f)
        os.replace(tmp, os.path.join(flat_dir, f"chunk_{cid}.bin"))
    plan_doc = {
        "chunks": [{"file": f"chunk_{c}.bin", "dtype": _NAMES[dt]}
                   for c, dt in enumerate(chunk_dtypes)],
        "leaves": [{"key": k, "cid": p[0], "off": p[1], "size": p[2],
                    "shape": list(p[3]), "dtype": _NAMES[leaf.dtype]}
                   for k, p, leaf in zip(keys, plans, leaves)],
    }
    _write_json(os.path.join(flat_dir, "plan.json"), plan_doc)
    _write_json(os.path.join(os.path.abspath(path), _META), meta, indent=1)


def _write_json(path: str, doc: dict, indent=None) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=indent)
    os.replace(tmp, path)


def refuse_quantized(path: str, trees: dict, why: str) -> None:
    """NotImplementedError if `trees` hold a quantised layer's int8 codes
    (for a consumer whose compression is not ported; `why` says so)."""
    quant = [k for k, v in flatten_tree(trees).items()
             if v.dtype == torch.int8]
    if quant:
        raise NotImplementedError(f"{path} holds quantised leaves "
                                  f"({quant[0]}, ...): {why}")


def _read_chunks(flat_dir: str, doc: dict, device: torch.device) -> list:
    """Every chunk as a 1-D tensor of its dtype on `device`. On the card the
    bytes go through two pinned staging buffers that take turns: the copy
    out of one runs while the next piece is read from disk into the
    other."""
    chunks = []
    if device.type != "cuda":
        for c in doc["chunks"]:
            raw = np.fromfile(os.path.join(flat_dir, c["file"]),
                              dtype=_storage_dtype(c["dtype"]))
            chunks.append(torch.from_numpy(raw).view(_DTYPES[c["dtype"]]))
        return chunks
    stages = [torch.empty(_STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
              for _ in range(2)]
    done = [None, None]
    turn = 0
    stream = torch.cuda.current_stream(device)
    for c in doc["chunks"]:
        fname = os.path.join(flat_dir, c["file"])
        nbytes = os.path.getsize(fname)
        out = torch.empty(nbytes, dtype=torch.uint8, device=device)
        with open(fname, "rb") as f:
            for start in range(0, nbytes, _STAGE_BYTES):
                n = min(_STAGE_BYTES, nbytes - start)
                if done[turn] is not None:
                    done[turn].synchronize()   # its last copy has landed
                stage = stages[turn][:n]
                if f.readinto(memoryview(stage.numpy())) != n:
                    raise OSError(f"{fname}: short read")
                out[start:start + n].copy_(stage, non_blocking=True)
                done[turn] = torch.cuda.Event()
                done[turn].record(stream)
                turn ^= 1
        chunks.append(out.view(_DTYPES[c["dtype"]]))
    stream.synchronize()
    return chunks


def restore_serving_state(path: str, *, expect_kind: str, device="cuda"):
    """-> (trees, meta): trees as nested dicts of tensors on `device` in the
    JAX layout, each leaf in its own allocation with its saved dtype (no
    cast). Refuses a state of another kind (ValueError)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    kind = meta.get("kind")
    if kind != expect_kind:
        raise ValueError(f"{path} holds a {kind!r} serving state, "
                         f"expected {expect_kind!r}")
    flat_dir = os.path.join(path, _FLAT)
    plan = os.path.join(flat_dir, "plan.json")
    if not os.path.exists(plan):
        raise FileNotFoundError(
            f"{path} has no flat sidecar ({_FLAT}/plan.json); the torch "
            f"pipelines read only that format")
    with open(plan) as f:
        doc = json.load(f)
    for le in doc["leaves"]:
        if le["dtype"] not in _DTYPES:
            raise ValueError(f"leaf {le['key']!r} has dtype {le['dtype']}, "
                             f"which the port does not read")
    chunks = _read_chunks(flat_dir, doc, torch.device(device))
    flat = {}
    for le in doc["leaves"]:
        chunk = chunks[le["cid"]]
        if chunk.dtype != _DTYPES[le["dtype"]]:
            raise ValueError(f"leaf {le['key']!r} is {le['dtype']} in a "
                             f"{_NAMES[chunk.dtype]} chunk")
        flat[le["key"]] = chunk[le["off"]:le["off"] + le["size"]].reshape(
            le["shape"]).clone()
    return unflatten_tree(flat), meta
