"""The safetensors format, read and written without the `safetensors`
package (which the card's machine may lack).

A file is an 8-byte little-endian header length, a JSON header
{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}} padded with spaces to a multiple of 8 bytes, then the tensors'
raw little-endian bytes, each at its offsets from the end of the header.
`load_file` / `save_file` are the package's `safetensors.torch` calls of the
same names; bfloat16 is read and written bit for bit.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

__all__ = ["load_file", "load_bytes", "save_file", "save_bytes", "DTYPES"]

DTYPES = {"BOOL": torch.bool, "U8": torch.uint8, "I8": torch.int8,
          "I16": torch.int16, "U16": torch.uint16, "I32": torch.int32,
          "U32": torch.uint32, "I64": torch.int64, "U64": torch.uint64,
          "F16": torch.float16, "BF16": torch.bfloat16,
          "F32": torch.float32, "F64": torch.float64}
_NAMES = {v: k for k, v in DTYPES.items()}


def load_bytes(data: bytes) -> dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file's bytes (CPU tensors of their
    own storage)."""
    if len(data) < 8:
        raise ValueError("not a safetensors file: shorter than its header")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError("safetensors header runs past the end of the file")
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unknown safetensors dtype "
                             f"{info['dtype']!r}")
        begin, end = info["data_offsets"]
        shape = [int(d) for d in info["shape"]]
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(body):
            raise ValueError(f"{name}: data offsets do not match its shape")
        raw = torch.frombuffer(bytearray(body[begin:end]), dtype=torch.uint8) \
            if end > begin else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_file(path: str, device: str = "cpu") -> dict[str, torch.Tensor]:
    """{name: tensor} of a .safetensors file, on `device`."""
    with open(path, "rb") as f:
        tensors = load_bytes(f.read())
    return {k: v.to(device) for k, v in tensors.items()}


def save_bytes(tensors: dict[str, torch.Tensor],
               metadata: dict[str, str] | None = None) -> bytes:
    """The safetensors bytes of `tensors` (contiguous copies, in name
    order)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: no safetensors dtype for {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    return struct.pack("<Q", len(head)) + head + b"".join(chunks)


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write `tensors` to `path` as a .safetensors file."""
    with open(path, "wb") as f:
        f.write(save_bytes(tensors, metadata))
