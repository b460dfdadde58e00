"""Flash-attention forward: the hand-written Hopper kernel and its plain version.

`mha` runs `csrc/flash_attn_fwd.cu` (the port of the Pallas TPU kernel
`amodal_depth_anything_tpu/ops/flash_attention.py::_attn_fwd_kernel`) on
CUDA tensors and `mha_reference`, plain PyTorch with an f32 softmax, on CPU
tensors. Nothing else picks between them: a CUDA tensor gets the kernel or
an exception. `mha.launches` counts the kernel's launches.

Layout [B, H, N, D] as in the JAX package. The kernel takes any N (it
masks the ragged query edge and keys >= `kv_len` itself), head dim 64, and
float32 or bfloat16.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["mha", "mha_reference", "HEAD_DIM", "NEG_INF"]

NEG_INF = -1e30  # the JAX package's mask value (avoids inf - inf NaNs)
HEAD_DIM = 64    # every DINOv2 preset on the main path
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, *, sm_scale: float | None = None,
                  kv_len: int | None = None, return_lse: bool = False):
    """Plain attention; q: [B,H,Nq,D], k/v: [B,H,Nk,D]. f32 softmax.

    Returns O in q's dtype, and with `return_lse` also the natural-log
    log-sum-exp of each query row's scaled scores, [B,H,Nq] float32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", (q * sm_scale).float(), k.float())
    if kv_len is not None and kv_len < k.shape[2]:
        col = torch.arange(k.shape[2], device=s.device)
        s = s.masked_fill(col >= kv_len, NEG_INF)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.float())
    o = o.to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def _check(q, k, v, kv_len):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attn_fwd takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,Nq,D] and k, v [B,H,Nk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head dim")
    if d != HEAD_DIM:
        raise ValueError(f"flash_attn_fwd takes head dim {HEAD_DIM}, got {d}")
    if not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[2]}]")
    vec = 16 // q.element_size()  # the kernel moves 16-byte vectors
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous head dim and strides "
                             f"that are multiples of {vec}, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _kernel():
    """The C entry point of csrc/flash_attn_fwd.cu (built at first use)."""
    from ._build import load

    fn = load("flash_attn_fwd").flash_attn_fwd
    if fn.argtypes is None:  # every pointer and the stream as c_void_p
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def mha(q, k, v, *, sm_scale: float | None = None, kv_len: int | None = None,
        return_lse: bool = False):
    """Multi-head attention, q: [B,H,Nq,D], k/v: [B,H,Nk,D] -> [B,H,Nq,D].

    `kv_len`: keys at index >= kv_len are excluded (default Nk).
    `return_lse`: also return the natural-log LSE per row, [B,H,Nq] f32.

    CUDA tensors launch the kernel; the output is a [B,H,Nq,D] view of a
    [B,Nq,H,D] buffer, so `o.transpose(1, 2).reshape(B, Nq, H*D)` is free.
    CPU tensors take `mha_reference`."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return mha_reference(q, k, v, sm_scale=sm_scale, kv_len=kv_len,
                             return_lse=return_lse)
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    b, h, nq, d = q.shape
    o = torch.empty((b, nq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), None if lse is None else lse.data_ptr(),
                 b, h, nq, kv_len, float(sm_scale), strides,
                 0 if lse is None else lse.stride(0),
                 0 if lse is None else lse.stride(1),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    mha.launches += 1
    return (o, lse) if return_lse else o


mha.launches = 0
