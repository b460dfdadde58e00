"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain versions.

`mha` runs `csrc/flash_attn_fwd.cu` (the port of the Pallas TPU kernel
`amodal_depth_anything_tpu/ops/flash_attention.py::_attn_fwd_kernel`) on
CUDA tensors and `mha_reference`, plain PyTorch with an f32 softmax, on CPU
tensors. When an input needs a gradient it is a `torch.autograd.Function`
(the JAX `mha` is a `custom_vjp`): the forward keeps the LSE, and the
backward runs the two kernels of `csrc/flash_attn_bwd.cu` (the ports of
`_attn_bwd_dq_kernel` and `_attn_bwd_dkv_kernel`) on CUDA tensors and
`mha_bwd_reference`, the same arithmetic step by step in f32, on CPU
tensors. Nothing else picks between them: a CUDA tensor gets the kernels or
an exception, in both directions. Each backward kernel has its own wrapper
(`flash_attn_bwd_dq`, `flash_attn_bwd_dkv`); `mha.launches`,
`mha.bwd_dq_launches` and `mha.bwd_dkv_launches` count the three kernels'
launches.

Layout [B, H, N, D] as in the JAX package. The kernels take any Nq and Nk
(they mask the ragged edges and keys >= `kv_len` themselves) and float32 or
bfloat16. All three take any head dim up to 160 that is a multiple of 4
(float32) or 8 (bfloat16), the 16-byte vector loads' rule: the DINOv2
trunks' 64 and the SD-1.5 UNet's 40, 80 and 160 among them;
`bwd_instantiations` names the backward kernels a dtype and head dim run.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["mha", "mha_reference", "mha_bwd_reference", "flash_attn_bwd_dq",
           "flash_attn_bwd_dkv", "entry_argtypes", "check_head_dim",
           "kernel_strides",
           "bwd_instantiations", "MAX_HEAD_DIM", "NEG_INF"]

NEG_INF = -1e30  # the JAX package's mask value (avoids inf - inf NaNs)
MAX_HEAD_DIM = 160   # the kernels' widest instantiation
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


def mha_bwd_reference(q, k, v, o, lse, do, *, sm_scale: float | None = None,
                      kv_len: int | None = None):
    """Plain attention backward, the kernels' arithmetic step by step in f32.

    q, o, do: [B,H,Nq,D]; k, v: [B,H,Nk,D]; lse: [B,H,Nq] natural log.
    Returns (dq, dk, dv) in q's, k's and v's dtypes. Keys at index >=
    `kv_len` get P = 0 and zero rows of dk and dv; when Nq == Nk the query
    rows at index >= `kv_len` are padding as well and add nothing to dk, dv."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    nq, nk = q.shape[2], k.shape[2]
    kv_len = nk if kv_len is None else kv_len
    q_len = kv_len if nq == nk else nq
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    # scaled as the forward scales it, so that S and the LSE round alike
    s = torch.einsum("bhqd,bhkd->bhqk", (q * sm_scale).float(), kf)
    p = torch.exp(s - lse.float()[..., None])
    p = p * (torch.arange(nk, device=p.device) < kv_len)
    delta = (dof * o.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    live_q = (torch.arange(nq, device=p.device) < q_len)[:, None]
    live_k = (torch.arange(nk, device=p.device) < kv_len)[:, None]
    dv = torch.einsum("bhqk,bhqd->bhkd", p * live_q, dof) * live_k
    dk = torch.einsum("bhqk,bhqd->bhkd", ds * live_q, qf) * sm_scale * live_k
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_head_dim(d: int, dtype) -> None:
    """Raise unless the kernels take head dim `d` for `dtype`: at most
    MAX_HEAD_DIM and a multiple of the 16-byte vector (4 float32, 8
    bfloat16 elements)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if d % vec or not vec <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"the attention kernels take a head dim that is a multiple of "
            f"{vec} for {dtype} (16-byte vector loads) and at most "
            f"{MAX_HEAD_DIM}, got {d}")


def bwd_instantiations(dtype, d: int) -> tuple[str, str]:
    """The (dQ, dK/dV) kernel instantiations `csrc/flash_attn_bwd.cu` runs
    for `dtype` and head dim `d` (its fixed table)."""
    check_head_dim(d, dtype)
    if dtype == torch.bfloat16 and d <= 64:
        kind = f"bf16_wgmma<{-(-d // 16)}>"
    else:
        pad = next(p for p in (16, 32, 48, 64, 80, 160) if d <= p)
        kind = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}<{pad}>"
    return f"flash_attn_bwd_dq_{kind}", f"flash_attn_bwd_dkv_{kind}"


def _check(q, k, v, kv_len):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the attention kernels take float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,H,Nq,D] and k, v [B,H,Nk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head dim")
    check_head_dim(d, q.dtype)
    if not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[2]}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _vector_ready(t):
            raise ValueError(
                f"{name} needs a contiguous head dim, (batch, head, token) "
                f"strides that are multiples of {16 // t.element_size()} and "
                f"16-byte alignment, got strides {t.stride()}")


def kernel_strides(t) -> tuple[int, int, int]:
    """The (batch, head, token) strides of a [B,H,N,D] tensor as the kernels
    take them. A dimension of size 1 is never stepped along, and torch may
    give it any stride (k and v made from a one-token context, for one);
    the TMA tensor maps still need every stride a multiple of 16 bytes, so
    such a stride is replaced by the extent of the other dimensions (a
    multiple of 16 bytes whenever their strides and the head dim are). The
    other strides are passed as they are."""
    dims = list(zip(t.stride()[:3], t.shape[:3]))
    extent = max([t.shape[-1]] + [st * n for st, n in dims if n > 1])
    return tuple(st if n > 1 else extent for st, n in dims)


def _vector_ready(t) -> bool:
    """The kernels move 16-byte vectors along a contiguous head dim."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % vec for s in kernel_strides(t))
            and t.data_ptr() % 16 == 0)


# C entry point -> (library under csrc/, pointer arguments, int arguments)
_ENTRIES = {"flash_attn_fwd": ("flash_attn_fwd", 5, 5),
            "flash_attn_bwd_dq": ("flash_attn_bwd", 7, 5),
            "flash_attn_bwd_dkv": ("flash_attn_bwd", 8, 7)}


def entry_argtypes(name: str) -> list:
    """The ctypes signature of C entry point `name`: (dtype, pointers...,
    ints..., sm_scale, strides, [lse strides], stream), every pointer and
    the stream as c_void_p."""
    _, n_ptrs, n_ints = _ENTRIES[name]
    lse_strides = [ctypes.c_longlong] * 2 if name == "flash_attn_fwd" else []
    return ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_void_p]
            + lse_strides + [ctypes.c_void_p])


def _entry(name: str):
    """C entry point `name` of its csrc/<library>.cu (built at first use)."""
    from ._build import load

    fn = getattr(load(_ENTRIES[name][0]), name)
    if fn.argtypes is None:
        fn.argtypes = entry_argtypes(name)
        fn.restype = ctypes.c_int
    return fn


def _strides(*tensors):
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in kernel_strides(t)))


def _token_major(b, h, n, d, like):
    """An empty [B,H,N,D] view of a [B,N,H,D] buffer, so that
    `t.transpose(1, 2).reshape(B, N, H*D)` is free."""
    return torch.empty((b, n, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _launch_fwd(q, k, v, sm_scale: float, kv_len: int | None, need_lse: bool):
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check(q, k, v, kv_len)
    b, h, nq, d = q.shape
    o = _token_major(b, h, nq, d, q)
    lse = (torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
           if need_lse else None)
    fn = _entry("flash_attn_fwd")
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), None if lse is None else lse.data_ptr(),
                 b, h, nq, kv_len, d, float(sm_scale), _strides(q, k, v, o),
                 0 if lse is None else lse.stride(0),
                 0 if lse is None else lse.stride(1),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    mha.launches += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta, kv_len: int):
    _check(q, k, v, kv_len)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO must match q: got {tuple(do.shape)} {do.dtype} "
                         f"on {do.device}")
    if not _vector_ready(do):
        raise ValueError(f"dO needs a contiguous head dim and 16-byte "
                         f"aligned rows, got strides {do.stride()}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous float32 [B,H,Nq] on "
                             f"q's device, got {tuple(t.shape)} {t.dtype}")


def flash_attn_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float,
                      kv_len: int | None = None):
    """dQ = sm_scale * dS K by the `flash_attn_bwd_dq` kernel (CUDA tensors
    only). `lse`: the forward's natural-log LSE; `delta` = rowsum(dO * O);
    both contiguous float32 [B,H,Nq]."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    b, h, nq, d = q.shape
    dq = _token_major(b, h, nq, d, q)
    fn = _entry("flash_attn_bwd_dq")
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), b, h, nq, kv_len, d, float(sm_scale),
                 _strides(q, k, v, do, dq),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed: cudaError {err}")
    mha.bwd_dq_launches += 1
    return dq


def flash_attn_bwd_dkv(q, k, v, do, lse, delta, *, sm_scale: float,
                       kv_len: int | None = None):
    """dV = P^T dO and dK = sm_scale * dS^T Q by the `flash_attn_bwd_dkv`
    kernel (CUDA tensors only); arguments as `flash_attn_bwd_dq`. Rows at
    index >= kv_len come back as zeros, and when Nq == Nk the query rows
    at index >= kv_len are left out of the sums."""
    nq, nk = q.shape[2], k.shape[2]
    kv_len = nk if kv_len is None else int(kv_len)
    q_len = kv_len if nq == nk else nq
    _check_bwd(q, k, v, do, lse, delta, kv_len)
    b, h, _, d = q.shape
    dk = _token_major(b, h, nk, d, k)
    dv = _token_major(b, h, nk, d, v)
    fn = _entry("flash_attn_bwd_dkv")
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, q_len, kv_len,
                 d, float(sm_scale), _strides(q, k, v, do, dk, dv),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attn_bwd_dkv launch failed: cudaError {err}")
    mha.bwd_dkv_launches += 1
    return dk, dv


def _launch_bwd(q, k, v, o, lse, do, sm_scale: float, kv_len: int | None):
    if not _vector_ready(do):
        # whatever view autograd handed over: an explicit copy, never the
        # plain version
        do = do.contiguous()
    # outside the kernels, as in the JAX package: delta = rowsum(dO * O), f32
    delta = (do.float() * o.float()).sum(-1)
    lse = lse.contiguous()
    dq = flash_attn_bwd_dq(q, k, v, do, lse, delta, sm_scale=sm_scale,
                           kv_len=kv_len)
    dk, dv = flash_attn_bwd_dkv(q, k, v, do, lse, delta, sm_scale=sm_scale,
                                kv_len=kv_len)
    return dq, dk, dv


class _Mha(torch.autograd.Function):
    """Differentiable attention: kernels for CUDA tensors, the plain
    versions (`mha_reference`, `mha_bwd_reference`) for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, kv_len, residuals):
        if residuals:  # a recompute pass: the forward ran already
            o, lse = residuals["o"].detach(), residuals["lse"].detach()
        else:
            if q.is_cuda:
                o, lse = _launch_fwd(q, k, v, sm_scale, kv_len, True)
            else:
                o, lse = mha_reference(q, k, v, sm_scale=sm_scale,
                                       kv_len=kv_len, return_lse=True)
            if residuals is not None:
                residuals.update(o=o.detach(), lse=lse.detach())
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.kv_len = sm_scale, kv_len
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, ctx.sm_scale,
                                     ctx.kv_len)
        else:
            dq, dk, dv = mha_bwd_reference(q, k, v, o, lse, do,
                                           sm_scale=ctx.sm_scale,
                                           kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None


def mha(q, k, v, *, sm_scale: float | None = None, kv_len: int | None = None,
        return_lse: bool = False, residuals: dict | None = None):
    """Multi-head attention, q: [B,H,Nq,D], k/v: [B,H,Nk,D] -> [B,H,Nq,D].

    `kv_len`: keys at index >= kv_len are excluded (default Nk); their dk
    and dv are zero, and when Nq == Nk the query rows at index >= kv_len
    are padding too (they must carry zero cotangents).
    `return_lse`: also return the natural-log LSE per row, [B,H,Nq] f32.
    `residuals`: a dict the caller keeps across a recompute of the
    surrounding block. Empty, it receives the output and the LSE of this
    call; filled, the forward is not run again and the gradient flows
    through the kept pair (the JAX package's "attn_out"/"attn_lse"
    checkpoint names). Only read when a gradient is needed.

    CUDA tensors launch the kernels; the output is a [B,H,Nq,D] view of a
    [B,Nq,H,D] buffer, so `o.transpose(1, 2).reshape(B, Nq, H*D)` is free.
    CPU tensors take the plain versions. When no input needs a gradient the
    forward skips the LSE unless `return_lse` asks for it."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o, lse = _Mha.apply(q, k, v, float(sm_scale), kv_len, residuals)
    elif q.is_cuda:
        o, lse = _launch_fwd(q, k, v, sm_scale, kv_len, return_lse)
    else:
        return mha_reference(q, k, v, sm_scale=sm_scale, kv_len=kv_len,
                             return_lse=return_lse)
    return (o, lse) if return_lse else o


mha.launches = 0
mha.bwd_dq_launches = 0
mha.bwd_dkv_launches = 0
