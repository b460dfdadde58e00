"""Flash attention, forward and backward: the hand-written Hopper kernels
and their plain versions, as `torch.library` custom ops.

Three ops of the `adat` namespace carry the kernels:
`adat::flash_attn_fwd` runs `csrc/flash_attn_fwd.cu` (the port of the Pallas
TPU kernel `amodal_depth_anything_tpu/ops/flash_attention.py::
_attn_fwd_kernel`), `adat::flash_attn_bwd_dq` and `adat::flash_attn_bwd_dkv`
the two kernels of `csrc/flash_attn_bwd.cu` (the ports of
`_attn_bwd_dq_kernel` and `_attn_bwd_dkv_kernel`). Each op's CUDA
implementation is its kernel and its CPU implementation the plain version
(`mha_reference`, and the backward's arithmetic step by step in f32): the
dispatcher picks by the tensors' device, so a CUDA tensor gets the kernel or
an exception. Each op has a fake implementation, so `torch.export` and
CUDA-graph capture trace through it. The forward op's gradient is
registered with `register_autograd` and runs the two backward ops (the JAX
`mha` is a `custom_vjp`). `mha.launches`, `mha.bwd_dq_launches` and
`mha.bwd_dkv_launches` count the three kernels' launches from Python: at
eager calls, warm-ups and captures, never at a graph's replay.

The ops return their outputs token-major, [B,N,H,D] contiguous; the Python
wrappers (`mha`, `flash_attn_bwd_dq`, `flash_attn_bwd_dkv`) hand out the
[B,H,N,D] views, so `o.transpose(1, 2).reshape(B, N, H*D)` is free.

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


def _bwd_plain(q, k, v, do, lse, delta, sm_scale: float, kv_len: int,
               want_dq: bool, want_dkv: bool):
    """The backward kernels' arithmetic step by step in f32: (dq or None,
    dk or None, dv or None) in q's, k's and v's dtypes."""
    nq, nk = q.shape[2], k.shape[2]
    q_len = kv_len if nq == nk else nq
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    # scaled as the forward scales it, so that S and the LSE round alike
    s = torch.einsum("bhqd,bhkd->bhqk", (q * sm_scale).float(), kf)
    p = torch.exp(s - lse.float()[..., None])
    p = p * (torch.arange(nk, device=p.device) < kv_len)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = dk = dv = None
    if want_dq:
        dq = (torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale).to(q.dtype)
    if want_dkv:
        live_q = (torch.arange(nq, device=p.device) < q_len)[:, None]
        live_k = (torch.arange(nk, device=p.device) < kv_len)[:, None]
        dv = torch.einsum("bhqk,bhqd->bhkd", p * live_q, dof) * live_k
        dk = torch.einsum("bhqk,bhqd->bhkd", ds * live_q,
                          qf) * sm_scale * live_k
        dk, dv = dk.to(k.dtype), dv.to(v.dtype)
    return dq, dk, dv


def mha_bwd_reference(q, k, v, o, lse, do, *, sm_scale: float | None = None,
                      kv_len: int | None = None):
    """Plain attention backward, the kernels' arithmetic step by step in f32.

    q, o, do: [B,H,Nq,D]; k, v: [B,H,Nk,D]; lse: [B,H,Nq] natural log.
    Returns (dq, dk, dv) in q's, k's and v's dtypes. Keys at index >=
    `kv_len` get P = 0 and zero rows of dk and dv; when Nq == Nk the query
    rows at index >= `kv_len` are padding as well and add nothing to dk, dv."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    kv_len = k.shape[2] if kv_len is None else kv_len
    delta = (do.float() * o.float()).sum(-1)
    return _bwd_plain(q, k, v, do, lse, delta, sm_scale, kv_len, True, True)


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


def _launch_fwd(q, k, v, sm_scale: float, kv_len: int, need_lse: bool):
    """The forward kernel: (o [B,Nq,H,D], lse [B,H,Nq] or empty)."""
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
    if lse is None:
        lse = _no_lse(q)
    return o.transpose(1, 2), lse


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


def _launch_bwd_dq(q, k, v, do, lse, delta, sm_scale: float, kv_len: int):
    """The dQ kernel: dq [B,Nq,H,D]."""
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
    return dq.transpose(1, 2)


def _launch_bwd_dkv(q, k, v, do, lse, delta, sm_scale: float, kv_len: int):
    """The dK/dV kernel: (dk, dv) [B,Nk,H,D]."""
    nq, nk = q.shape[2], k.shape[2]
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
    return dk.transpose(1, 2), dv.transpose(1, 2)


# --------------------------------------------------------------- the ops
# Each op: the plain version as its CPU implementation, the kernel as its
# CUDA one, a fake implementation for tracing. Ops return token-major
# [B,N,H,D] buffers; the wrappers below view them as [B,H,N,D].

def _no_lse(q):
    return q.new_empty((0,), dtype=torch.float32)


def _tokens(t):
    """[B,H,N,D] -> the [B,N,H,D] buffer an op returns (contiguous)."""
    return t.transpose(1, 2).contiguous()


@torch.library.custom_op("adat::flash_attn_fwd", mutates_args=(),
                         device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            sm_scale: float, kv_len: int,
            need_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if need_lse:
        o, lse = mha_reference(q, k, v, sm_scale=sm_scale, kv_len=kv_len,
                               return_lse=True)
    else:
        o = mha_reference(q, k, v, sm_scale=sm_scale, kv_len=kv_len)
        lse = _no_lse(q)
    return _tokens(o), lse


@_fwd_op.register_kernel("cuda")
def _(q, k, v, sm_scale, kv_len, need_lse):
    return _launch_fwd(q, k, v, sm_scale, kv_len, need_lse)


@_fwd_op.register_fake
def _(q, k, v, sm_scale, kv_len, need_lse):
    b, h, nq, d = q.shape
    lse = (q.new_empty((b, h, nq), dtype=torch.float32) if need_lse
           else _no_lse(q))
    return q.new_empty((b, nq, h, d)), lse


@torch.library.custom_op("adat::flash_attn_bwd_dq", mutates_args=(),
                         device_types="cpu")
def _bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
               sm_scale: float, kv_len: int) -> torch.Tensor:
    dq, _, _ = _bwd_plain(q, k, v, do, lse, delta, sm_scale, kv_len,
                          True, False)
    return _tokens(dq)


@_bwd_dq_op.register_kernel("cuda")
def _(q, k, v, do, lse, delta, sm_scale, kv_len):
    return _launch_bwd_dq(q, k, v, do, lse, delta, sm_scale, kv_len)


@_bwd_dq_op.register_fake
def _(q, k, v, do, lse, delta, sm_scale, kv_len):
    b, h, nq, d = q.shape
    return q.new_empty((b, nq, h, d))


@torch.library.custom_op("adat::flash_attn_bwd_dkv", mutates_args=(),
                         device_types="cpu")
def _bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                sm_scale: float,
                kv_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    _, dk, dv = _bwd_plain(q, k, v, do, lse, delta, sm_scale, kv_len,
                           False, True)
    return _tokens(dk), _tokens(dv)


@_bwd_dkv_op.register_kernel("cuda")
def _(q, k, v, do, lse, delta, sm_scale, kv_len):
    return _launch_bwd_dkv(q, k, v, do, lse, delta, sm_scale, kv_len)


@_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, delta, sm_scale, kv_len):
    b, h, nk, d = k.shape
    return k.new_empty((b, nk, h, d)), v.new_empty((b, nk, h, d))


def _kv_len(k, kv_len) -> int:
    return k.shape[2] if kv_len is None else int(kv_len)


def flash_attn_bwd_dq(q, k, v, do, lse, delta, *, sm_scale: float,
                      kv_len: int | None = None):
    """dQ = sm_scale * dS K, `adat::flash_attn_bwd_dq`: the kernel on CUDA
    tensors, the plain version on CPU tensors. `lse`: the forward's
    natural-log LSE; `delta` = rowsum(dO * O); both contiguous float32
    [B,H,Nq]. Returns a [B,H,Nq,D] view of a [B,Nq,H,D] buffer."""
    return torch.ops.adat.flash_attn_bwd_dq(
        q, k, v, do, lse, delta, float(sm_scale),
        _kv_len(k, kv_len)).transpose(1, 2)


def flash_attn_bwd_dkv(q, k, v, do, lse, delta, *, sm_scale: float,
                       kv_len: int | None = None):
    """dV = P^T dO and dK = sm_scale * dS^T Q, `adat::flash_attn_bwd_dkv`;
    arguments as `flash_attn_bwd_dq`. Rows at index >= kv_len come back as
    zeros, and when Nq == Nk the query rows at index >= kv_len are left out
    of the sums."""
    dk, dv = torch.ops.adat.flash_attn_bwd_dkv(
        q, k, v, do, lse, delta, float(sm_scale), _kv_len(k, kv_len))
    return dk.transpose(1, 2), dv.transpose(1, 2)


def _attn_backward(q, k, v, o, lse, do, sm_scale: float, kv_len: int):
    """(dq, dk, dv) through the two backward ops."""
    if q.is_cuda and not _vector_ready(do):
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


def _fwd_setup(ctx, inputs, output):
    q, k, v, sm_scale, kv_len, need_lse = inputs
    if not need_lse:
        raise RuntimeError("adat::flash_attn_fwd differentiates only with "
                           "need_lse=True (the backward reads the LSE)")
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.sm_scale, ctx.kv_len = sm_scale, kv_len


def _fwd_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _attn_backward(q, k, v, o.transpose(1, 2), lse,
                                do.transpose(1, 2), ctx.sm_scale, ctx.kv_len)
    return dq, dk, dv, None, None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


class _Kept(torch.autograd.Function):
    """The recompute pass of a block that kept its attention output and LSE
    (`residuals`): the forward is not run again, and the gradient flows
    through the kept pair by the same two backward ops. It saves what the
    forward op saved (the token-major output among them), as the recompute
    of `torch.utils.checkpoint` requires."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, kv_len, residuals):
        o, lse = residuals["o"], residuals["lse"]
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.kv_len = sm_scale, kv_len
        return o

    @staticmethod
    def backward(ctx, do):
        return _fwd_backward(ctx, do, None)


def mha(q, k, v, *, sm_scale: float | None = None, kv_len: int | None = None,
        return_lse: bool = False, residuals: dict | None = None):
    """Multi-head attention, q: [B,H,Nq,D], k/v: [B,H,Nk,D] -> [B,H,Nq,D],
    through `adat::flash_attn_fwd` (the kernel on CUDA tensors, the plain
    version on CPU tensors), differentiable through the two backward ops.

    `kv_len`: keys at index >= kv_len are excluded (default Nk); their dk
    and dv are zero, and when Nq == Nk the query rows at index >= kv_len
    are padding too (they must carry zero cotangents).
    `return_lse`: also return the natural-log LSE per row, [B,H,Nq] f32.
    `residuals`: a dict the caller keeps across a recompute of the
    surrounding block. Empty, it receives the output and the LSE of this
    call; filled, the forward is not run again and the gradient flows
    through the kept pair (the JAX package's "attn_out"/"attn_lse"
    checkpoint names). Only read when a gradient is needed.

    The output is a [B,H,Nq,D] view of a [B,Nq,H,D] buffer, so
    `o.transpose(1, 2).reshape(B, Nq, H*D)` is free. When no input needs a
    gradient the forward skips the LSE unless `return_lse` asks for it."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    sm_scale, kv_len = float(sm_scale), _kv_len(k, kv_len)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if grad and residuals:   # a recompute pass: the forward ran already
        o = _Kept.apply(q, k, v, sm_scale, kv_len, residuals).transpose(1, 2)
        return (o, residuals["lse"]) if return_lse else o
    o, lse = torch.ops.adat.flash_attn_fwd(q, k, v, sm_scale, kv_len,
                                           grad or return_lse)
    if grad and residuals is not None:
        residuals.update(o=o.detach(), lse=lse.detach())
    o = o.transpose(1, 2)
    return (o, lse) if return_lse else o


mha.launches = 0
mha.bwd_dq_launches = 0
mha.bwd_dkv_launches = 0
