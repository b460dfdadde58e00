"""Fused matmul + LayerScale + residual: the hand-written Hopper kernel and
its plain version.

`matmul_scale_residual(x, w, b, gamma, resid)` computes
`resid + gamma * (x @ w + b)`, the epilogue of a trunk block's `proj` and
`fc2` linears. On CUDA tensors it runs `csrc/fused_epilogue.cu` (the port of
the Pallas TPU kernel `amodal_depth_anything_tpu/ops/fused_epilogue.py::
_kernel`): the product, bias, gamma and the residual in one kernel, float32
accumulation, one rounding to x's dtype. On CPU tensors it takes
`matmul_scale_residual_reference`, the chain in plain PyTorch. Nothing else
picks between them: a CUDA tensor gets the kernel or an exception.
`matmul_scale_residual.launches` counts the kernel's launches.

As in the JAX package the kernel is wired into no model: its path is the A/B
of `chip_smoke.py` (single shapes and a four-block chain) against the
library chain, whose times say whether a block should use it.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["matmul_scale_residual", "matmul_scale_residual_reference",
           "fused_epilogue_kernel", "entry_argtypes"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def matmul_scale_residual_reference(x, w, b, gamma, resid):
    """resid + gamma * (x @ w + b), op by op in x's dtype: the chain the
    kernel replaces. x: [M,K]; w: [K,N]; b, gamma: [N]; resid: [M,N]."""
    y = x @ w.to(x.dtype)
    y = y + b.to(x.dtype)
    return resid + gamma.to(x.dtype) * y


def _check(x, w, b, gamma, resid):
    if not x.is_cuda or any(t.device != x.device
                            for t in (w, b, gamma, resid)):
        raise ValueError("the fused epilogue kernel needs x, w, b, gamma and "
                         "resid on one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or resid.dtype != x.dtype:
        raise ValueError(f"the fused epilogue kernel takes float32 or "
                         f"bfloat16 x, w and resid of one dtype, got "
                         f"{x.dtype}/{w.dtype}/{resid.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x [M,K] and w [K,N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if resid.shape != (m, n) or b.shape != (n,) or gamma.shape != (n,):
        raise ValueError(f"expected resid [{m},{n}] and b, gamma [{n}], got "
                         f"{tuple(resid.shape)}, {tuple(b.shape)}, "
                         f"{tuple(gamma.shape)}")
    if m < 1 or k % 8 or n % 8 or k < 8 or n < 8:
        raise ValueError(f"the fused epilogue kernel needs K and N that are "
                         f"multiples of 8 (16-byte vector loads), got "
                         f"K={k}, N={n}")
    for name, t in (("x", x), ("w", w), ("resid", resid)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned, "
                             f"got strides {t.stride()}")


def entry_argtypes() -> list:
    """The ctypes signature of the C entry point `fused_epilogue`: (dtype,
    x, w, bias, gamma, resid, out, m, k, n, stream), every pointer and the
    stream as c_void_p."""
    return ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])


def fused_epilogue_kernel(x, w, b, gamma, resid):
    """The kernel itself (CUDA tensors only; raises on anything else)."""
    _check(x, w, b, gamma, resid)
    from ._build import load

    fn = load("fused_epilogue").fused_epilogue
    if fn.argtypes is None:
        fn.argtypes = entry_argtypes()
        fn.restype = ctypes.c_int
    # the two [N] vectors ride in float32 whatever they came in
    b32 = b.float().contiguous()
    g32 = gamma.float().contiguous()
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), b32.data_ptr(),
                 g32.data_ptr(), resid.data_ptr(), out.data_ptr(), m, k, n,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_epilogue launch failed: cudaError {err}")
    matmul_scale_residual.launches += 1
    return out


def matmul_scale_residual(x, w, b, gamma, resid):
    """x: [M,K]; w: [K,N]; b, gamma: [N]; resid: [M,N] -> [M,N] in x's dtype.

    CUDA tensors launch the kernel (any M; K and N multiples of 8; float32
    or bfloat16); CPU tensors take the plain version."""
    if x.is_cuda:
        return fused_epilogue_kernel(x, w, b, gamma, resid)
    return matmul_scale_residual_reference(x, w, b, gamma, resid)


matmul_scale_residual.launches = 0
