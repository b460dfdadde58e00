"""Float32 precision policy.

The JAX package asks XLA for Precision.HIGHEST whenever operands are
float32 (its default would take bf16 passes). The counterpart on an NVIDIA
card is TF32: PyTorch's float32 matmuls run in full float32 by default, but
cuDNN's float32 convolutions default to TF32, which keeps ~3 decimal digits
and breaks 1e-4 parity with the reference. A float32 pipeline therefore
turns TF32 off for both; a bfloat16 pipeline leaves the flags alone, since
it asked for the fast path.
"""

from __future__ import annotations

import torch

__all__ = ["apply_precision_policy"]


def apply_precision_policy(dtype: torch.dtype) -> None:
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
