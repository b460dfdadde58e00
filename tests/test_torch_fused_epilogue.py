"""Port fused epilogue (plain version on the CPU) vs the JAX package's
reference chain and its Pallas kernel in interpret mode.

The same seeded numpy inputs go to both packages; max abs <= 2e-5 (float32
sums in another order), the bar of the JAX package's own kernel test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amodal_depth_anything_tpu.ops.fused_epilogue import \
    matmul_scale_residual as jax_kernel
from amodal_depth_anything_tpu.ops.fused_epilogue import \
    matmul_scale_residual_reference as jax_reference
from amodal_depth_anything_tpu_torch.ops.fused_epilogue import (
    fused_epilogue_kernel, matmul_scale_residual,
    matmul_scale_residual_reference)
from tests.test_torch_models import few_torch_threads  # noqa: F401

TOL = 2e-5
HIGHEST = jax.lax.Precision.HIGHEST


def _inputs(m, k, n, seed=0, bf16_rounded=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.05
    b = rng.standard_normal((n,), dtype=np.float32)
    g = rng.standard_normal((n,), dtype=np.float32) * 0.1
    r = rng.standard_normal((m, n), dtype=np.float32)
    if bf16_rounded:   # bfloat16 inputs, held in float32 on both sides
        x, w, r = (np.asarray(jnp.asarray(a, jnp.bfloat16)
                              .astype(jnp.float32)) for a in (x, w, r))
    return x, w, b, g, r


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a)).to(dtype)
            for a in arrays]


# (M, K, N, bf16-rounded inputs): M = 512 as the JAX package's own test,
# a ragged M the Pallas entry would refuse, bfloat16-valued inputs, and M, K
# and N all off the Hopper kernel's 128 x 256 x 64 tiles
@pytest.mark.parametrize("m,k,n,rounded", [(512, 128, 256, False),
                                           (777, 128, 256, False),
                                           (512, 64, 128, True),
                                           (777, 136, 264, False),
                                           (129, 72, 8, True)])
def test_plain_version_matches_jax_reference(m, k, n, rounded):
    arrays = _inputs(m, k, n, seed=1, bf16_rounded=rounded)
    ref = np.asarray(jax_reference(*map(jnp.asarray, arrays),
                                   precision=HIGHEST))
    for fn in (matmul_scale_residual, matmul_scale_residual_reference):
        ours = fn(*_torch(arrays)).numpy()
        assert ours.shape == (m, n) and ours.dtype == np.float32
        assert np.abs(ours - ref).max() <= TOL


@pytest.mark.parametrize("m,rounded", [(512, False), (256, True)])
def test_plain_version_matches_pallas_interpret(m, rounded):
    arrays = _inputs(m, 128, 256, seed=2, bf16_rounded=rounded)
    ref = np.asarray(jax_kernel(*map(jnp.asarray, arrays), block_m=256,
                                interpret=True))
    ours = matmul_scale_residual(*_torch(arrays)).numpy()
    assert np.abs(ours - ref).max() <= TOL


def test_bfloat16_tensors_keep_their_dtype_and_round_once_per_op():
    arrays = _inputs(130, 64, 72, seed=3)
    x, w, b, g, r = _torch(arrays)
    out = matmul_scale_residual(x.bfloat16(), w.bfloat16(), b, g,
                                r.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (130, 72)
    exact = matmul_scale_residual_reference(
        x.bfloat16().float(), w.bfloat16().float(), b, g,
        r.bfloat16().float())
    # |out| < 8 here, so half a bfloat16 ulp is < 2^-6; three roundings
    assert (out.float() - exact).abs().max() <= 3 * 2.0 ** -6


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    x, w, b, g, r = _torch(_inputs(40, 16, 24, seed=4))
    before = matmul_scale_residual.launches
    out = matmul_scale_residual(x, w, b, g, r)
    assert matmul_scale_residual.launches == before
    torch.testing.assert_close(
        out, matmul_scale_residual_reference(x, w, b, g, r), rtol=0, atol=0)


def test_kernel_entry_on_cpu_tensors_raises():
    x, w, b, g, r = _torch(_inputs(40, 16, 24, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        fused_epilogue_kernel(x, w, b, g, r)
