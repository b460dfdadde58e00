"""The port stands alone: nothing in `amodal_depth_anything_tpu_torch/` or in
`chip_smoke.py` imports JAX or the JAX package, and nothing on the CPU
pretends to be the kernel."""

import ast
import importlib
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "amodal_depth_anything_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "amodal_depth_anything_tpu")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_every_port_module_imports_without_a_card():
    # kernels build and triton imports happen inside the launching
    # function, never at import
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))


def test_kernel_impl_on_cpu_raises():
    from amodal_depth_anything_tpu_torch.ops.attention import \
        multi_head_attention
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        multi_head_attention(q, q, q, impl="kernel")


def test_fused_epilogue_on_cpu_takes_the_plain_version_or_raises():
    from amodal_depth_anything_tpu_torch.ops.fused_epilogue import (
        fused_epilogue_kernel, matmul_scale_residual,
        matmul_scale_residual_reference)
    gen = torch.Generator().manual_seed(0)
    x, w, r = (torch.randn(shape, generator=gen)
               for shape in ((24, 16), (16, 8), (24, 8)))
    b, g = torch.randn(8, generator=gen), torch.randn(8, generator=gen)
    launches = matmul_scale_residual.launches
    torch.testing.assert_close(
        matmul_scale_residual(x, w, b, g, r),
        matmul_scale_residual_reference(x, w, b, g, r), rtol=0, atol=0)
    assert matmul_scale_residual.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_epilogue_kernel(x, w, b, g, r)


def test_every_csrc_kernel_library_is_registered_for_the_build():
    from amodal_depth_anything_tpu_torch.ops import _build
    sources = sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert sources == sorted(_build.KERNELS)
