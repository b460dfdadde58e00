"""The port's CUDA sources, read as text: no compiler is needed.

Every kernel library has its source, each C entry point takes as many
arguments as its Python wrapper declares, the build targets `sm_90a`, the
three tensor-core kernel libraries redesigned for Hopper (the forward, the
backward, the fused epilogue) are built from wgmma and TMA, the short-key
backward's two kernels take no atomics, and no source leans on a library's
kernels."""

import ctypes
import re

import pytest

from amodal_depth_anything_tpu_torch.ops import (_build, flash_attention,
                                                 fused_epilogue)
from amodal_depth_anything_tpu_torch.tools.kernel_ablation import ABLATIONS

CSRC = _build.CSRC
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
INCLUDE = re.compile(r'#include\s+[<"]([^>"]+)[>"]')
# C entry point -> (library, the argtypes its wrapper sets)
ENTRIES = {
    "flash_attn_fwd": ("flash_attn_fwd",
                       flash_attention.entry_argtypes("flash_attn_fwd")),
    "flash_attn_bwd_dq": ("flash_attn_bwd",
                          flash_attention.entry_argtypes("flash_attn_bwd_dq")),
    "flash_attn_bwd_dkv": (
        "flash_attn_bwd", flash_attention.entry_argtypes("flash_attn_bwd_dkv")),
    "flash_attn_bwd_short": (
        "flash_attn_bwd",
        flash_attention.entry_argtypes("flash_attn_bwd_short")),
    "flash_attn_bwd_short_slabs": (
        "flash_attn_bwd",
        flash_attention.entry_argtypes("flash_attn_bwd_short_slabs")),
    "fused_epilogue": ("fused_epilogue", fused_epilogue.entry_argtypes()),
}


def _with_headers(name: str) -> str:
    """The text of csrc/<name>, followed by that of every "..." header it
    includes, directly or through another."""
    text, seen, todo = "", set(), [name]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        src = (CSRC / name).read_text()
        text += src
        todo += [h for h in re.findall(r'#include\s+"([^"]+)"', src)]
    return text


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_kernel_library_has_its_source(name):
    assert (CSRC / f"{name}.cu").is_file()


def test_every_source_is_a_kernel_library():
    assert sorted(p.stem for p in CSRC.glob("*.cu")) == sorted(_build.KERNELS)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_takes_what_its_wrapper_declares(entry):
    library, argtypes = ENTRIES[entry]
    found = dict(ENTRY.findall((CSRC / f"{library}.cu").read_text()))
    assert entry in found
    params = [p for p in found[entry].split(",") if p.strip()]
    assert len(params) == len(argtypes)


# a C parameter's type, its qualifiers and name dropped -> its ctypes type
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_types_match_its_wrapper(entry):
    library, argtypes = ENTRIES[entry]
    found = dict(ENTRY.findall((CSRC / f"{library}.cu").read_text()))
    params = [p.strip() for p in found[entry].split(",") if p.strip()]
    for param, argtype in zip(params, argtypes, strict=True):
        ctype = param.replace("const ", "").rsplit(None, 1)[0]
        want = ctypes.c_void_p if ctype.endswith("*") else C_TYPES[ctype]
        assert argtype is want, (param, argtype)


def test_every_entry_point_has_a_wrapper():
    for name in _build.KERNELS:
        for entry, _ in ENTRY.findall((CSRC / f"{name}.cu").read_text()):
            assert ENTRIES[entry][0] == name


def test_build_targets_sm_90a():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags


# a kernel function read alone: its source, and the sm90.cuh helpers through
# which its body issues each instruction (None: it issues none of it; the
# short-key forward is one warpgroup a block and the short-key backward
# three, with no producer warpgroup to take registers from)
KERNEL_CALLS = {"flash_attn_fwd_bf16_short": ("flash_attn_fwd.cu", {
    "wgmma.mma_async": ("wgmma_ss<0>(", "wgmma_rs("),
    "cp.async.bulk.tensor": ("tma_load_boxes<", "tma_store_4d("),
    "mbarrier.try_wait.parity": ("mbar_wait(",),
    "setmaxnreg": None}),
    "flash_attn_bwd_bf16_short": ("flash_attn_bwd.cu", {
        "wgmma.mma_async": ("wgmma_ss<0>(", "wgmma_ss<1, 1>(", "wgmma_rs("),
        "cp.async.bulk.tensor": ("tma_load_boxes<", "tma_store_4d("),
        "mbarrier.try_wait.parity": ("mbar_wait(",),
        "setmaxnreg": None})}


def _kernel_body(source: str, kernel: str) -> str:
    """The text of `kernel`'s definition in csrc/<source>."""
    src = (CSRC / source).read_text()
    start = src.index(f"\n{kernel}(")
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("name", ["flash_attn_fwd.cu", "flash_attn_bwd.cu",
                                  "fused_epilogue.cu",
                                  "flash_attn_fwd_bf16_short",
                                  "flash_attn_bwd_bf16_short"])
@pytest.mark.parametrize("ptx", [
    "wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait.parity",
    "setmaxnreg"])
def test_tensor_core_kernels_are_built_from_wgmma_and_tma(name, ptx):
    if name in KERNEL_CALLS:
        source, calls = KERNEL_CALLS[name]
        body = _kernel_body(source, name)
        if calls[ptx] is None:
            assert ptx not in body
        else:
            assert all(call in body for call in calls[ptx])
        name = source
    assert '#include "sm90.cuh"' in (CSRC / name).read_text()
    assert ptx in _with_headers(name)


@pytest.mark.parametrize("kernel", ["flash_attn_bwd_bf16_short",
                                    "flash_attn_bwd_short_sum"])
def test_short_backward_takes_no_atomics(kernel):
    """The short-key backward sums its blocks' partial dK and dV in a second
    pass in a fixed order, so that a run gives the same bits every time (the
    captured train steps are held bit for bit to eager): neither kernel,
    nor a helper it calls, takes an atomic; the one-pass kernel writes its
    partial sums where its head's tiles span several blocks."""
    atomic = re.compile(r"\batomic[A-Z]\w*\s*\(|\batom\.|\bred\.")
    body = _kernel_body("flash_attn_bwd.cu", kernel)
    src = _with_headers("flash_attn_bwd.cu")
    assert not atomic.search(body) and not atomic.search(src)
    if kernel == "flash_attn_bwd_bf16_short":
        assert "const bool direct = gridDim.x == 1;" in body
    else:
        assert "for (int s = 0; s < slabs; ++s" in body


@pytest.mark.parametrize("path", sorted(
    p.name for p in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))))
def test_no_source_includes_a_library_of_kernels(path):
    for header in INCLUDE.findall((CSRC / path).read_text()):
        low = header.lower()
        assert not any(word in low for word in (
            "cublas", "cudnn", "torch", "aten", "c10", "cutlass/gemm/device"))


@pytest.mark.parametrize("library,ablation", [
    (library, label) for library, ablations in sorted(ABLATIONS.items())
    for label in sorted(ablations)])
def test_ablation_edits_still_find_their_text(library, ablation):
    """`tools/kernel_ablation.py` takes parts out of a kernel by text, each
    edit of an ablation on the text the ones before it left."""
    text = (CSRC / f"{library}.cu").read_text()
    for old, new in ABLATIONS[library][ablation]:
        assert old in text and new != old
        text = text.replace(old, new)


@pytest.mark.parametrize("name", ["flash_attn_fwd.cu", "flash_attn_bwd.cu"])
def test_kstep3_reads_boxes_of_d_columns(name):
    """The bf16 forward (both kernels), dK/dV and dQ at KSTEPS 3 (d = 40)
    load boxes of d columns (`attention_map(..., narrow)` in sm90.cuh) and
    zero the k16 steps' columns past d themselves; dQ's streamed K and V
    are narrow where their keys fill at least half a tile."""
    src = (CSRC / name).read_text()
    assert "KSTEPS == 3 && kNarrow" in src and "zero_chunks(" in src
    header = (CSRC / "sm90.cuh").read_text()
    assert "const int box[4] = {narrow ? d : 64, rows, 1, 1};" in header
    if name == "flash_attn_fwd.cu":
        assert "constexpr bool kShortNarrow = true;" in src
        assert "kNarrow = KSTEPS == 3 && kShortNarrow;" in src
    if name == "flash_attn_bwd.cu":
        assert "constexpr bool kNarrowDqBoxes = true;" in src
        assert "KSTEPS == 3 && kNarrowDqBoxes>;" in src
        assert "  return T::kNarrow && kv_len >= kWgStream / 2;" in src
        assert "wgmma_maps<T>(a, true, dq_kv_narrow<T>(a.kv_len), m)" in src
