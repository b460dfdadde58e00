"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

Each kernel library is one `csrc/<name>.cu` with plain C entry points. It
compiles for Hopper (`sm_90a`) into
`<repo>/build/torch_kernels/lib<name>_<hash>.so`, where the hash covers the
source, the shared `csrc/*.cuh` headers and the flags, so an edited source
builds anew and an unchanged one is reused. `build()` starts one nvcc per kernel,
all together, and waits for them, and keeps each compiler report beside its
library (`ptxas_report`); `load()` builds what is missing and returns the
`ctypes.CDLL`. The libraries link against the CUDA runtime
only: the one libcuda function they need (`cuTensorMapEncodeTiled`, for the
TMA tensor maps of `csrc/sm90.cuh`) is fetched through the runtime at first
use. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "library_path",
           "nvcc_path", "ptxas_report"]

KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "fused_epilogue")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where kernel library `name` is, or will be, built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every kernel in `names` that is not built yet, all nvcc
    processes at once. Returns {name: ptxas report} for those compiled
    here; raises RuntimeError with the compiler output if any fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        library_path(name).with_suffix(".log").write_text(out)
        os.replace(tmp, library_path(name))
        reports[name] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def ptxas_report(name: str) -> str | None:
    """What nvcc and ptxas (`-v`) printed when kernel library `name` was
    built, kept beside it; None if it is not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
