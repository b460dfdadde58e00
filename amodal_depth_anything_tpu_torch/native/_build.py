"""Build the port's host libraries with g++ at first use; load them with ctypes.

Each library is one `native/<name>.cpp` with plain C entry points. It
compiles into `<repo>/build/torch_native/lib<name>_<hash>.so`, where the
hash covers the source and the flags, so an edited source builds anew and
an unchanged one is reused. The compiler writes to a temporary name that is
renamed into place, so concurrent processes (test workers, loader threads,
trainers) never load a half-written file. Optional system libraries (zlib,
libjpeg) are linked only where their headers are found; a build that fails
with them is retried without. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "SRC_DIR", "BuildError", "build", "load",
           "library_path", "header_found"]

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
BASE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_INCLUDE_DIRS = ("/usr/include", "/usr/local/include",
                 "/usr/include/x86_64-linux-gnu",
                 "/usr/include/aarch64-linux-gnu")
_lock = threading.Lock()


class BuildError(RuntimeError):
    """g++ is missing or refused every variant of a library."""


def header_found(name: str) -> bool:
    """Whether a system header is on the compiler's usual search path (or
    on $CPATH / $CPLUS_INCLUDE_PATH)."""
    dirs = list(_INCLUDE_DIRS)
    for var in ("CPATH", "CPLUS_INCLUDE_PATH"):
        dirs += [d for d in os.environ.get(var, "").split(os.pathsep) if d]
    return any(os.path.exists(os.path.join(d, name)) for d in dirs)


def library_path(name: str, flags: tuple) -> Path:
    """Where library `name` built with `flags` is, or will be."""
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _compile(name: str, flags: tuple, libs: tuple) -> str | None:
    """Compile one variant; returns the compiler's error text or None."""
    out = library_path(name, flags)
    if out.exists():
        return None
    gxx = shutil.which("g++")
    if gxx is None:
        return "g++ not found on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *flags, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)}: exit {proc.returncode}\n{proc.stderr}"
    os.replace(tmp, out)
    return None


def build(name: str, variants) -> tuple[Path, tuple]:
    """Build the first variant of `name` that compiles. `variants`: a list
    of (extra flags, link libraries), most capable first. Returns (library
    path, the extra flags of the variant built); raises BuildError with
    every compiler error if none builds."""
    errors = []
    for extra, libs in variants:
        flags = (*BASE_FLAGS, *extra)
        err = _compile(name, flags, tuple(libs))
        if err is None:
            return library_path(name, flags), tuple(extra)
        errors.append(err)
    raise BuildError(f"native library {name} did not build:\n"
                     + "\n".join(errors))


def load(name: str, variants) -> tuple[ctypes.CDLL, tuple]:
    """`build` under a lock (loader threads race on first use), then
    `ctypes.CDLL` of the result."""
    with _lock:
        path, extra = build(name, variants)
        return ctypes.CDLL(str(path)), extra
