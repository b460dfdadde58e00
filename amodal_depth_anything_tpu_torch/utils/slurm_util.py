"""SLURM helpers (reference `src/util/slurm_util.py:6-14`), the port's copy
of the JAX package's `utils/slurm_util.py`."""

from __future__ import annotations

import os

__all__ = ["is_on_slurm", "get_local_scratch_dir"]


def is_on_slurm() -> bool:
    return os.environ.get("SLURM_JOB_ID") is not None


def get_local_scratch_dir() -> str | None:
    return os.environ.get("TMPDIR")
