"""Deterministic seeding utilities (reference `src/util/seeding.py:9-36`).

A copy of the JAX package's `utils/seeding.py`: `seed_all` covers the
host-side RNGs (python/numpy) the data pipeline uses, and
`generate_seed_sequence` reproduces the reference's per-step seed list, so
training stays bitwise-resumable mid-run.
"""

from __future__ import annotations

import random

import numpy as np

__all__ = ["seed_all", "generate_seed_sequence"]


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))


def generate_seed_sequence(initial_seed: int, length: int,
                           min_val=-0x8000_0000_0000_0000,
                           max_val=0xFFFF_FFFF_FFFF_FFFF) -> list[int]:
    rng = random.Random(initial_seed)
    return [rng.randint(min_val, max_val) for _ in range(length)]
