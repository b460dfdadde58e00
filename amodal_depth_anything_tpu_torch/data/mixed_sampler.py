"""Probability-weighted multi-dataset batch sampling.

Equivalent of the reference `MixedBatchSampler`
(`src/dataset/mixed_sampler.py:31-107`): each batch is drawn whole from
one source dataset, the source chosen by probability; indices shift into
the concatenated index space. Ours is numpy-seeded (no torch generator)
and exposes deterministic per-epoch reshuffling via `set_epoch`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["MixedBatchSampler"]


class MixedBatchSampler:
    def __init__(self, src_dataset_ls: Sequence, batch_size: int,
                 drop_last: bool = True, shuffle: bool = True,
                 prob: Sequence[float] | None = None, seed: int = 0):
        self.datasets = list(src_dataset_ls)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

        self.lengths = [len(d) for d in self.datasets]
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)[:-1]])
        self.n_batches_per_src = [
            (n // batch_size) if drop_last else -(-n // batch_size)
            for n in self.lengths
        ]
        self.n_total_batch = sum(self.n_batches_per_src)
        if prob is None:
            self.prob = np.asarray(self.n_batches_per_src, np.float64)
        else:
            self.prob = np.asarray(prob, np.float64)
        self.prob = self.prob / self.prob.sum()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _src_batches(self, rng: np.random.Generator, ds_idx: int):
        n = self.lengths[ds_idx]
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [order[i:i + self.batch_size]
                for i in range(0, end, self.batch_size)]

    def __iter__(self):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch]))
        pools = [self._src_batches(rng, i) for i in range(len(self.datasets))]
        for _ in range(self.n_total_batch):
            ds_idx = int(rng.choice(len(self.datasets), p=self.prob))
            if not pools[ds_idx]:
                pools[ds_idx] = self._src_batches(rng, ds_idx)
            batch = pools[ds_idx].pop()
            yield (batch + self.offsets[ds_idx]).tolist()

    def __len__(self) -> int:
        return self.n_total_batch
