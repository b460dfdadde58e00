"""Batching data loader with deterministic resume and background prefetch.

Replaces torch's DataLoader + the reference's vendored
`skip_first_batches` resume machinery (`src/util/data_loader.py:24-111`):
because our sampling is index-seeded per (seed, epoch), skipping the
first N batches is exact replay, not a fragile iterator fast-forward.

The loader collates numpy dicts into stacked arrays (strings into lists),
optionally zero-pads the final partial batch (one batch shape throughout),
and prefetches with a background thread so host IO overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

__all__ = ["DataLoader", "ConcatDataset", "collate"]


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.lengths = [len(d) for d in self.datasets]
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, index: int):
        ds_idx = int(np.searchsorted(self.offsets[1:], index, side="right"))
        return self.datasets[ds_idx][index - int(self.offsets[ds_idx])]

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)


def collate(samples: list[dict], *, pad_to: int | None = None) -> dict:
    out: dict = {}
    n = len(samples)
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (str, bytes)):
            out[k] = list(vals)
            continue
        arr = np.stack([np.asarray(v) for v in vals])
        if pad_to is not None and n < pad_to:
            pad = np.zeros((pad_to - n, *arr.shape[1:]), arr.dtype)
            arr = np.concatenate([arr, pad])
        out[k] = arr
    if pad_to is not None:
        mask = np.zeros(pad_to or n, bool)
        mask[:n] = True
        out["__sample_mask__"] = mask
    return out


class DataLoader:
    """Iterates batches of collated dicts.

    sampler: optional iterable of index lists (e.g. MixedBatchSampler).
    Without one, sequential or seeded-shuffled batching over the dataset.
    """

    def __init__(self, dataset, batch_size: int = 1, *, shuffle: bool = False,
                 sampler=None, drop_last: bool = False, seed: int = 0,
                 pad_last: bool = False, prefetch: int = 2,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.sampler = sampler
        self.drop_last = drop_last
        self.seed = seed
        self.pad_last = pad_last
        self.prefetch = prefetch
        # torch-DataLoader-style worker parallelism (reference trainers run
        # num_workers>0). Threads, not processes: the hot per-sample work —
        # native PNG/JPEG decode (ctypes releases the GIL) and the OpenMP
        # preprocess kernels — runs concurrently on real cores; batch ORDER
        # stays bit-identical to the serial loader (sequence-gated reorder).
        self.num_workers = num_workers
        self.epoch = 0
        self.skip_batches = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def skip_first_batches(self, n: int) -> None:
        """Deterministic mid-epoch resume (reference data_loader.py:70-111)."""
        self.skip_batches = n

    def _index_batches(self) -> Iterator[list[int]]:
        if self.sampler is not None:
            yield from iter(self.sampler)
            return
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch]))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield order[i:i + self.batch_size].tolist()

    def __len__(self) -> int:
        if self.sampler is not None:
            return len(self.sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _produce(self, q: "queue.Queue", skip: int) -> None:
        try:
            for bi, idxs in enumerate(self._index_batches()):
                if bi < skip:
                    continue
                samples = [self.dataset[i] for i in idxs]
                pad_to = self.batch_size if self.pad_last else None
                q.put(collate(samples, pad_to=pad_to))
            q.put(None)
        except BaseException as e:  # surface worker errors to the consumer
            q.put(e)

    def _build_batch(self, idxs: list[int]) -> dict:
        samples = [self.dataset[i] for i in idxs]
        pad_to = self.batch_size if self.pad_last else None
        return collate(samples, pad_to=pad_to)

    def _iter_parallel(self, skip: int) -> Iterator[dict]:
        """num_workers>1: parallel sample building, deterministic order.

        Workers pull (seq, idxs) jobs FIFO and gate on
        `seq < consumed + window` before building, so at most `window`
        batches are in flight or built-unconsumed. The seqs below the
        smallest unbuilt one are always contiguous in `results`, so the
        consumer can always drain enough to reopen the gate — no deadlock
        for any window >= 1. Output order is identical to the serial path.
        """
        jobs: "queue.Queue" = queue.Queue()
        n_jobs = 0
        for bi, idxs in enumerate(self._index_batches()):
            if bi < skip:
                continue
            jobs.put((n_jobs, idxs))
            n_jobs += 1
        for _ in range(self.num_workers):
            jobs.put(None)

        window = max(self.prefetch, 1) + self.num_workers
        cond = threading.Condition()
        results: dict[int, dict] = {}
        consumed = [0]
        errors: list[BaseException] = []

        def work() -> None:
            while True:
                job = jobs.get()
                if job is None:
                    return
                seq, idxs = job
                with cond:
                    while seq >= consumed[0] + window and not errors:
                        cond.wait()
                    if errors:
                        return
                try:
                    out = self._build_batch(idxs)
                except BaseException as e:  # surface to the consumer
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return
                with cond:
                    results[seq] = out
                    cond.notify_all()

        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for seq in range(n_jobs):
                with cond:
                    while seq not in results and not errors:
                        cond.wait()
                    if errors:
                        raise errors[0]
                    batch = results.pop(seq)
                    consumed[0] += 1
                    cond.notify_all()
                yield batch
        finally:
            with cond:  # unblock gated workers if the consumer bails early
                if not errors:
                    errors.append(GeneratorExit())
                cond.notify_all()

    def __iter__(self) -> Iterator[dict]:
        skip, self.skip_batches = self.skip_batches, 0
        if self.num_workers > 1:
            yield from self._iter_parallel(skip)
            return
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        t = threading.Thread(target=self._produce, args=(q, skip), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
