"""Host-side micro-batching front end for the serving pipelines.

Port of the JAX package's `pipeline/server.py` (its own copy: the port
imports nothing of the JAX package). On the card a pipeline serves one
captured CUDA graph per batch bucket (`pipeline.aot`), replayed at a static
shape, while callers arrive one request at a time. `MicroBatcher` sits
between them: concurrent `submit()` calls are coalesced into batches of up
to `max_batch`, partial batches are PADDED to the full bucket (so exactly
one program shape ever runs), and one dispatch thread feeds the device
while callers block on futures.

`batch_fn` is called from the dispatch thread only. A captured handle
replays on that thread's current stream, and one thread means its replays
never overlap.

Contract (tests/test_torch_server.py; on the card `chip_smoke.py` phase 9):
batching and padding never change a result. No model here mixes batch
rows, and every row of a bucket gives the same bits for the same input, so
a served request is bit-identical to a direct pipeline call at any
position of the batch and, for the amodal family on the card, to a direct
call at batch 1. On the card that needs the DPT heads run one row at a time
(`AmodalDepthPipeline.served_head_tile`): cuDNN's 3x3 convolutions at the
heads' 37 x 37 level round one bf16 input differently in the two halves of
a batch of 4 (`tools/batch_position_probe.py`); the trunks' products and
the attention kernel are row-invariant there.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np

__all__ = ["MicroBatcher"]


class MicroBatcher:
    """Coalesce single-sample requests into fixed-size device batches.

    `batch_fn(*stacked) -> array | tuple[array, ...]`: a batched callable
    whose inputs and outputs all carry the batch on axis 0 (e.g.
    `AmodalDepthPipeline.__call__` or a `CapturedAmodalServing` handle). All
    requests must share per-sample shapes (static-shape serving).

    `max_batch`: the served batch bucket. Partial batches are padded by
    repeating the last sample and the padding rows' outputs are dropped.
    `max_delay_ms`: how long the dispatcher waits for more requests
    before launching a partial batch (the latency/throughput knob;
    0 = launch immediately whatever has queued).
    """

    def __init__(self, batch_fn: Callable, *, max_batch: int = 8,
                 max_delay_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._fn = batch_fn
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1e3
        self.dispatches = 0  # observability: batches handed to batch_fn
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # ------------------------------------------------------------- public

    def submit(self, *sample: np.ndarray) -> Future:
        """Enqueue one request (per-sample arrays, no batch dim).
        Returns a Future resolving to the per-sample output (a tuple if
        `batch_fn` returns a tuple)."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._q.put((tuple(np.asarray(a) for a in sample), fut))
        return fut

    def infer(self, *sample: np.ndarray, timeout: float | None = None):
        """Blocking convenience: submit + wait. `timeout` (seconds) bounds
        the wait: a wedged device raises concurrent.futures.TimeoutError
        instead of hanging the caller."""
        return self.submit(*sample).result(timeout=timeout)

    def close(self) -> None:
        """Drain queued requests, then stop the dispatch thread."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _collect(self) -> Sequence | None:
        """Block for the first request, then gather up to max_batch more
        within the delay window. None = shutdown."""
        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        t_end = time.monotonic() + self.max_delay
        while len(batch) < self.max_batch:
            timeout = t_end - time.monotonic()
            try:
                item = self._q.get(timeout=max(timeout, 0.0))
            except queue.Empty:
                break
            if item is None:  # shutdown sentinel: requeue and flush
                self._q.put(None)
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            samples = [s for s, _ in batch]
            futs = [f for _, f in batch]
            try:
                shapes = [tuple(a.shape) for a in samples[0]]
                for s in samples[1:]:
                    if [tuple(a.shape) for a in s] != shapes:
                        raise ValueError(
                            "all requests must share per-sample shapes "
                            f"(static-shape serving); got {shapes} vs "
                            f"{[tuple(a.shape) for a in s]}")
                n = len(samples)
                if n < self.max_batch:
                    samples = samples + [samples[-1]] * (self.max_batch - n)
                stacked = tuple(
                    np.stack([s[i] for s in samples])
                    for i in range(len(shapes)))
                out = self._fn(*stacked)
                self.dispatches += 1
                multi = isinstance(out, tuple)
                outs = out if multi else (out,)
                for i, fut in enumerate(futs):
                    per = tuple(np.asarray(o)[i] for o in outs)
                    fut.set_result(per if multi else per[0])
            except Exception as e:  # noqa: BLE001 — propagate to callers
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
