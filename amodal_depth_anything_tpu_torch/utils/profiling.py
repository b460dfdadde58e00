"""Tracing / profiling as a first-class module.

The reference has none (only tqdm bars and a thop FLOPs hook). Here, as in
the JAX package: a trace capture around a window of steps
(`torch.profiler`, written as a Chrome trace) and a low-overhead step timer
with percentile summaries, both used by the trainer.

    prof = start_trace()
    ...                          # the steps to capture
    stop_trace(prof, "work_dir/profile")

    timer = StepTimer()
    with timer.step():
        ...
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

__all__ = ["StepTimer", "start_trace", "stop_trace"]


class StepTimer:
    """Wall-clock step timer with p50/p90/p99 summaries."""

    def __init__(self, warmup: int = 2):
        self.durations: list[float] = []
        self.warmup = warmup
        self._count = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.warmup:
            self.durations.append(dt)

    def summary(self) -> dict:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "p99_s": float(np.percentile(d, 99)),
            "steps_per_sec": float(1.0 / d.mean()),
        }


def start_trace():
    """Start a torch.profiler capture (CPU, and the card when there is
    one); `stop_trace` writes it as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path

