"""Profiling hooks: ``torch.profiler`` traces and step-time statistics.

Port of the JAX package's ``utils/profiler.py``.  Any engine loop can be
wrapped in :func:`trace` (a Chrome trace of the host and the card, readable
in Perfetto or ``chrome://tracing``) or timed with :class:`StepTimer`.
Tracing is on only when a directory is given or the ``A3VT_PROFILE_DIR``
environment variable names one, so production runs pay nothing.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

PROFILE_ENV = "A3VT_PROFILE_DIR"


@contextlib.contextmanager
def trace(name: str = "trace", log_dir: str | None = None):
    """Record a ``torch.profiler`` trace of the block, CPU and (where there
    is one) CUDA activity, into ``<log_dir or $A3VT_PROFILE_DIR>/<name>/
    trace.json``; a no-op when neither names a directory.  Yields the
    profiler, or None when off."""
    log_dir = log_dir or os.environ.get(PROFILE_ENV)
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(log_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(path, "trace.json"))


class StepTimer:
    """Running step-time statistics (mean / p50 / p95) for engine loops.
    The caller synchronises the card inside the block where it wants the
    device's time counted."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0: float | None = None
        self._seen = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)

    def stats(self) -> dict:
        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
