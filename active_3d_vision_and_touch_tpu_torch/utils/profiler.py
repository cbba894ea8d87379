"""Profiling hooks: ``torch.profiler`` traces, the program's own spans and
counters, and step-time statistics.

Port of the JAX package's ``utils/profiler.py``.  Any engine loop can be
wrapped in :func:`trace` (a Chrome trace of the host and the card, readable
in Perfetto or ``chrome://tracing``) or timed with :class:`StepTimer`.
Tracing is on only when a directory is given or the ``A3VT_PROFILE_DIR``
environment variable names one, so production runs pay nothing.

The recorder.  The port marks its layer boundaries with :func:`span` and
counts events with :func:`count`.  A span records only while a
``torch.profiler`` runs on the thread (any :func:`trace`, or a caller's own
``torch.profiler.profile``): it then enters ``record_function`` under its
name, so it lands in the same trace as the card's kernels, and keeps an
in-memory record (name, parent, start, end, self time).  Without a
profiler a span costs one flag check.  Counters are integer adds under a lock,
always on.  :func:`snapshot` sums both, with the hand-written kernels'
launch counts (``CudaKernel.launches``); :func:`trace` writes it beside
its trace, and :func:`reset` clears both.  :func:`counted` and
:func:`recount` carry a CUDA graph's counters from its capture to each of
its replays; the launch counts are those of ``CudaKernel.launch`` alone,
so a replay adds none (a device trace counts a replay's kernels).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

PROFILE_ENV = "A3VT_PROFILE_DIR"


@contextlib.contextmanager
def trace(name: str = "trace", log_dir: str | None = None):
    """Record a ``torch.profiler`` trace of the block, CPU and (where there
    is one) CUDA activity, into ``<log_dir or $A3VT_PROFILE_DIR>/<name>/
    trace.json``, and the recorder's :func:`snapshot` at the block's end
    beside it, ``snapshot.json``; a no-op when neither names a directory.
    Yields the profiler, or None when off."""
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
    with open(os.path.join(path, "snapshot.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)


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


# -- the recorder ---------------------------------------------------------------


class SpanRecord(NamedTuple):
    name: str
    parent: str | None  # the enclosing span on the same thread
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    self_ns: int  # the duration less that of the span's children


_records: list[SpanRecord] = []
_counters: dict[str, int] = {}
_counters_lock = threading.Lock()  # counters may be added to from several threads
_local = threading.local()  # .stack: the open spans of this thread
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "parent", "children_ns", "start_ns", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.children_ns = 0
        stack.append(self)
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        self.annotation.__exit__(*exc)
        _local.stack.pop()
        duration = end_ns - self.start_ns
        parent = self.parent
        if parent is not None:
            parent.children_ns += duration
        _records.append(SpanRecord(self.name, parent and parent.name, self.start_ns, end_ns,
                                   duration - self.children_ns))
        return False


def span(name: str):
    """A context manager marking one layer's work as ``name``: recorded, and
    entered as a ``record_function``, only under a profiler active on this
    thread (``torch.profiler`` covers the thread that started it)."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def counted():
    """Yields a dict that holds, at the block's end, what the block added
    to the counters ({name: n}); for :func:`recount`."""
    with _counters_lock:
        before = dict(_counters)
    added: dict = {}
    yield added
    with _counters_lock:
        now = dict(_counters)
    added.update({name: n - before.get(name, 0) for name, n in now.items()
                  if n != before.get(name, 0)})


def recount(added: dict, times: int = 1) -> None:
    """Add to the counters what a block added (:func:`counted`) ``times``
    over.  A CUDA graph's replay runs the work its capture counted without
    running the Python that counts it; a capture runs nothing, so
    ``times=-1`` takes its counts back."""
    for name, n in added.items():
        count(name, n * times)


def records() -> list[SpanRecord]:
    """The spans recorded since the last :func:`reset`, in the order they
    ended."""
    return list(_records)


def snapshot() -> dict:
    """What the recorder holds: ``spans`` {name: {count, total_ms,
    median_ms, self_ms}}, ``counters`` {name: n} and ``launches``
    {kernel: launches through ``CudaKernel.launch``}."""
    durations: dict[str, list[int]] = {}
    self_ns: dict[str, int] = {}
    for r in list(_records):
        durations.setdefault(r.name, []).append(r.end_ns - r.start_ns)
        self_ns[r.name] = self_ns.get(r.name, 0) + r.self_ns
    spans = {
        name: {
            "count": len(d),
            "total_ms": sum(d) / 1e6,
            "median_ms": statistics.median(d) / 1e6,
            "self_ms": self_ns[name] / 1e6,
        }
        for name, d in durations.items()
    }
    with _counters_lock:
        counters = dict(_counters)
    from active_3d_vision_and_touch_tpu_torch.ops import KERNELS

    return {"spans": spans, "counters": counters,
            "launches": {k.name: k.launches for k in KERNELS}}


def reset() -> None:
    """Forget the recorded spans and the counters (not the kernels' own
    launch counts)."""
    _records.clear()
    with _counters_lock:
        _counters.clear()
