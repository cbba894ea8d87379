"""``torch.profiler`` over short stretches of steps, reduced to what the
per-layer metrics and the breakdown read: the device's busy time (the
union of its operations' intervals), the stretch's wall time, time by
device operation and launches by kernel, from a stretch that records the
device's activity alone; and the longest idle gaps, named by what the
host was doing meanwhile, from a second stretch that records the host's
operations too.  Recording every host operation slows a host-bound step
several times over, so the second stretch names the gaps and nothing
else."""

from __future__ import annotations

import time
from collections import Counter

import torch

NOT_LAUNCHES = ("Memcpy", "Memset")  # device operations that are no kernel


def union_seconds(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """Length in seconds of the union of (start_us, end_us) intervals, and
    the merged intervals in order."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


def reduce_events(device: list, host: list, wall_s: float) -> dict:
    """``device`` and ``host`` as (name, start_us, end_us) → the reading."""
    busy_s, merged = union_seconds([(s, e) for _, s, e in device])
    by_name: Counter = Counter()
    launches: Counter = Counter()
    for name, s, e in device:
        by_name[name] += (e - s) / 1e6
        if not name.startswith(NOT_LAUNCHES):
            launches[name] += 1
    longest = sorted(zip(merged, merged[1:]), key=lambda p: p[0][1] - p[1][0])[:10]
    gaps = []
    for (_, end), (start, _) in longest:
        mid = (end + start) / 2
        # the innermost host event open at the gap's middle
        covering = [(e - s, name) for name, s, e in host if s <= mid <= e]
        gaps.append([min(covering)[1] if covering else "host idle", (start - end) / 1e6])
    return {
        "busy_s": busy_s,
        "window_s": wall_s,
        "device_ops": [[n, t] for n, t in by_name.most_common(10)],
        "idle_gaps": gaps,
        "launches": dict(launches),
        "device_seconds": dict(by_name),
    }


def profile(run, span_names: tuple = (), host: bool = False) -> dict:
    """Profile ``run()`` (which ends with its work queued; what it returns
    is dropped) to the device's end and reduce the trace: the device's
    activity alone, or with ``host`` the host's operations too (for
    ``idle_gaps``).  ``span_names`` are the caller's ``record_function``
    names, which the profiler also lists on the device's timeline and
    which are no device work."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    device, host_ops = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name not in span_names:
                device.append(item)
        elif host:
            host_ops.append(item)
    return reduce_events(device, host_ops, wall_s)


def kernel_launches(reading: dict, kernel: str) -> int:
    return sum(n for name, n in reading["launches"].items() if f"{kernel}_kernel" in name)


def kernel_seconds(reading: dict, kernel: str) -> float:
    return sum(t for name, t in reading["device_seconds"].items() if f"{kernel}_kernel" in name)
