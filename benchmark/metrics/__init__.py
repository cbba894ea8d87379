"""Per-layer metric readers, one file per metric, named after it.

Each defines ``read(record) -> float | None`` and returns ``None`` where
the record holds nothing it can read.  The readers that several metrics
share are here; a runner's record holds ``window_s``, ``window_units``
(the window's steps or transitions), ``least_s`` (the window's required
work at the published peaks) and ``trace`` (the profiled stretch's
reading, with ``units`` of the same work and ``kernel_bounds``: {kernel:
(launches, least seconds)} of the launches the stretch should hold)."""

from __future__ import annotations

from benchmark.trace import kernel_launches, kernel_seconds


def least_time_share(record: dict):
    """The window's required work at the published peaks over its time, %."""
    if not record.get("window_s") or not record.get("least_s"):
        return None
    return 100.0 * record["least_s"] / record["window_s"]


def idle_share(record: dict):
    """1 - the device's busy time (the union of its operations) a unit of
    work in the profiled stretch over the wall time a unit in the
    unprofiled window, %.  The profiler slows the host, not the device's
    operations, so the stretch gives the busy time and the window the
    time it took."""
    trace = record.get("trace")
    if (not trace or trace["busy_s"] <= 0 or not trace.get("units")
            or not record.get("window_units") or not record.get("window_s")):
        return None
    busy = trace["busy_s"] / trace["units"]
    return 100.0 * (1.0 - busy / (record["window_s"] / record["window_units"]))


def roofline_share(record: dict):
    """The kernels' summed least time at their launched shapes over their
    summed device time in the profiled stretch, %; silent where a kernel's
    launches are not the expected ones (a kernel taken off the path)."""
    trace = record.get("trace")
    if not trace or not trace.get("kernel_bounds"):
        return None
    least = spent = 0.0
    for kernel, (launches, seconds) in trace["kernel_bounds"].items():
        if kernel_launches(trace, kernel) != launches:
            return None
        least += seconds
        spent += kernel_seconds(trace, kernel)
    return 100.0 * least / spent if spent > 0 else None


def mean_ms(values) -> float | None:
    return 1e3 * sum(values) / len(values) if values else None
