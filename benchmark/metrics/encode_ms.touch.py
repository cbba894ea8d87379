"""Median host time of the touch encoder's forward with its rigid transform
in the profiled steps, ms: the program's own span ``touch.encode`` (inside
``TouchEngine``), recorded under the profiler; ``None`` where the program
has no such span."""

from benchmark.spans import median_ms


def read(record: dict):
    return median_ms("touch.encode")
