"""The port's own spans, as its recorder (``utils/profiler.py``) sums them:
a span records only while a profiler runs, so the spans read here are
those of the run's profiled stretches, host times under the profiler.  A
program without the recorder, or a span that never ran, reads ``None``."""

from __future__ import annotations


def snapshot() -> dict | None:
    """The recorder's ``snapshot()``, or ``None`` where the program has
    none."""
    from active_3d_vision_and_touch_tpu_torch.utils import profiler

    read = getattr(profiler, "snapshot", None)
    return read() if read is not None else None


def median_ms(name: str) -> float | None:
    """The median duration of the span ``name``, ms."""
    found = (snapshot() or {}).get("spans", {}).get(name)
    return found["median_ms"] if found and found["count"] else None
