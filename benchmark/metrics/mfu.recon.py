"""The steps' required work at the published peaks (flops/vision.py), as a
share of the window's time, %."""

from benchmark.metrics import least_time_share as read  # noqa: F401
