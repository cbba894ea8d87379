"""The greedy steps' and resets' required work at the published peaks
(flops/active.py), as a share of the window's time, %."""

from benchmark.metrics import least_time_share as read  # noqa: F401
