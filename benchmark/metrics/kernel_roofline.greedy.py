"""K1 (the exact search) at its launched shapes: least time over device
time in a profiled stretch of episodes, %."""

from benchmark.metrics import roofline_share as read  # noqa: F401
