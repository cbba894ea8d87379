"""K1 (the exact search) at its launched shapes, (b·repeat, n) queries
against n points for each observation: least time over device time in a
profiled stretch of env batches, %."""

from benchmark.metrics import roofline_share as read  # noqa: F401
