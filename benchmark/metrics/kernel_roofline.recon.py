"""K3 (the clustered search), the chunk selection and, in training, K2
(the sorted segment sums): their summed least time at the launched shapes
over their summed device time in a profiled stretch of steps, %."""

from benchmark.metrics import roofline_share as read  # noqa: F401
