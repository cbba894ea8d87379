"""The touch steps' required work at the published peaks (flops/touch.py:
convolutions at TF32, the MLP and K1's operations at float32, the sampler
and K2 at HBM speed), as a share of the window's time, %."""

from benchmark.metrics import least_time_share as read  # noqa: F401
