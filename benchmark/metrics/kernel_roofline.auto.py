"""K1 (the exact search) at (B·repeat, n) x grid_size² both ways and K2
(the sorted segment sums) of the Chamfer backward, (B·repeat, n) ->
grid_size², at the autoencoder step's shapes: their summed least time
over their summed device time in a profiled stretch of steps, %; silent
if the launches are not 2 + 1 a step."""

from benchmark.metrics import roofline_share as read  # noqa: F401
