"""The device's idle share, an autoencoder step: its busy time in a
stretch profiled with the device's activity alone over the wall time in
the unprofiled window, %."""

from benchmark.metrics import idle_share as read  # noqa: F401
