"""Mean host wait in the port's ``Loader`` a step, over the window, ms (the
benchmark's own span around each ``next()``)."""

from benchmark.metrics import mean_ms


def read(record: dict):
    return mean_ms(record.get("loader_waits_s"))
