"""Mean host time of ``ActiveTouchEnv.reset`` over the window's resets, ms
(the benchmark's own span: the objects loaded into the host simulator,
the chart cache read, the first observation)."""

from benchmark.metrics import mean_ms


def read(record: dict):
    return mean_ms(record.get("reset_s"))
