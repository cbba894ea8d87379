"""Median host time of ``DDQNEngine.update_parameters`` in the profiled env
batches (the replay's sample, the update queued and its loss fetched), ms:
the program's own span ``ddqn.update``, recorded under the profiler."""

from benchmark.spans import median_ms


def read(record: dict):
    return median_ms("ddqn.update")
