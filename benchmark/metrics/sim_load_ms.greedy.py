"""Median host time of the host simulator's ``Sampler.load_objects`` at the
resets of the profiled episodes (the episode's meshes loaded into its
scenes), ms: the program's own span ``sim.load_objects``, recorded under
the profiler."""

from benchmark.spans import median_ms


def read(record: dict):
    return median_ms("sim.load_objects")
