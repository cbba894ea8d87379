"""Median host time of ``ReconEngine.train_step`` in the profiled
autoencoder steps (the host's time to queue a step, waiting on the card
only where the step's work does, as at the frozen camera's copy), ms: the
program's own span ``recon.train_step``, recorded under the profiler."""

from benchmark.spans import median_ms


def read(record: dict):
    return median_ms("recon.train_step")
