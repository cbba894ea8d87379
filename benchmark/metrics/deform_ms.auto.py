"""Median host time of the frozen deformation's forward in the profiled
autoencoder steps, ms: the program's own span ``auto.deform`` (inside
``AutoencoderEngine.deform``), recorded under the profiler; ``None``
where the program has no such span, and ``None`` if the step ever replays
from a CUDA graph, where no span of the step's body runs (as
``encode_ms.touch`` since the touch step replays)."""

from benchmark.spans import median_ms


def read(record: dict):
    return median_ms("auto.deform")
