"""The readers of the program's own spans on synthetic snapshots of its
recorder, on an empty one, and on a program without the recorder."""

import pytest

from active_3d_vision_and_touch_tpu_torch.utils import profiler
from benchmark.harness import metric_reader

READERS = {
    "sim_load_ms.greedy": "sim.load_objects",
    "sim_load_ms.ddqn": "sim.load_objects",
    "update_ms.ddqn": "ddqn.update",
    "host_step_ms.recon": "recon.train_step",
}


def synthetic(spans: dict) -> dict:
    return {"spans": spans, "counters": {"env.signal_hits": 150}, "launches": {"nn_exact": 62}}


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_takes_its_spans_median(monkeypatch, metric):
    spans = {READERS[metric]: {"count": 4, "total_ms": 520.0, "median_ms": 131.5, "self_ms": 12.0},
             "env.reset": {"count": 4, "total_ms": 900.0, "median_ms": 230.0, "self_ms": 30.0}}
    monkeypatch.setattr(profiler, "snapshot", lambda: synthetic(spans))
    assert metric_reader(metric).read({}) == 131.5


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_is_silent_where_its_span_never_ran(monkeypatch, metric):
    monkeypatch.setattr(profiler, "snapshot", lambda: synthetic({}))
    assert metric_reader(metric).read({}) is None
    other = {"env.step": {"count": 2, "total_ms": 10.0, "median_ms": 5.0, "self_ms": 1.0}}
    monkeypatch.setattr(profiler, "snapshot", lambda: synthetic(other))
    assert metric_reader(metric).read({"trace": None}) is None


@pytest.mark.parametrize("metric", list(READERS))
def test_reader_is_silent_on_a_program_without_the_recorder(monkeypatch, metric):
    monkeypatch.delattr(profiler, "snapshot")
    assert metric_reader(metric).read({}) is None


def test_readers_read_the_live_recorder():
    """Spans recorded under a CPU profiler reach the readers."""
    from torch.profiler import ProfilerActivity, profile

    profiler.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                with profiler.span("ddqn.update"):
                    pass
        got = metric_reader("update_ms.ddqn").read({})
        assert got == profiler.snapshot()["spans"]["ddqn.update"]["median_ms"] and got >= 0
        assert metric_reader("host_step_ms.recon").read({}) is None
    finally:
        profiler.reset()
