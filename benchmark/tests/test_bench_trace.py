"""The trace reduction and the per-layer readers on synthetic records."""

import pytest

from benchmark.harness import metric_reader
from benchmark.trace import reduce_events, union_seconds


def test_union_merges_overlaps():
    busy, merged = union_seconds([(0, 10), (5, 20), (30, 40)])
    assert busy == pytest.approx(30e-6) and merged == [[0, 20], [30, 40]]


def test_reduce_events_names_gaps_by_the_innermost_host_event():
    device = [("nn_cluster_kernel(float*)", 0, 100), ("gemm", 90, 200), ("Memcpy HtoD", 1200, 1300),
              ("nn_cluster_kernel(float*)", 5000, 5100)]
    host = [("bench.step", 0, 6000), ("bench.loader_next", 250, 1100), ("aten::copy_", 1300, 4900)]
    r = reduce_events(device, host, wall_s=6e-3)
    assert r["busy_s"] == pytest.approx(400e-6)
    assert r["idle_gaps"][0] == ["aten::copy_", pytest.approx(3700e-6)]
    assert r["idle_gaps"][1] == ["bench.loader_next", pytest.approx(1000e-6)]
    assert r["launches"] == {"nn_cluster_kernel(float*)": 2, "gemm": 1}
    assert r["device_ops"][0] == ["nn_cluster_kernel(float*)", pytest.approx(200e-6)]


def record(**over):
    # the stretch: 0.75 s busy over 2 steps; the window: 2 s over 4 steps
    trace = {"busy_s": 0.75, "window_s": 1.0, "units": 2,
             "launches": {"nn_cluster_kernel": 4, "select_chunks_kernel": 4},
             "device_seconds": {"nn_cluster_kernel": 0.004, "select_chunks_kernel": 0.001},
             "kernel_bounds": {"nn_cluster": (4, 0.002), "select_chunks": (4, 0.0005)}}
    base = {"window_s": 2.0, "window_units": 4, "least_s": 0.2, "loader_waits_s": [0.001, 0.003], "reset_s": [0.1, 0.2],
            "trace": trace}
    return {**base, **over}


READERS = ["loader_wait_ms.recon", "mfu.recon", "device_idle.recon", "kernel_roofline.recon",
           "reset_ms.greedy", "mfu.greedy", "device_idle.greedy", "kernel_roofline.greedy"]


def test_readers():
    assert metric_reader("loader_wait_ms.recon").read(record()) == pytest.approx(2.0)
    assert metric_reader("reset_ms.greedy").read(record()) == pytest.approx(150.0)
    for cell in ("recon", "greedy"):
        assert metric_reader(f"mfu.{cell}").read(record()) == pytest.approx(10.0)
        assert metric_reader(f"device_idle.{cell}").read(record()) == pytest.approx(25.0)
        # (2 + 0.5) ms of bounds over 5 ms of device time
        assert metric_reader(f"kernel_roofline.{cell}").read(record()) == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_their_reading(name):
    assert metric_reader(name).read({"trace": None}) is None


def test_a_kernel_taken_off_the_path_leaves_the_roofline_silent():
    off = record()
    off["trace"] = {**off["trace"], "launches": {"select_chunks_kernel": 4}}
    assert metric_reader("kernel_roofline.recon").read(off) is None


@pytest.mark.cuda
def test_the_profile_reads_device_time_and_launches_on_the_card(cuda_device):
    import torch

    from benchmark.trace import profile

    a = torch.randn(2048, 2048, device=cuda_device)

    def work():
        for _ in range(10):
            torch.mm(a, a)

    r = profile(work)
    assert 0 < r["busy_s"] <= r["window_s"]
    assert sum(r["launches"].values()) >= 10
    assert r["device_ops"] and r["device_ops"][0][1] > 0
