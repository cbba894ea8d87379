"""The ``touch.train`` cell on the CPU at a tiny size (batch 4, 256 samples a
chart; the gel images stay 121x121, which the encoder's flatten fixes): a
sound run comes out correct, a run with the timed path broken underneath
does not, once for each fault the cell can have, and the bfloat16 control
reads above a limit; the counts against sums worked by hand, and the
world the port's ``TouchDataset`` reads."""

import copy
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.flops import touch as flops
from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.reference.touch import _Tf32Conv, tf32
from benchmark.harness import ROOT, load_json
from benchmark.runners import touch as runner
from benchmark.world.touch import write_touch_world

CFG = load_json(ROOT / "benchmark/configs/touch.json")
MODEL = {**CFG["config"], "repeat": CFG["repeat"]}


def tiny_run(seed: int) -> harness.Run:
    run = harness.make_run(harness.load_spec(), "touch.train", seed, 0.5, False, "cpu", time.perf_counter())
    run.config = copy.deepcopy(run.config)
    run.config["config"].update(batch_size=4, num_samples=256)
    run.traffic = dict(run.traffic, world={"recon_train": {"names": 4, "distinct": 2}}, grasps=2, fingers=2,
                       cloud_points=300, preloaded_batches=2)
    return run


def outcome(seed: int = 3_000_000_019) -> harness.Outcome:
    out = harness.execute(tiny_run(seed))
    assert out.attempted >= 1 and out.failed == 0
    return out


def half_batch(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine

    loss = TouchEngine._loss

    def first_half(self, batch, generator, draws):
        h = batch["samples"].shape[0] // 2
        return loss(self, {k: v[:h] for k, v in batch.items()}, generator, tuple(d[:h] for d in draws))

    monkeypatch.setattr(TouchEngine, "_loss", first_half)


def answer_altered(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.train import touch

    chamfer = touch.mesh_chamfer_distance

    def altered(*args, **kwargs):
        cd = chamfer(*args, **kwargs)
        return torch.cat([2 * cd[:1], cd[1:]])

    monkeypatch.setattr(touch, "mesh_chamfer_distance", altered)


def state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def test_sound_run_is_correct():
    out = outcome()
    assert out.correct, out.checks
    assert set(out.end_to_end) == {"samples_per_s", "step_p95_ms", "setup_s"}
    assert out.end_to_end["samples_per_s"] > 0 and out.record["least_s"] > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered], ids=lambda f: f.__name__)
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    out = outcome()
    assert not out.correct, out.checks


def test_the_control_fails_a_limit():
    """The reference in bfloat16, put in the program's place, reads above
    the limit of at least one of the cell's numbers; the program does not."""
    run = tiny_run(2)
    try:
        lines = {line["variant"]: line for line in runner.control(run, {"bf16": dict(dtype=torch.bfloat16)})}
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    assert all(lines["program"][k] <= v for k, v in run.limits.items()), lines["program"]
    assert any(lines["bf16"][k] > v for k, v in run.limits.items()), lines["bf16"]
    assert lines["unchanged"]["change_gap"] == 1.0


def test_conv_flops_by_hand():
    # (output size, output features, input features) of the 18 convolutions
    layers = [(61, 16, 3), (61, 16, 16), (61, 16, 16),
              (31, 32, 16), (31, 32, 32), (31, 32, 32),
              (16, 32, 32), (16, 32, 32), (16, 32, 32),
              (8, 64, 32), (8, 64, 64), (8, 64, 64),
              (4, 128, 64), (4, 128, 128), (4, 128, 128),
              (2, 128, 128), (2, 128, 128), (2, 128, 128)]
    assert flops.conv_layers() == layers
    assert flops.conv_flops() == sum(2.0 * s * s * o * i * 25 for s, o, i in layers)
    assert flops.mlp_flops() == 2.0 * (512 * 256 + 256 * 128 + 128 * 75)


def test_kernel_bounds_match_the_quoted_ones():
    bounds = flops.kernel_bounds(MODEL)
    launches, k1 = bounds["nn_exact"]
    # (192, 4000) x 4000, 9 operations a pair at 67 TFLOP/s: 0.4127 ms a launch
    assert launches == 2 and k1 / 2 == pytest.approx(192 * 4000 * 4000 * 9 / PEAK_OPS["fp32"])
    assert k1 / 2 * 1e3 == pytest.approx(0.4127, abs=5e-5)
    # K2: (192, 4000) -> 4000 and (192, 12000) -> 32 faces, 0.0064 + 0.0110 ms
    assert bounds["segsum_sorted"][0] == 2
    assert bounds["segsum_sorted"][1] * 1e3 == pytest.approx(0.0064 + 0.0110, abs=1e-4)
    least = flops.step_least_seconds(MODEL)
    assert least["conv"] == pytest.approx(3 * 64 * flops.conv_flops() / PEAK_OPS["tf32"])
    assert least["sampler"] == pytest.approx(2 * 64 * 12000 * 24 / PEAK_HBM_BYTES)
    assert least["total"] == pytest.approx(sum(v for k, v in least.items() if k != "total"))


def test_tf32_rounds_to_nearest_ties_to_even():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-11 + 2**-20, -1 - 3 * 2**-11, 3.14159265])
    want = [1.0, 1.0, 1 + 2**-9, 1 + 2**-10, -1 - 2**-9, 3.140625]
    assert tf32(x).tolist() == want


def test_tf32_conv_is_conv2d_on_rounded_operands():
    """Forward and backward of the emulated TF32 convolution equal
    ``conv2d``'s on operands and gradient already rounded to TF32."""
    gen = torch.Generator().manual_seed(0)
    x = tf32(torch.randn(2, 3, 11, 11, generator=gen)).requires_grad_()
    w = tf32(torch.randn(4, 3, 5, 5, generator=gen)).requires_grad_()
    b = torch.randn(4, generator=gen).requires_grad_()
    y = _Tf32Conv.apply(x, w, b, 2)
    want = torch.nn.functional.conv2d(x, w, b, stride=2, padding=2)
    g = tf32(torch.randn(want.shape, generator=gen))
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)
    for got, exp in zip(torch.autograd.grad(y, (x, w, b), g), torch.autograd.grad(want, (x, w, b), g)):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
    # unrounded operands: the result moves by TF32's rounding, about 2**-11
    x2 = x.detach() * (1 + 2**-12)
    assert not torch.equal(_Tf32Conv.apply(x2, w.detach(), None, 1), torch.nn.functional.conv2d(x2, w.detach(), None, padding=2))


def test_world_is_read_by_the_port_and_repeats_from_its_seed(tmp_path):
    from active_3d_vision_and_touch_tpu_torch.data.datasets import TouchDataset

    dev = torch.device("cpu")
    splits = {"recon_train": {"names": 5, "distinct": 2}}
    names = write_touch_world(tmp_path / "a", 7, dev, splits, 3, 2, 500)
    write_touch_world(tmp_path / "b", 7, dev, splits, 3, 2, 500)
    assert names["recon_train"] == [f"recon_train_{i:04d}" for i in range(5)]
    ds = TouchDataset(str(tmp_path / "a"), "recon_train", num_samples=400)
    assert len(ds) == 5 * 3 * 2
    item = ds[7]
    assert item["names"] == ("recon_train_0001", "0", "1")
    assert item["sim_touch"].shape == (121, 121, 3) and 0 <= item["sim_touch"].min() <= item["sim_touch"].max() <= 1
    assert item["samples"].shape == (400, 3)
    rot = item["ref_rot"]
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-5)
    assert np.linalg.det(rot) == pytest.approx(1.0, abs=1e-5)
    # the cloud lies within the sensor's reach of the fingertip
    assert np.abs((item["samples"] - item["ref_pos"]) @ rot).max() < 0.02
    again = TouchDataset(str(tmp_path / "b"), "recon_train", num_samples=400)
    linked = ds[4 * 6 + 1]  # recon_train_0004 links to recon_train_0000
    for k in ("sim_touch", "samples", "ref_pos", "ref_rot"):
        assert (again[7][k] == item[k]).all()
    for k in ("sim_touch", "ref_pos", "ref_rot"):  # the subset drawn depends on the item's index
        assert (linked[k] == ds[1][k]).all()
