"""The ``autoencoder.train`` cell on the CPU at a tiny size (batch 4, a frozen
model and an autoencoder of 3 GCN layers x 32, 3 CNN blocks on 64x64
images, an 8x8 grid, 300 samples a repeat): a sound run comes out correct,
a run with the timed path broken underneath does not, once for each fault
the cell can have, and the bfloat16 control and a doubled row read above a
limit; the counts against sums worked by hand, and the seeded leaves
against the port's own."""

import copy
import shutil
import time

import pytest
import torch

from benchmark import harness
from benchmark.flops import autoencoder as flops
from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.harness import ROOT, load_json
from benchmark.reference.autoencoder import param_specs
from benchmark.runners import autoencoder as runner

CFG = load_json(ROOT / "benchmark/configs/autoencoder.json")
MODEL = {**CFG["config"], "repeat": CFG["repeat"], "feature_size": CFG["feature_size"]}
TINY = dict(num_gcn_layers=3, hidden_gcn_size=32, number_points=300, num_cnn_blocks=3, batch_size=4)


def tiny_run(seed: int) -> harness.Run:
    run = harness.make_run(harness.load_spec(), "autoencoder.train", seed, 0.5, False, "cpu", time.perf_counter())
    run.config = copy.deepcopy(run.config)
    run.config["vision"].update(TINY)
    run.config["config"].update(TINY, encoding_size=16, grid_size=8)
    run.traffic = dict(run.traffic, world={"auto_train": {"names": 8, "distinct": 4}}, cloud_points=400,
                       image_size=64, preloaded_batches=2)
    return run


def outcome(seed: int = 3_000_000_019) -> harness.Outcome:
    out = harness.execute(tiny_run(seed))
    assert out.attempted >= 1 and out.failed == 0
    return out


def half_batch(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine

    loss = AutoencoderEngine._loss

    def first_half(self, batch, generator, draws):
        h = batch["gt_points"].shape[0] // 2
        return loss(self, {k: v[:h] for k, v in batch.items()}, generator, tuple(d[:h] for d in draws))

    monkeypatch.setattr(AutoencoderEngine, "_loss", first_half)


def answer_altered(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.train import autoencoder

    chamfer = autoencoder.mesh_chamfer_distance

    def altered(*args, **kwargs):
        cd = chamfer(*args, **kwargs)
        return torch.cat([2 * cd[:1], cd[1:]])

    monkeypatch.setattr(autoencoder, "mesh_chamfer_distance", altered)


def frozen_altered(monkeypatch):
    """The frozen model's first row moved by 1% of its size: the
    autoencoder's numbers follow the program's frozen output, the frozen
    vertices' gap does not."""
    from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

    forward = VisionEngine.forward

    def moved(self, batch):
        verts, mask = forward(self, batch)
        return torch.cat([verts[:1] * 1.01, verts[1:]]), mask

    monkeypatch.setattr(VisionEngine, "forward", moved)


def state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def test_sound_run_is_correct():
    out = outcome()
    assert out.correct, out.checks
    assert [name for name, _, _ in out.checks] == ["deform_gap", "loss_gap", "grad_gap", "change_gap", "out_grad_gap"]
    assert set(out.end_to_end) == {"samples_per_s", "step_p95_ms", "setup_s"}
    assert out.end_to_end["samples_per_s"] > 0 and out.record["least_s"] > 0


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered, frozen_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    out = outcome()
    assert not out.correct, out.checks


def test_the_control_and_a_doubled_row_fail_a_limit():
    """The reference in bfloat16, the reference with its decoder's products
    in TF32, and the reference with its first row's distance doubled, put
    in the program's place, each read above the limit of at least one of
    the cell's numbers; the program does not."""
    run = tiny_run(2)
    try:
        lines = {line["variant"]: line for line in runner.control(run)}
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    assert all(lines["program"][k] <= v for k, v in run.limits.items()), lines["program"]
    for variant in ("bf16", "tf32_decoder", "row0x2"):
        assert any(lines[variant][k] > v for k, v in run.limits.items()), lines[variant]
    assert lines["unchanged"]["change_gap"] == 1.0


def test_seeded_leaves_are_the_ports():
    """``param_specs`` names and shapes every leaf of the port's
    ``MeshAutoEncoder`` at the published widths, in its order."""
    from active_3d_vision_and_touch_tpu_torch.models import MeshAutoEncoder

    model = MeshAutoEncoder(MODEL["encoding_size"], MODEL["num_gcn_layers"], MODEL["hidden_gcn_size"],
                            MODEL["cut"], MODEL["feature_size"], MODEL["grid_size"])
    want = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert [(name, shape) for name, shape, _, _ in param_specs(MODEL)] == want


def test_decoder_flops_by_hand():
    # the code (200 -> 512) and both folds' code shares (512 x 512) once a
    # cloud; per point 2 -> 512 -> 512 -> 3, then 3 -> 512 -> 512 -> 3
    per_point = 2 * (2 * 512 + 512 * 512 + 512 * 3) + 2 * (3 * 512 + 512 * 512 + 512 * 3)
    assert flops.decoder_flops(MODEL) == 2 * (200 * 512 + 2 * 512 * 512) + 6400 * per_point
    least = flops.step_least_seconds(MODEL, CFG["vision"])
    # about 3.3e11 operations a step forward and backward: 4.86 ms at 67 TFLOP/s
    assert least["decoder"] * 1e3 == pytest.approx(4.860, abs=1e-3)
    assert least["sampler"] == pytest.approx(16 * 90000 * 24 / PEAK_HBM_BYTES)
    assert least["total"] == pytest.approx(sum(v for k, v in least.items() if k != "total"))


def test_kernel_bounds_match_the_quoted_ones():
    bounds = flops.kernel_bounds(MODEL)
    launches, k1 = bounds["nn_exact"]
    # (48, 30000) x 6400, 9 operations a pair at 67 TFLOP/s: 1.2380 ms a launch
    assert launches == 2 and k1 / 2 == pytest.approx(48 * 30000 * 6400 * 9 / PEAK_OPS["fp32"])
    assert k1 / 2 * 1e3 == pytest.approx(1.2380, abs=5e-5)
    # K2: (48, 30000) -> 6400, one launch: 0.0080 ms
    assert bounds["segsum_sorted"][0] == 1
    assert bounds["segsum_sorted"][1] * 1e3 == pytest.approx(0.0080, abs=5e-5)


def test_tf32_linear_rounds_every_product():
    """The TF32 control's product: the forward on TF32-rounded operands, and
    each product of the backward on its own rounded operands; a float32
    product on the same inputs differs from it."""
    from benchmark.reference.autoencoder import _Tf32Linear
    from benchmark.reference.touch import tf32

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 5, 7, generator=gen, requires_grad=True)
    w = torch.randn(3, 7, generator=gen, requires_grad=True)
    b = torch.randn(3, generator=gen, requires_grad=True)
    g = torch.randn(2, 5, 3, generator=gen)
    y = _Tf32Linear.apply(x, w, b)
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), g)
    xt, wt, gt = tf32(x.detach()), tf32(w.detach()), tf32(g)
    assert torch.equal(y, torch.nn.functional.linear(xt, wt, b))
    assert torch.equal(gx, gt @ wt)
    assert torch.equal(gw, gt.flatten(0, 1).T @ xt.flatten(0, 1))
    assert torch.equal(gb, g.flatten(0, 1).sum(0))
    assert not torch.equal(y, torch.nn.functional.linear(x, w, b))


def test_out_grad_gap_sees_a_vector_the_norms_miss():
    """Two gradients of equal norms but other directions read as far apart
    as they are, over the reference's norm, the worst leaf of those asked;
    equal ones read 0; a shape that differs reads inf."""
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0])}
    same = {k: v.clone() for k, v in ref.items()}
    assert runner.out_grad_gap(same, ref, ["a", "b"]) == (0.0, "")
    gap, at = runner.out_grad_gap({**same, "a": torch.tensor([4.0, 3.0])}, ref, ["a", "b"])
    assert at == "a" and gap == pytest.approx(2 ** 0.5 / 5)
    assert runner.out_grad_gap({**same, "b": torch.zeros(3)}, ref, ["a", "b"])[0] == float("inf")
