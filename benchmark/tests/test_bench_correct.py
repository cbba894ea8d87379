"""Whole runs of each cell on the CPU at a tiny size, the harness's look
for a card skipped: a sound run comes out correct, and a run with the
timed path broken underneath comes out not correct, once for each fault
the cell can have (one chip: no exchange between chips to leave out)."""

import copy
import importlib
import shutil
import time

import pytest
import torch

from benchmark import harness

TINY = dict(num_gcn_layers=3, hidden_gcn_size=32, number_points=300, num_cnn_blocks=3)
# per configuration: 12 actions make a last short chunk of candidates, a
# replay of 4 starts updating within the warm-up
TINY_BY_CONFIG = {"vtg": dict(batch_size=4),
                  "policy_latent": dict(num_actions=12, budget=2, num_grasps=2, burn_in=4, train_batch_size=4)}


# kept for later with its files (traffic/valid_epochs.json, limits/vtg.eval.json):
# out of BENCHMARK.json while the Loader's threads make its runs unsteady
LATER = [{"name": "vtg.eval", "config": "vtg", "traffic": "valid_epochs", "chips": 1, "why": "kept for later"}]


def tiny_run(cell: str, seed: int) -> harness.Run:
    spec = harness.load_spec()
    spec["workloads"] = spec["workloads"] + [w for w in LATER if w["name"] == cell]
    run = harness.make_run(spec, cell, seed, 0.5, False, "cpu", time.perf_counter())
    run.config = copy.deepcopy(run.config)
    run.config["config"].update(TINY, **TINY_BY_CONFIG[run.entry["config"]])
    if "autoencoder" in run.config:
        run.config["autoencoder"].update(num_gcn_layers=3, hidden_gcn_size=32, encoding_size=16, grid_size=8)
    run.traffic = dict(run.traffic, world={k: 6 for k in run.traffic["world"]}, cloud_points=400,
                       image_size=64)
    for key, tiny in (("checked_update_span", 4), ("preloaded_batches", 2)):
        if key in run.traffic:
            run.traffic[key] = tiny
    return run


def outcome(cell: str, seed: int = 1) -> harness.Outcome:
    out = harness.execute(tiny_run(cell, seed))
    assert out.attempted >= 1 and out.failed == 0
    return out


def half_batch(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

    loss = VisionEngine._loss

    def first_half(self, batch, generator, draws):
        h = batch["gt_points"].shape[0] // 2
        return loss(self, {k: v[:h] for k, v in batch.items()}, generator, tuple(d[:h] for d in draws))

    monkeypatch.setattr(VisionEngine, "_loss", first_half)


def answer_altered(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.train import vision

    chamfer = vision.mesh_chamfer_distance

    def altered(*args, **kwargs):
        cd = chamfer(*args, **kwargs)
        return torch.cat([2 * cd[:1], cd[1:]])

    monkeypatch.setattr(vision, "mesh_chamfer_distance", altered)


def state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def optimizer_frozen(monkeypatch):
    """The DDQN engine's own optimizer steps nothing (the reference trains
    with ``torch.optim.Adam`` too, so the class itself stays whole)."""
    from active_3d_vision_and_touch_tpu_torch.active.policies.ddqn import DDQNEngine

    init = DDQNEngine.__init__

    def frozen(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.optimizer.step = lambda closure=None: None

    monkeypatch.setattr(DDQNEngine, "__init__", frozen)


def state_unchanged_env(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.active.env import ActiveTouchEnv

    monkeypatch.setattr(ActiveTouchEnv, "_apply_signals", lambda self, actions: None)


def half_candidates(monkeypatch):
    """Only the first row of the env batch scored; the others copy it."""
    from active_3d_vision_and_touch_tpu_torch.active.env import ActiveTouchEnv

    score = ActiveTouchEnv._score_chunk

    def first_row(self, img, base_charts, base_masks, cand_charts, cand_masks, step, gt_points, draws=None):
        out = score(self, img[:1], base_charts[:1], base_masks[:1], cand_charts[:1], cand_masks[:1],
                    step, gt_points[:1], draws)
        return out.expand(img.shape[0], -1)

    monkeypatch.setattr(ActiveTouchEnv, "_score_chunk", first_row)


def score_altered(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.active import env

    chamfer = env.mesh_chamfer_distance

    def altered(*args, **kwargs):
        cd = chamfer(*args, **kwargs)
        return torch.cat([2 * cd[:1], cd[1:]])

    monkeypatch.setattr(env, "mesh_chamfer_distance", altered)


def half_replay_batch(monkeypatch):
    from active_3d_vision_and_touch_tpu_torch.active.policies.ddqn import DDQNEngine

    update = DDQNEngine.update_on

    def first_half(self, batch):
        return update(self, {k: v[: len(v) // 2] for k, v in batch.items()})

    monkeypatch.setattr(DDQNEngine, "update_on", first_half)


END_TO_END = {"vtg.train": {"samples_per_s", "step_p95_ms", "setup_s"},
              "vtg.eval": {"samples_per_s", "step_p95_ms", "setup_s"},
              "policy_latent.greedy": {"candidates_per_s", "setup_s"},
              "policy_latent.ddqn": {"transitions_per_s", "setup_s"}}


@pytest.mark.parametrize("cell", sorted(END_TO_END))
def test_sound_run_is_correct(cell):
    out = outcome(cell)
    assert out.correct, out.checks
    assert set(out.end_to_end) == END_TO_END[cell]


@pytest.mark.parametrize("cell,fault", [
    ("vtg.train", state_unchanged), ("vtg.train", half_batch), ("vtg.train", answer_altered),
    ("vtg.eval", half_batch), ("vtg.eval", answer_altered),
    ("policy_latent.greedy", state_unchanged_env), ("policy_latent.greedy", half_candidates),
    ("policy_latent.greedy", score_altered),
    ("policy_latent.ddqn", optimizer_frozen), ("policy_latent.ddqn", half_replay_batch),
    ("policy_latent.ddqn", score_altered),
], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = outcome(cell)
    assert not out.correct, out.checks


@pytest.mark.parametrize("cell", sorted(END_TO_END))
def test_the_control_fails_a_limit(cell):
    """The reference in bfloat16, put in the program's place, reads above
    the limit of at least one of the cell's numbers."""
    run = tiny_run(cell, 2)
    runner = importlib.import_module(f"benchmark.runners.{run.traffic['runner']}")
    try:
        lines = {line["variant"]: line for line in runner.control(run, {"bf16": dict(dtype=torch.bfloat16)})}
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    assert all(lines["program"][k] <= v for k, v in run.limits.items()), lines["program"]
    assert any(lines["bf16"][k] > v for k, v in run.limits.items()), lines["bf16"]
