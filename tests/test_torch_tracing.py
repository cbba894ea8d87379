"""The port's recorder (``utils/profiler.py``: ``span``, ``count``,
``snapshot``, ``reset``) and the spans and counters the port's layers
emit, on the CPU at tiny sizes.

A span records, and enters ``torch.profiler.record_function``, only under
an active profiler; counters count always.  The layers are driven on a
world written here from numpy (4 objects, a chart cache that answers every
grasp, each object's mesh for the env's default simulator, which loads
none of them while the chart cache answers)."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from active_3d_vision_and_touch_tpu_torch.active import ActiveTouchEnv
from active_3d_vision_and_touch_tpu_torch.active.policies.ddqn import DDQNEngine
from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    PolicyConfig,
    TouchConfig,
    VisionConfig,
)
from active_3d_vision_and_touch_tpu_torch.data import object_dirs, random_object
from active_3d_vision_and_touch_tpu_torch.data.datasets import ActiveDataset, Loader
from active_3d_vision_and_touch_tpu_torch.models import MeshAutoEncoder
from active_3d_vision_and_touch_tpu_torch.ops import NN_EXACT
from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from active_3d_vision_and_touch_tpu_torch.utils import profiler

B, ACTIONS, POINTS = 2, 4, 128
NAMES = [f"{i:06d}" for i in range(4)]
SMALL = dict(
    use_img=True, use_touch=True, finger=False, num_gcn_layers=2, hidden_gcn_size=16,
    num_cnn_blocks=3, layers_per_block=1, number_points=POINTS, env_batch_size=B, budget=2, num_grasps=2,
    num_actions=ACTIONS, use_latent=True, eval=True,
)
AE = dict(encoding_size=16, grid_size=8, num_gcn_layers=2, hidden_gcn_size=16)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Each case starts from an empty recorder, on one intra-op thread
    beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset()
    yield
    profiler.reset()
    torch.set_num_threads(threads)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(records) -> dict:
    out: dict = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


# -- the recorder ----------------------------------------------------------------

def test_span_without_a_profiler_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiler.span("off.outer"):
        with profiler.span("off.inner"):
            torch.ones(3).sum()
    assert profiler.records() == []
    assert profiler.snapshot()["spans"] == {}


def test_spans_nest_keep_self_times_and_land_in_the_trace():
    """Parents from the thread's open spans, self time = duration less the
    children's, and each span a user annotation of the profiler's trace with
    the same name and count and a duration within 10% or 0.2 ms."""
    with cpu_profile() as prof:
        with profiler.span("t.warm_up"):  # the profiler's first annotation sets itself up
            pass
        with profiler.span("t.outer"):
            time.sleep(0.004)
            for _ in range(2):
                with profiler.span("t.middle"):
                    time.sleep(0.003)
                    with profiler.span("t.inner"):
                        time.sleep(0.005)
    got = by_name(r for r in profiler.records() if r.name != "t.warm_up")
    assert {n: len(v) for n, v in got.items()} == {"t.outer": 1, "t.middle": 2, "t.inner": 2}
    assert [r.parent for r in got["t.outer"]] == [None]
    assert [r.parent for r in got["t.middle"]] == ["t.outer", "t.outer"]
    assert [r.parent for r in got["t.inner"]] == ["t.middle", "t.middle"]

    def duration(r):
        return r.end_ns - r.start_ns

    (outer,) = got["t.outer"]
    assert outer.self_ns == duration(outer) - sum(duration(r) for r in got["t.middle"])
    for middle, inner in zip(got["t.middle"], got["t.inner"]):
        assert inner.start_ns >= middle.start_ns and inner.end_ns <= middle.end_ns
        assert middle.self_ns == duration(middle) - duration(inner)
        assert inner.self_ns == duration(inner)

    traced = {}
    for e in prof.events():
        if e.name in got and e.is_user_annotation:
            traced.setdefault(e.name, []).append(e.time_range.elapsed_us() * 1e3)
    assert {n: len(v) for n, v in traced.items()} == {n: len(v) for n, v in got.items()}
    for name, records in got.items():
        for mine, theirs in zip(sorted(map(duration, records)), sorted(traced[name])):
            assert abs(mine - theirs) <= max(0.1 * theirs, 0.2e6), (name, mine, theirs)

    snap = profiler.snapshot()["spans"]
    assert snap["t.middle"]["count"] == 2
    assert snap["t.outer"]["self_ms"] == pytest.approx(outer.self_ns / 1e6)
    assert snap["t.inner"]["total_ms"] == pytest.approx(sum(map(duration, got["t.inner"])) / 1e6)
    assert snap["t.inner"]["median_ms"] == pytest.approx(np.median(list(map(duration, got["t.inner"]))) / 1e6)


def test_counters_count_with_and_without_a_profiler():
    profiler.count("t.events")
    with cpu_profile():
        profiler.count("t.events", 4)
    profiler.count("t.other", 2)
    assert profiler.snapshot()["counters"] == {"t.events": 5, "t.other": 2}
    profiler.reset()
    assert profiler.snapshot()["counters"] == {}


def test_threads_lose_no_count():
    """More threads than cores, switching every microsecond: every count
    lands."""
    threads, adds = 3 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(adds):
                profiler.count("t.adds")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    assert profiler.snapshot()["counters"]["t.adds"] == threads * adds


def test_snapshot_reads_the_kernels_own_launch_counts(monkeypatch):
    monkeypatch.setattr(NN_EXACT, "launches", 7)
    launches = profiler.snapshot()["launches"]
    assert launches["nn_exact"] == 7
    assert set(launches) == {"nn_exact", "segsum_sorted", "nn_cluster", "select_chunks"}


# -- the layers ------------------------------------------------------------------

def _write_world(root, rng):
    """Images, gt clouds, a split, a chart cache of every (object, action)
    with the codes 0, 1, 2, 2 over the fingers, and each object's mesh."""
    dirs = object_dirs(root)
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i, n in enumerate(NAMES):
        mesh = random_object(i)
        np.save(os.path.join(dirs["object_info"], n + "_verts.npy"), mesh.verts)
        np.save(os.path.join(dirs["object_info"], n + "_faces.npy"), mesh.faces)
        np.save(os.path.join(dirs["images_colourful"], n + ".npy"),
                rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8))
        pts = rng.normal(size=(300, 3))
        np.save(os.path.join(dirs["point_cloud_info"], n + ".npy"),
                (0.1 * pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32))
        charts = np.zeros((ACTIONS, 4, 25, 4), np.float32)
        for a in range(ACTIONS):
            for f, code in enumerate(rng.permutation([0, 1, 2, 2])):
                pos = rng.normal(size=3) * 0.1
                charts[a, f, :, :3] = pos + (rng.normal(size=(25, 3)) * 0.01 if code == 2 else 0)
                charts[a, f, :, 3] = code
        os.makedirs(os.path.join(dirs["touch_charts"], n))
        np.save(os.path.join(dirs["touch_charts"], n, "touch_charts.npy"), charts)
    np.save(os.path.join(root, "data_split.npy"), {"RL_train": NAMES, "test": NAMES[:2], "valid": NAMES[:2]})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracing_world"))
    _write_world(root, np.random.default_rng(0))
    return root


def _env(world, root, **kw):
    cfg = PolicyConfig(**dict(SMALL, **kw), experiments_root=str(root))
    return ActiveTouchEnv(cfg, auto_model=MeshAutoEncoder(**AE), chart_cache_root=world, device="cpu")


def _first_batch(world):
    loader = Loader(ActiveDataset(world, "RL_train", use_img=True, number_points=POINTS, env_batch_size=B),
                    B, shuffle=False)
    it = iter(loader)
    batch = next(it)
    it.close()
    return batch


def test_env_reset_splits_into_its_parts_and_the_chart_cache_answers_every_grasp(world, tmp_path):
    """``reset`` emits ``env.prime_cache`` and ``env.obs`` under
    ``env.reset``, and no ``sim.load_objects``: the simulator loads an
    episode's objects at its first miss only.  A greedy step scores its
    chunks under ``env.score_candidates``, finds every grasp's signals in
    the cache (no miss, so the simulator loads and grasps nothing) and
    fetches under ``env.fetch``."""
    env = _env(world, tmp_path)
    batch = _first_batch(world)
    with cpu_profile():
        env.reset(batch)
        env.best_step()
    got = by_name(profiler.records())
    for name in ("env.prime_cache", "env.obs"):
        assert got[name][0].parent == "env.reset", name
    assert "sim.load_objects" not in got
    assert [r.parent for r in got["env.score_chunk"]] == ["env.score_candidates"]
    assert {r.parent for r in got["env.apply_signals"]} == {"env.step"}
    assert {r.parent for r in got["env.obs"]} == {"env.reset", "env.step"}
    assert {r.parent for r in got["env.fetch"]} == {"env.obs", "env.score_candidates"}
    counters = profiler.snapshot()["counters"]
    # the greedy step: all 4 actions of both rows scored, then both committed
    assert counters["env.signal_hits"] == B * ACTIONS + B
    assert counters.get("env.signal_misses", 0) == 0
    assert counters.get("sim.grasps", 0) == 0
    assert counters.get("sim.objects_loaded", 0) == 0
    assert counters.get("env.sim_loads", 0) == 0
    assert counters["env.resets"] == 1


def test_ddqn_train_epoch_emits_its_update_push_and_save(world, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = PolicyConfig(**SMALL, experiments_root=str(tmp_path), exp_id="ddqn_spans", hidden_dim=16, layers=2,
                       pretrained_recon=False, burn_in=2, train_batch_size=4, mem_capacity=16,
                       epsilon_start=0.0, epsilon_end=0.0, target_update=2)
    engine = DDQNEngine(cfg, data_root=world, env=_env(world, tmp_path))
    with cpu_profile():
        engine.train_epoch()
    got = by_name(profiler.records())
    steps = (len(NAMES) // B) * SMALL["budget"]
    assert len(got["replay.push"]) == len(got["ddqn.act"]) == len(got["ddqn.update"]) == steps
    # the replay holds a batch of 4 from the second step's push on
    assert [r.parent for r in got["ddqn.update_on"]] == ["ddqn.update"] * (steps - 1)
    assert [r.parent for r in got["replay.sample"]] == ["ddqn.update"] * (steps - 1)
    assert [r.parent for r in got["ddqn.fetch"]] == ["ddqn.update"] * (steps - 1)
    assert len(got["ddqn.target_sync"]) == steps // 2
    assert len(got["ddqn.save"]) == 1
    assert len(got["env.reset"]) == len(NAMES) // B
    assert len(got["loader.wait"]) >= len(NAMES) // B


class _SlowDataset:
    """Items that take a while to read, so the consumer waits for them."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        time.sleep(0.05)
        return i

    def collate(self, items):
        return np.asarray(items)


def test_loader_emits_its_waits_and_counts_an_empty_queue():
    with cpu_profile():
        batches = list(Loader(_SlowDataset(), 2, shuffle=False, num_threads=1))
    assert [b.tolist() for b in batches] == [[0, 1], [2, 3], [4, 5]]
    waits = by_name(profiler.records())["loader.wait"]
    assert len(waits) == len(batches) + 1  # the last get takes the end marker
    assert min(r.end_ns - r.start_ns for r in waits[:1]) >= 0.05e9  # the first waits for two reads
    assert profiler.snapshot()["counters"]["loader.starved"] >= 1


def test_touch_engine_emits_encode_and_chamfer_and_counts_its_charts(tmp_path):
    """``touch.encode`` (the encoder and the rigid transform) and
    ``touch.chamfer`` (the sampler and the Chamfer distance) under
    ``recon.forward_loss`` in training and ``recon.eval_step`` in
    evaluation, ``touch.encode`` alone in ``predict``; ``touch.charts``
    adds each forward's rows, with a profiler or without."""
    rows, g = 3, np.random.default_rng(4)
    engine = TouchEngine(TouchConfig(batch_size=rows, num_samples=64, experiments_root=str(tmp_path), eval=True),
                         device="cpu", log=False)
    batch = engine.to_device({
        "sim_touch": g.uniform(size=(rows, 121, 121, 3)),
        "ref_pos": g.normal(size=(rows, 3)) * 0.1,
        "ref_rot": np.linalg.qr(g.normal(size=(rows, 3, 3)))[0],
        "samples": g.normal(size=(rows, 100, 3)) * 0.01,
    })
    gen = engine.step_generator(0)
    with cpu_profile():
        engine.train_step(batch, gen)
        engine.eval_step(batch, gen)
        engine.predict(batch["sim_touch"], batch["ref_pos"], batch["ref_rot"])
    got = by_name(profiler.records())
    assert [r.parent for r in got["touch.encode"]] == ["recon.forward_loss", "recon.eval_step", None]
    assert [r.parent for r in got["touch.chamfer"]] == ["recon.forward_loss", "recon.eval_step"]
    assert profiler.snapshot()["counters"]["touch.charts"] == 3 * rows
    engine.predict(batch["sim_touch"][:2], batch["ref_pos"][:2], batch["ref_rot"][:2])
    assert profiler.snapshot()["counters"]["touch.charts"] == 3 * rows + 2
    assert len(profiler.records()) == sum(map(len, got.values()))  # no span without a profiler


def test_autoencoder_engine_emits_its_four_parts_and_counts_its_clouds(tmp_path):
    """``auto.deform`` (the frozen forward), ``auto.encode``, ``auto.decode``
    and ``auto.chamfer`` under ``recon.forward_loss`` in a train step and
    ``recon.eval_step`` in evaluation; ``auto.clouds`` adds each loss's
    rows, with a profiler or without."""
    small = {k: SMALL[k] for k in ("use_img", "use_touch", "finger", "num_gcn_layers", "hidden_gcn_size",
                                   "num_cnn_blocks", "layers_per_block", "number_points", "num_grasps",
                                   "num_actions")}
    rows, g = 3, np.random.default_rng(6)
    common = dict(batch_size=rows, experiments_root=str(tmp_path), eval=True)
    vision = VisionEngine(VisionConfig(**small, **common), device="cpu", log=False)
    engine = AutoencoderEngine(AutoencoderConfig(**{**small, **AE}, **common), vision_engine=vision,
                               vision_state=vision.model.state_dict(), device="cpu", log=False)
    codes = g.integers(0, 3, size=(rows, small["num_grasps"], 4, 25, 1))
    batch = engine.to_device({
        "img": g.uniform(size=(rows, 64, 64, 3)),
        "touch_charts": np.concatenate([g.normal(size=codes.shape[:-1] + (3,)) * 0.1, codes], axis=-1),
        "gt_points": g.normal(size=(rows, 200, 3)) * 0.2,
    })
    gen = engine.step_generator(0)
    with cpu_profile():
        engine.train_step(batch, gen)
        engine.eval_step(batch, gen)
    got = by_name(profiler.records())
    for name in ("auto.deform", "auto.encode", "auto.decode", "auto.chamfer"):
        assert [r.parent for r in got[name]] == ["recon.forward_loss", "recon.eval_step"], name
    assert profiler.snapshot()["counters"]["auto.clouds"] == 2 * rows
    engine.train_step(batch, gen)
    assert profiler.snapshot()["counters"]["auto.clouds"] == 3 * rows
    assert len(profiler.records()) == sum(map(len, got.values()))  # no span without a profiler
