"""The trainers' train step replayed from one CUDA graph (``train/base.py``).

On the CPU: the rule by which a step replays (:func:`graph_key`), case by
case; the CPU's steps all eager; Adam's ``capturable`` turned on and off,
and a capturing engine's checkpoint training on the CPU; the recorder
carrying a capture's counters to its replays; ``host_syncs`` sorting a
block's warnings; ``to_device`` on a CPU engine taking each value as it
is, and the values the staged route sends.  Marked ``cuda`` (skipped
without a card): a replayed touch, vision and autoencoder step against an
eager twin from the same weights on the same batches and draws, the
counters and the kernels' launches in a device trace, a recapture after
``load_state_dict``, a batch of another shape, and a step that
synchronises the host staying eager; the staged batch copy: held batches
arriving whole beside a busy card, no host sync, replayed steps fed by it
against steps fed by synchronous copies, and its counters.  This file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest tests/test_torch_step_graph.py --noconftest -q
"""

import copy
import warnings

import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    TouchConfig,
    VisionConfig,
)
from active_3d_vision_and_touch_tpu_torch.core.device import on_host
from active_3d_vision_and_touch_tpu_torch.ops import NN_EXACT, SEGSUM, draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine
from active_3d_vision_and_touch_tpu_torch.train.base import (
    WARMUP_STEPS,
    capturable_,
    graph_key,
    host_syncs,
)
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from active_3d_vision_and_touch_tpu_torch.utils import profiler

ROWS, POINTS = 4, 200
NOISE = draw_sample_noise(ROWS, POINTS)
TOUCH = dict(batch_size=8, num_samples=300, lr=1e-3, eval=True)
# no image: the camera's projection copies its matrix from host memory, a
# step that synchronises the host, which a capture refuses
VISION = dict(use_img=False, use_touch=True, finger=False, batch_size=2, number_points=400,
              num_gcn_layers=3, hidden_gcn_size=32, num_cnn_blocks=3, loss_nn="exact",
              lr=1e-3, eval=True)
# the autoencoder's own sizes, over a frozen vision model of ``VISION``
AE = dict(encoding_size=16, grid_size=8, num_gcn_layers=2, hidden_gcn_size=16)
COUNTERS = ("recon.eager_steps", "recon.graph_captures", "recon.graph_replays")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _batch(shape_rows=ROWS, dtype=torch.float32, key="samples"):
    return {"sim_touch": torch.zeros(shape_rows, 5, 5, 3, dtype=dtype),
            key: torch.zeros(shape_rows, 10, 3, dtype=dtype)}


# (device, group, batch, noise) of a step against the captured step's key
# (a CUDA device, no group, ``_batch()``, ``NOISE``); True where it replays
KEY_CASES = {
    "same shapes": ("cuda", None, _batch(), NOISE, True),
    "the cpu": ("cpu", None, _batch(), NOISE, False),
    "a process group": ("cuda", object(), _batch(), NOISE, False),
    "another batch shape": ("cuda", None, _batch(ROWS + 1), NOISE, False),
    "another dtype": ("cuda", None, _batch(dtype=torch.float64), NOISE, False),
    "another key": ("cuda", None, _batch(key="gt_points"), NOISE, False),
    "other draws": ("cuda", None, _batch(), draw_sample_noise(ROWS, 2 * POINTS), False),
}


@pytest.mark.parametrize("case", KEY_CASES, ids=str)
def test_graph_key_rule(case):
    """A step replays the graph captured for its key alone; the CPU and a
    process group give no key, so every step there is eager."""
    device, group, batch, noise, replays = KEY_CASES[case]
    captured = graph_key(torch.device("cuda"), None, _batch(), NOISE)
    key = graph_key(torch.device(device), group, batch, noise)
    assert captured is not None
    assert (key is not None and key == captured) is replays
    if device == "cpu" or group is not None:
        assert key is None


def _touch_batch(rng, b, num):
    rot = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0].astype(np.float32)
    return {
        "sim_touch": rng.uniform(size=(b, 121, 121, 3)).astype(np.float32),
        "ref_pos": (rng.normal(size=(b, 3)) * 0.1).astype(np.float32),
        "ref_rot": rot,
        "samples": (rng.normal(size=(b, num, 3)) * 0.01).astype(np.float32),
    }


def _vision_batch(rng, b, num):
    touch = (rng.normal(size=(b, 5, 4, 25, 4)) * 0.1).astype(np.float32)
    touch[..., 3] = rng.integers(0, 3, size=touch.shape[:-1])
    return {
        "img": rng.uniform(size=(b, 64, 64, 3)).astype(np.float32),
        "gt_points": (rng.normal(size=(b, num, 3)) * 0.1).astype(np.float32),
        "touch_charts": touch,
    }


def _engine(kind, tmp_path, device, **overrides):
    if kind == "touch":
        cfg = TouchConfig(**{**TOUCH, **overrides}, experiments_root=str(tmp_path))
        return TouchEngine(cfg, device=device, log=False), _touch_batch, cfg.num_samples
    cfg = VisionConfig(**{**VISION, **overrides}, experiments_root=str(tmp_path))
    vision = VisionEngine(cfg, device=device, log=False)
    if kind == "vision":
        return vision, _vision_batch, cfg.number_points
    cfg = AutoencoderConfig(**{**VISION, **AE, **overrides}, experiments_root=str(tmp_path))
    engine = AutoencoderEngine(cfg, vision_engine=vision, device=device, log=False)
    return engine, _vision_batch, cfg.number_points


def _counters():
    snap = profiler.snapshot()["counters"]
    return {name: snap.get(name, 0) for name in COUNTERS}


@pytest.mark.parametrize("kind", ["touch", "vision"])
def test_cpu_steps_are_all_eager(tmp_path, rng, kind):
    """On the CPU no step is captured: every step counts as eager, Adam is
    the plain one, and the generator's path is the sampler's own."""
    engine, make, points = _engine(kind, tmp_path, "cpu")
    batch = engine.to_device(make(rng, engine.config.batch_size, points))
    profiler.reset()
    losses = [engine.train_step(batch, engine.step_generator(i)) for i in range(WARMUP_STEPS + 2)]
    assert all(torch.isfinite(x) for x in losses)
    assert _counters() == {"recon.eager_steps": WARMUP_STEPS + 2, "recon.graph_captures": 0,
                           "recon.graph_replays": 0}
    assert engine._graph is None
    assert not engine.optimizer.defaults["capturable"]


def test_recount_carries_a_capture_to_its_replays():
    """``counted`` sees what a block adds to the counters; ``recount`` takes
    a capture's back and adds it per replay.  The kernels' launch counts
    are not the recorder's to change."""
    profiler.reset()
    before = NN_EXACT.launches
    try:
        profiler.count("recon.eager_steps")
        with profiler.counted() as added:
            profiler.count("touch.charts", 64)
            NN_EXACT.launches += 2
        assert added == {"touch.charts": 64}
        profiler.recount(added, -1)
        assert profiler.snapshot()["counters"]["touch.charts"] == 0
        for _ in range(3):
            profiler.recount(added)
        assert profiler.snapshot()["counters"] == {"recon.eager_steps": 1, "touch.charts": 192}
        assert NN_EXACT.launches == before + 2
    finally:
        NN_EXACT.launches = before
        profiler.reset()


def test_capturable_moves_adams_step_counts():
    """``capturable_`` turns Adam's flag and puts its step counts beside
    the parameters (on) or on the host (off), where Adam looks for them;
    the moments stay."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=1e-3)
    capturable_(opt, True)  # no state yet: the flag alone
    assert opt.param_groups[0]["capturable"] and not opt.state
    capturable_(opt, False)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    moment = opt.state[p]["exp_avg"].clone()
    capturable_(opt, True)
    assert opt.param_groups[0]["capturable"]
    assert opt.state[p]["step"].device == p.device and float(opt.state[p]["step"]) == 1
    capturable_(opt, False)
    assert not opt.param_groups[0]["capturable"]
    assert opt.state[p]["step"].device.type == "cpu" and opt.state[p]["step"].dtype == torch.float32
    assert torch.equal(opt.state[p]["exp_avg"], moment)


def test_a_capturing_engines_checkpoint_trains_on_the_cpu(tmp_path, rng):
    """A state saved while a graph held Adam's step carries Adam's
    ``capturable``; ``load_state_dict`` turns it off, so the state loads
    and trains where no graph runs, as the plain Adam's state does."""
    engine, make, points = _engine("touch", tmp_path, "cpu")
    batch = engine.to_device(make(rng, engine.config.batch_size, points))
    engine.train_step(batch, engine.step_generator(0))
    state = copy.deepcopy(engine.state_dict())
    state["optimizer"]["param_groups"][0]["capturable"] = True
    twin, _, _ = _engine("touch", tmp_path / "twin", "cpu")
    twin.load_state_dict(state)
    assert not twin.optimizer.param_groups[0]["capturable"]
    want = engine.train_step(batch, engine.step_generator(1))
    got = twin.train_step(batch, engine.step_generator(1))
    assert torch.equal(got, want)
    for a, b in zip(twin.model.parameters(), engine.model.parameters()):
        assert torch.equal(a, b)


def test_host_syncs_sorts_the_blocks_warnings(monkeypatch):
    """``host_syncs`` turns torch's sync debug mode to "warn" for its block
    and back, keeps the warnings of operations that synchronised the host,
    drops the mode's own notice and issues the block's other warnings
    again.  (The mode itself needs a card; it is replaced here.)"""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with host_syncs() as syncs:
            warnings.warn("Synchronization debug mode is a prototype feature")
            warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("something else")
    assert modes == [0, "warn", 0]
    assert [str(w.message) for w in syncs] == ["called a synchronizing CUDA operation"]
    assert [str(w.message) for w in outer] == ["something else"]


def test_cpu_to_device_takes_each_value_as_it_is(tmp_path, rng):
    """On a CPU engine ``to_device`` keeps the route it always had: float32
    tensors equal to the arrays (a float64 one rounded as numpy rounds it),
    ``names`` left behind, a float32 tensor passed through as itself, and
    no batch counted as staged."""
    engine, make, points = _engine("touch", tmp_path, "cpu")
    host = make(rng, 3, points)
    host["samples"] = host["samples"].astype(np.float64)
    tensor = torch.from_numpy(host.pop("ref_rot"))
    profiler.reset()
    out = engine.to_device({"names": [("obj", 0, 1)] * 3, **host, "ref_rot": tensor})
    assert list(out) == [*host, "ref_rot"]
    for k, v in host.items():
        assert out[k].dtype == torch.float32 and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v.astype(np.float32))
    assert out["ref_rot"] is tensor
    assert "recon.staged_batches" not in profiler.snapshot()["counters"]


# a batch value, and whether a CUDA engine stages it (it lives on the host)
HOST_CASES = {
    "numpy": (np.zeros((2, 3), np.float64), True),
    "a list": ([[0.0, 1.0]], True),
    "a cpu tensor": (torch.zeros(2, 3), True),
    "a device tensor": (torch.empty(2, 3, device="meta"), False),
}


@pytest.mark.parametrize("case", HOST_CASES, ids=str)
def test_on_host_picks_the_staged_values(case):
    """The staged route takes the values that live in host memory; a tensor
    already on a device is taken as it is."""
    value, staged = HOST_CASES[case]
    assert on_host(value) is staged


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def deterministic(monkeypatch):
    """Deterministic kernels (the sampler backward's ``index_add_``,
    cuDNN's backward), so that two runs of one step agree: a touch training
    otherwise parts by several percent within 6 steps, since Adam moves
    every element whose gradient is rounding noise by about ``lr``."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def _steps(kind, tmp_path, device, rng, n=6):
    """An engine on the card and ``n`` steps' batches and draws."""
    engine, make, points = _engine(kind, tmp_path, device)
    b = engine.config.batch_size
    batches = [engine.to_device(make(rng, b, points)) for _ in range(n)]
    gen = torch.Generator(device=device).manual_seed(7)
    draws = [draw_sample_noise(b, 3 * points, gen, device) for _ in range(n)]
    return engine, batches, draws


def _device_launches(fn) -> dict:
    """``fn()``'s launches of K1 and K2 on the card, from a device trace
    (a replay runs its kernels without calling ``CudaKernel.launch``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k.name: sum(f"{k.name}_kernel" in n for n in names) for k in (NN_EXACT, SEGSUM)}


def _state(engine):
    """Parameters, BatchNorm running statistics and Adam's moments by name."""
    out = {f"param {k}": v.detach().clone() for k, v in engine.model.named_parameters()}
    out.update({f"buffer {k}": v.clone() for k, v in engine.model.named_buffers()})
    for name, p in engine.model.named_parameters():
        for moment in ("exp_avg", "exp_avg_sq"):
            out[f"{moment} {name}"] = engine.optimizer.state[p][moment].clone()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["touch", "vision", "autoencoder"])
def test_replayed_steps_match_their_eager_twin(tmp_path, rng, cuda_device, deterministic, kind):
    """Two engines from the same weights run 6 steps on the same batches
    and draws, one through ``train_step`` (2 warm-up steps, a capture, 3
    replays), one eagerly (``_eager_step``, the CPU's route, its Adam
    turned capturable where the other's capture turns it), with
    deterministic kernels.  The autoencoder's step runs its frozen vision
    model without gradients inside the graph.  The losses agree to 1e-6
    relative, and each parameter, running statistic and Adam moment to
    1e-6 of its norm."""
    graphed, batches, draws = _steps(kind, tmp_path / "graph", cuda_device, rng)
    eager, _, _ = _engine(kind, tmp_path / "eager", cuda_device)
    eager.model.load_state_dict(graphed.model.state_dict())
    if kind == "autoencoder":
        eager.vision.model.load_state_dict(graphed.vision.model.state_dict())
    profiler.reset()
    got, want = [], []
    for i, (batch, d) in enumerate(zip(batches, draws)):
        got.append(float(graphed.train_step(batch, draws=d)))
        if i == WARMUP_STEPS:
            capturable_(eager.optimizer, True)
        eager.model.train()
        want.append(float(eager._eager_step(batch, None, d)))
    assert _counters() == {"recon.eager_steps": 2, "recon.graph_captures": 1, "recon.graph_replays": 3}
    np.testing.assert_allclose(got, want, rtol=1e-6)
    a, b = _state(graphed), _state(eager)
    far = {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double())
                    / max(float(torch.linalg.vector_norm(b[k].double())), 1e-30))
           for k in b if b[k].is_floating_point()}
    assert max(far.values()) <= 1e-6, sorted(far.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.cuda
def test_counters_and_launches_after_six_steps(tmp_path, rng, cuda_device):
    """6 touch steps of one shape: 2 eager, 1 capture, 3 replays; each step
    counts its rows in ``touch.charts``, and the device trace holds each
    step's 2 + 2 kernel launches.  ``CudaKernel.launches`` counts the
    launch calls: the eager steps' and the capture's, which the first
    replay runs."""
    engine, batches, draws = _steps("touch", tmp_path, cuda_device, rng)
    profiler.reset()
    k1, k2 = NN_EXACT.launches, SEGSUM.launches
    losses = []
    ran = _device_launches(lambda: losses.extend(
        engine.train_step(batch, draws=d) for batch, d in zip(batches, draws)))
    assert _counters() == {"recon.eager_steps": 2, "recon.graph_captures": 1, "recon.graph_replays": 3}
    assert profiler.snapshot()["counters"]["touch.charts"] == 6 * TOUCH["batch_size"]
    assert ran == {NN_EXACT.name: 12, SEGSUM.name: 12}
    assert (NN_EXACT.launches - k1, SEGSUM.launches - k2) == (6, 6)
    # each step's loss is its own: no replay overwrote an earlier one
    assert len({float(x) for x in losses}) == 6


@pytest.mark.cuda
def test_load_state_dict_recaptures(tmp_path, rng, cuda_device):
    """``load_state_dict`` drops the graph: the next steps of the same
    shape warm up and capture again before they replay."""
    engine, batches, draws = _steps("touch", tmp_path, cuda_device, rng)
    state = copy.deepcopy(engine.state_dict())
    profiler.reset()
    for batch, d in zip(batches[:3], draws[:3]):
        engine.train_step(batch, draws=d)
    assert engine.optimizer.param_groups[0]["capturable"]
    engine.load_state_dict(state)
    assert engine._graph is None and not engine.optimizer.param_groups[0]["capturable"]
    for batch, d in zip(batches[3:], draws[3:]):
        engine.train_step(batch, draws=d)
    assert _counters() == {"recon.eager_steps": 4, "recon.graph_captures": 2, "recon.graph_replays": 0}
    engine.train_step(batches[0], draws=draws[0])
    assert _counters()["recon.graph_replays"] == 1


@pytest.mark.cuda
def test_another_shape_runs_eagerly(tmp_path, rng, cuda_device):
    """After a capture, a batch of fewer rows (a short last batch) runs
    eagerly and counts as such; the next one, drawn from a generator as
    the sampler draws, has the loss of an eager twin from the same state."""
    engine, batches, draws = _steps("touch", tmp_path, cuda_device, rng, n=3)
    for batch, d in zip(batches, draws):
        engine.train_step(batch, draws=d)
    short = {k: v[:3] for k, v in batches[0].items()}
    profiler.reset()
    loss = engine.train_step(short, engine.step_generator(5))
    assert _counters() == {"recon.eager_steps": 1, "recon.graph_captures": 0, "recon.graph_replays": 0}
    twin, _, _ = _engine("touch", tmp_path / "twin", cuda_device)
    twin.load_state_dict(copy.deepcopy(engine.state_dict()))
    twin.model.train()
    want = twin._eager_step(short, engine.step_generator(6), None)
    got = engine.train_step(short, engine.step_generator(6))
    assert torch.isfinite(loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.cuda
def test_a_step_that_syncs_the_host_stays_eager(tmp_path, rng, cuda_device):
    """A vision step with an image projects through the camera, whose
    matrix is copied from host memory: the first warm-up step sees the
    sync, and the key is never captured."""
    _, batches, draws = _steps("vision", tmp_path, cuda_device, rng, n=4)
    engine, _, _ = _engine("vision", tmp_path / "img", cuda_device, use_img=True)
    profiler.reset()
    for batch, d in zip(batches, draws):
        assert torch.isfinite(engine.train_step(batch, draws=d))
    assert _counters() == {"recon.eager_steps": 4, "recon.graph_captures": 0, "recon.graph_replays": 0}
    assert not engine._graph.capturable


# the staged batch copy: ``touch.train``'s batch, and a product that keeps the
# card busy for tens of milliseconds while the copies are queued beside it
STAGED_ROWS, STAGED_POINTS, BUSY = 64, 4000, 8192


def _busy(device):
    a = torch.randn(BUSY, BUSY, device=device)
    return lambda: a @ a


@pytest.mark.cuda
def test_staged_batches_arrive_whole_and_stay_the_callers(tmp_path, rng, cuda_device):
    """6 staged batches, each call followed by a product on the current
    stream, and a dropped batch between them whose blocks the allocator may
    hand out again: every held batch equals its host source bit for bit
    after one synchronize, although each source was overwritten as soon as
    its call returned (the staging copies it) and later calls staged into
    reused pinned blocks."""
    engine, make, _ = _engine("touch", tmp_path, cuda_device)
    busy = _busy(cuda_device)
    hosts = [make(rng, STAGED_ROWS, STAGED_POINTS) for _ in range(12)]
    want = [{k: v.copy() for k, v in host.items()} for host in hosts[::2]]
    held = []
    for host, dropped in zip(hosts[::2], hosts[1::2]):
        held.append(engine.to_device(host))
        for v in host.values():
            v[...] = np.nan
        busy()
        engine.to_device(dropped)
    torch.cuda.synchronize()
    for got, src in zip(held, want):
        assert list(got) == list(src)
        for k, v in src.items():
            assert got[k].dtype == torch.float32 and got[k].device.type == "cuda"
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k


@pytest.mark.cuda
def test_staged_route_never_syncs_the_host(tmp_path, rng, cuda_device):
    """After the first call (which makes the copy stream), staging a host
    batch beside a busy card runs under torch's sync debug mode "error":
    the copies are pinned and the consumer waits by an event, and the
    in-flight bound blocks on an event, never on a stream or the device."""
    engine, make, _ = _engine("touch", tmp_path, cuda_device)
    busy = _busy(cuda_device)
    hosts = [make(rng, STAGED_ROWS, STAGED_POINTS) for _ in range(5)]
    engine.to_device(hosts[0])
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for host in hosts[1:]:
            engine.to_device(host)
            busy()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_staged_steps_match_steps_on_synchronous_copies(tmp_path, rng, cuda_device, deterministic):
    """Two touch engines from the same weights run 8 steps (2 warm-up, a
    capture, 5 replays) on the same host batches and draws: one fed by
    ``to_device``'s staged route a batch at a time, losses left on the card
    so the host runs ahead, the other by a synchronous ``torch.as_tensor``
    copy.  The losses agree to 1e-6 relative, each parameter, running
    statistic and Adam moment to 1e-6 of its norm, as a replay and its
    eager twin do."""
    staged, make, points = _engine("touch", tmp_path / "staged", cuda_device)
    plain, _, _ = _engine("touch", tmp_path / "plain", cuda_device)
    plain.model.load_state_dict(staged.model.state_dict())
    b, n = staged.config.batch_size, 8
    hosts = [make(rng, b, points) for _ in range(n)]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    draws = [draw_sample_noise(b, 3 * points, gen, cuda_device) for _ in range(n)]
    profiler.reset()
    got = [staged.train_step(staged.to_device(h), draws=d) for h, d in zip(hosts, draws)]
    got = [float(x) for x in got]
    assert _counters() == {"recon.eager_steps": 2, "recon.graph_captures": 1, "recon.graph_replays": 5}
    assert profiler.snapshot()["counters"]["recon.staged_batches"] == n
    want = [float(plain.train_step({k: torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
                                    for k, v in h.items()}, draws=d))
            for h, d in zip(hosts, draws)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    a, b = _state(staged), _state(plain)
    far = {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double())
                    / max(float(torch.linalg.vector_norm(b[k].double())), 1e-30))
           for k in b if b[k].is_floating_point()}
    assert max(far.values()) <= 1e-6, sorted(far.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.cuda
def test_staged_route_counts_its_batches_and_waits(tmp_path, rng, cuda_device):
    """``recon.staged_batches`` counts each call that staged a host batch,
    not one whose values are all on the card already; with a product of
    tens of milliseconds queued after each call, the host blocks on the
    in-flight bound (``recon.staging_waits``) at least once, and never at
    the first call, which has no step before it."""
    engine, make, _ = _engine("touch", tmp_path, cuda_device)
    busy = _busy(cuda_device)
    calls = 5
    hosts = [make(rng, STAGED_ROWS, STAGED_POINTS) for _ in range(calls)]
    profiler.reset()
    for host in hosts:
        engine.to_device(host)
        busy()
    on_card = engine.to_device({k: torch.as_tensor(v, device=cuda_device)
                                for k, v in make(rng, 2, 10).items()})
    torch.cuda.synchronize()
    counters = profiler.snapshot()["counters"]
    assert all(v.device.type == "cuda" for v in on_card.values())
    assert counters["recon.staged_batches"] == calls
    assert 1 <= counters.get("recon.staging_waits", 0) <= calls - 1
