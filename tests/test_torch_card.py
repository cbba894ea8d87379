"""The port's checks on the card that no other test makes, at the paths' own
widths.

Every test here is marked ``cuda`` and skips without a card.  With
``test_torch_kernels.py`` (each kernel against its plain version on the
seeded cases) and ``test_torch_step_graph.py`` (a replayed train step
against its eager twin), this file is the port's whole check on the card.
It imports torch and the port only, so on a machine without JAX:

    python -m pytest tests/test_torch_kernels.py tests/test_torch_step_graph.py \\
        tests/test_torch_card.py -q -m cuda --noconftest

What it holds:

- the exact-loss v_t_g step and the autoencoder step at full width: each
  kernel's launches over 4 train steps and 1 eval step, from a device
  trace, with no outer-dimension scan among the kernels; one forward and
  backward on the kernels against the plain versions;
- the clustered loss at full width: never below the exact loss; its
  Chamfer and the sampler's backward on the kernels against the plain
  versions; the chunk table and K3 against their plain versions and K3's
  neighbours against K1's at the train step's and the shards' shapes, and
  on generated clouds;
- small configurations on the card against the CPU;
- the environment's greedy, even and nearest-neighbour episodes on a chart
  cache, a greedy episode on live grasps against the cached one, a chunk of
  scores on the kernels against the plain versions, and the native
  rasterizer against numpy;
- DDQN over the latent and over the mesh (one update against the CPU, the
  checkpoint restored) and the supervised policy;
- ``fit`` from files, dataset generation and the touch charts;
- the multi-rank layer in a one-rank NCCL group;
- the command line's subcommands and ``evaluate_detailed``'s images.

Launch calls are read from ``utils/profiler.snapshot()``; a step that may
replay a CUDA graph runs its kernels without a launch call, so there they
are read from a device trace.  Each world is written by one fixture under
pytest's temporary directories.
"""

import contextlib
import copy
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu_torch.active import ActiveTouchEnv
from active_3d_vision_and_touch_tpu_torch.active.policies.ddqn import DDQNEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.nearest import NearestNeighborEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.simple import EvenEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.supervised import SupervisedEngine
from active_3d_vision_and_touch_tpu_torch.bench import bench_batch
from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    PolicyConfig,
    TouchConfig,
    VisionConfig,
    load_config,
)
from active_3d_vision_and_touch_tpu_torch.data import (
    ActiveDataset,
    Loader,
    TouchDataset,
    VisionDataset,
    generation,
    object_dirs,
    random_object,
)
from active_3d_vision_and_touch_tpu_torch.data.generation import SPLIT_NAMES
from active_3d_vision_and_touch_tpu_torch.models import gcn as gcn_module
from active_3d_vision_and_touch_tpu_torch.models import prepare_charts
from active_3d_vision_and_touch_tpu_torch.ops import (
    KERNELS,
    NN_CLUSTER,
    NN_EXACT,
    SEGSUM,
    SELECT_CHUNKS,
)
from active_3d_vision_and_touch_tpu_torch.ops import chamfer as chamfer_module
from active_3d_vision_and_touch_tpu_torch.ops import chamfer_cluster as cluster
from active_3d_vision_and_touch_tpu_torch.ops import sample as sampler
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import (
    REPEAT,
    chamfer_distance,
    chamfer_distance_sharded,
    chamfer_shard_terms,
    min_dists,
    min_dists_plain,
)
from active_3d_vision_and_touch_tpu_torch.ops.sample import batch_sample, draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.ops.segsum import segment_sum_plain
from active_3d_vision_and_touch_tpu_torch.sim import Sampler, Scene, raster
from active_3d_vision_and_touch_tpu_torch.testing import (
    CHUNK,
    CHUNKS_PER_TILE,
    MIN_AGREEMENT,
    clustered_clouds,
    clustered_searches,
    surface_clouds,
)
from active_3d_vision_and_touch_tpu_torch.train.autoencoder import (
    AutoencoderEngine,
    build_autoencoder,
)
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from active_3d_vision_and_touch_tpu_torch.utils import profiler, viz

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
# the v_t_g train step of bench.py, with the exact loss
MAIN = dict(use_img=True, use_touch=True, finger=False, batch_size=16, number_points=30000,
            loss_nn="exact", eval=True)
N = MAIN["number_points"]
ENV_CHUNK = 10  # score_candidates' default chunk of candidates
# live against cached code-2 charts: the cache's images were truncated to
# uint8, the live ones are not.  An H100 showed 2.87e-7 at most
LIVE_CHART_TOL = 1e-5
# the generated world: 8 procedural objects of 50 grasps, 128^3 voxels and
# 30k points; the default split of those 8 names puts 3 of them, an env
# batch, in "auto_train"
GEN_OBJECTS, GEN_ACTIONS, GEN_DIM, LIVE_SPLIT = 8, 50, 128, "auto_train"
NONE = {k.name: 0 for k in KERNELS}
K1, K2, K3, SEL = NN_EXACT.name, SEGSUM.name, NN_CLUSTER.name, SELECT_CHUNKS.name


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def _cwd(cuda, tmp_path_factory):
    """A working directory of the module's own: the policies write their
    results under it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("cwd"))
        yield


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    return str(tmp_path_factory.mktemp("experiments"))


@contextlib.contextmanager
def launch_calls():
    """Yields a dict that holds, at the block's end, the hand-written
    kernels' launch calls in the block, by kernel."""
    torch.cuda.synchronize()
    before = profiler.snapshot()["launches"]
    calls: dict = {}
    yield calls
    torch.cuda.synchronize()
    calls.update({k: n - before[k] for k, n in profiler.snapshot()["launches"].items()})


def device_trace(fn):
    """``fn()`` under a device trace: its result, the hand-written kernels'
    launches that ran on the card by kernel, and the names of every kernel
    that ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, {k.name: sum(f"{k.name}_kernel" in n for n in names) for k in KERNELS}, names


# -- the trainers' paths at full width ----------------------------------------------


def _surface_gt(cfg: VisionConfig, device) -> torch.Tensor:
    """A batch's gt clouds for the clustered loss: surface-like, seeded."""
    g = torch.Generator(device=device).manual_seed(0)
    return surface_clouds(cfg.batch_size, cfg.number_points, g, device)


@pytest.fixture(scope="module")
def paths(cuda, experiments):
    """(engine, batch) of a full-width path, built at its first use:
    ``exact`` and ``clustered`` (the default loss, against surface-like gt
    clouds) v_t_g vision engines, and the autoencoder over a frozen v_t_g
    vision model of its own."""
    default_loss = {k: v for k, v in MAIN.items() if k != "loss_nn"}

    @functools.cache
    def build(name):
        if name == "autoencoder":
            vision = VisionEngine(VisionConfig(**MAIN, experiments_root=experiments), log=False)
            cfg = AutoencoderConfig(**default_loss, experiments_root=experiments)
            assert cfg.loss_nn == "exact"
            engine = AutoencoderEngine(cfg, vision_engine=vision, log=False)
        else:
            cfg = VisionConfig(**(MAIN if name == "exact" else default_loss),
                               experiments_root=experiments)
            assert cfg.loss_nn == name
            engine = VisionEngine(cfg, log=False)
        batch = bench_batch(engine.config)
        if name == "clustered":
            batch["gt_points"] = _surface_gt(engine.config, cuda)
        return engine, engine.to_device(batch)

    return build


# per path over 4 train steps and 1 eval step: 2 K1 launches a loss (both
# directions); a vision backward sums the Chamfer loss's gradient (the gt
# cloud is data) and the sampler's with K2, the autoencoder's only the one
# into the decoded cloud (the frozen mesh's samples carry no gradient)
STEP_LAUNCHES = {"exact": {K1: 2 * 5, K2: 2 * 4}, "autoencoder": {K1: 2 * 5, K2: 4}}


@pytest.mark.parametrize("name", STEP_LAUNCHES)
def test_full_width_steps_launch_each_kernel_as_the_path_needs(paths, name):
    """Finite losses; each kernel run on the card as often as the path
    needs; no outer-dimension scan (a ``cumsum`` over the sample axis,
    which the sampler's backward has no need of) among the kernels; the
    autoencoder's vision model left frozen."""
    engine, batch = paths(name)

    def steps():
        losses = [float(engine.train_step(batch, engine.step_generator(i))) for i in range(4)]
        return losses + [float(engine.eval_step(batch, engine.step_generator(100)))]

    losses, ran, names = device_trace(steps)
    assert np.isfinite(losses).all()
    assert ran == NONE | STEP_LAUNCHES[name]
    assert not any("scan_outer_dim" in n for n in names)
    if name == "autoencoder":
        assert not engine.vision.model.training


def _loss_and_grads(engine, batch: dict, seed: int = 7):
    engine.model.eval()  # running statistics: the two passes see one model
    engine.model.zero_grad(set_to_none=True)
    loss = engine._loss(batch, engine.step_generator(seed), None)
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in engine.model.parameters()]


@pytest.mark.parametrize("name", STEP_LAUNCHES)
def test_full_width_step_on_kernels_matches_plain(paths, monkeypatch, name):
    """One forward and backward on the kernels against the same on the
    plain versions (``loss_nn="xla"``, and the sampler's backward on
    ``index_add_``): the forward is bit-identical, the loss within 1e-6;
    the backward differs by the order of the sums (K2 against
    ``index_add_``; ``grid_sample``'s atomic adds), which bf16 rounding can
    amplify: each gradient within 1e-3 of its norm.  The autoencoder's runs
    with deterministic algorithms, under which two runs of its plain step
    agree to the bit; without them ``index_add_``'s atomic adds part them by
    up to 3.7e-4 of a gradient's norm (an H100).  The exact step's plain
    runs part by 2.4e-4 to 3.0e-4 with or without them, so it runs as it
    is."""
    engine, batch = paths(name)
    if name == "autoencoder":
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(name == "autoencoder")
    try:
        loss_k, grads_k = _loss_and_grads(engine, batch)
        monkeypatch.setattr(engine.config, "loss_nn", "xla")
        monkeypatch.setattr(sampler, "segment_accumulate_sorted", segment_sum_plain)
        loss_p, grads_p = _loss_and_grads(engine, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    assert abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
    assert max(float((a - b).norm() / (b.norm() + 1e-30)) for a, b in zip(grads_k, grads_p)) <= 1e-3


@pytest.fixture(scope="module")
def clustered_samples(paths):
    """The clustered path's deformed meshes (BatchNorms on their running
    statistics), the sampler's draws for 3 x 30k samples of each, and those
    samples folded onto the batch, (48, 30000, 3)."""
    engine, batch = paths("clustered")
    engine.model.eval()
    with torch.no_grad():
        charts = prepare_charts(batch["touch_charts"], engine.initial_mesh, 16)
        verts, _ = engine.model(batch["img"], charts, engine.adj, engine.original_adj)
    draws = draw_sample_noise(16, REPEAT * N, engine.step_generator(8), verts.device)
    pts = batch_sample(verts, engine.faces, REPEAT * N, draws=draws)
    return verts, draws, torch.cat(torch.split(pts, N, dim=1), 0).contiguous()


def test_sampler_backward_at_the_step_shapes_matches_plain(paths, clustered_samples, monkeypatch):
    """The sampler's backward alone at the step's shapes (16 meshes, 90000
    samples each): K2 against ``index_add_``, within 1e-5 x (1 + Σ|w g|)
    (the barycentric weights are positive: the backward of |g| is Σ|w g|)."""
    engine, _ = paths("clustered")
    verts, draws, _ = clustered_samples
    cot = torch.randn(16, REPEAT * N, 3, device=verts.device, generator=engine.step_generator(9))

    def backward(cotangent):
        v = verts.detach().clone().requires_grad_()
        return torch.autograd.grad(batch_sample(v, engine.faces, REPEAT * N, draws=draws), v, cotangent)[0]

    on_kernel = backward(cot)
    monkeypatch.setattr(sampler, "segment_accumulate_sorted", segment_sum_plain)
    assert bool(((on_kernel - backward(cot)).abs() <= 1e-5 * (1 + backward(cot.abs()))).all())


def test_clustered_chamfer_on_kernels_matches_plain(paths, clustered_samples):
    """``chamfer_clustered_tiled_gt`` at (48, 30000) x (16, 30000) on the
    kernels against ``plain=True``: the value equal (the same arithmetic on
    the same neighbours), the x-gradient within 1e-5 of its largest element
    (the order of ``index_add_``'s atomic adds)."""
    _, batch = paths("clustered")
    out = {}
    for plain in (False, True):
        x = clustered_samples[2].clone().requires_grad_()
        cd = cluster.chamfer_clustered_tiled_gt(x, batch["gt_points"], REPEAT, plain=plain)
        out[plain] = (cd.detach(), torch.autograd.grad(cd.sum(), x)[0])
    assert float((out[False][0] - out[True][0]).abs().max()) == 0.0
    grad_err = float((out[False][1] - out[True][1]).abs().max())
    assert grad_err <= 1e-5 * float(out[True][1].abs().max())


def test_clustered_loss_is_never_below_the_exact_one(paths, monkeypatch):
    """On the same batch and draws: a pruned search can miss a neighbour,
    never find a nearer one."""
    engine, batch = paths("clustered")
    loss_c, _ = _loss_and_grads(engine, batch)
    monkeypatch.setattr(engine.config, "loss_nn", "exact")
    loss_e, _ = _loss_and_grads(engine, batch)
    assert loss_c >= loss_e * (1 - 1e-6)


@pytest.fixture(scope="module")
def searches(cuda):
    """``testing.clustered_searches``: both directions of the clustered
    train step's search and of one shard's, from one seed."""
    return clustered_searches(clustered_clouds(torch.Generator(device=cuda).manual_seed(1), cuda, N))


@pytest.mark.parametrize("name", ["train step x->y", "train step y->x", "shard x->y", "shard y->x"])
def test_clustered_search_against_plain_and_exact(searches, name):
    """The chunk table and K3 against their plain versions, index for index
    (tolerance 0); K3's neighbours against K1's, the oracle: never nearer,
    and at the train step the same distance for at least MIN_AGREEMENT of
    the queries."""
    xs, ys, ys_tiled = searches[name]
    ids = cluster.select_chunks(xs, ys, CHUNK, CHUNKS_PER_TILE)
    assert ids.dtype == torch.int32
    assert torch.equal(ids, cluster.select_chunks_plain(xs, ys, CHUNK, CHUNKS_PER_TILE))
    assert int(ids.min()) >= 0 and int(ids.max()) < ys.shape[1] // CHUNK
    d, i = cluster.nn_cluster(xs, ys, ids, CHUNK)
    d_p, i_p = cluster.nn_cluster_plain(xs, ys, ids, CHUNK)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    d_exact, _ = min_dists(xs, ys_tiled)
    d_found = cluster._sq_dist(xs, cluster._take(ys_tiled, i.long()))
    assert bool((d_found >= d_exact).all())
    if name.startswith("train step"):
        assert float((d_found == d_exact).float().mean()) >= MIN_AGREEMENT


SMALL = dict(batch_size=2, number_points=256, num_gcn_layers=3, hidden_gcn_size=32,
             num_cnn_blocks=3, eval=True)
SMALL_CASES = {"exact": dict(loss_nn="exact"),
               "clustered, touch_global and touch_plane": dict(touch_global=True, touch_plane=True)}


@pytest.mark.parametrize("case", SMALL_CASES)
def test_small_width_on_the_card_matches_the_cpu(cuda, tmp_path, case):
    """A small configuration's eval loss on the card within 5e-2 of the
    CPU's on the same batch and draws (the card runs the GCN's products in
    bf16 and the convolutions in TF32), and a finite train loss on both."""
    rng = np.random.default_rng(1)
    data = {
        "img": rng.uniform(size=(2, 64, 64, 3)).astype(np.float32),
        "gt_points": (rng.normal(size=(2, 256, 3)) * 0.1).astype(np.float32),
        "touch_charts": (rng.normal(size=(2, 5, 4, 25, 4)) * 0.1).astype(np.float32),
    }
    codes = rng.integers(0, 3, size=(2, 5, 4, 25))  # mask codes: contacts
    if case != "exact":
        data["touch_charts"][..., 3] = codes
    draws = draw_sample_noise(2, REPEAT * 256, torch.Generator().manual_seed(2))
    cfg = VisionConfig(**SMALL, **SMALL_CASES[case], experiments_root=str(tmp_path))
    losses = {}
    for device in ("cuda", "cpu"):
        engine = VisionEngine(cfg, device=device, log=False)
        d = tuple(t.to(device) for t in draws)
        losses[device] = float(engine.eval_step(engine.to_device(data), draws=d))
        assert np.isfinite(float(engine.train_step(engine.to_device(data), draws=d)))
    assert abs(losses["cuda"] - losses["cpu"]) <= 5e-2 * abs(losses["cpu"])


def _touch_batch(cfg: TouchConfig, seed: int = 0) -> dict:
    """A seeded batch shaped as the touch trainer's: gel images, fingertip
    poses and local touch clouds of a few millimetres."""
    rng = np.random.default_rng(seed)
    b = cfg.batch_size
    return {
        "sim_touch": rng.uniform(size=(b, 121, 121, 3)).astype(np.float32),
        "ref_pos": (rng.normal(size=(b, 3)) * 0.1).astype(np.float32),
        "ref_rot": np.linalg.qr(rng.normal(size=(b, 3, 3)))[0].astype(np.float32),
        "samples": (rng.normal(size=(b, cfg.num_samples, 3)) * 0.005).astype(np.float32),
    }


def test_a_touch_step_runs_no_outer_dimension_scan(cuda, tmp_path):
    """The sampler's backward sums runs of sorted face ids with K2; a
    prefix sum over the sample axis in its place (an outer-dimension scan)
    cost a fifth of a vision step.  A device trace of one touch train step
    at the default configuration holds none."""
    engine = TouchEngine(TouchConfig(eval=True, experiments_root=str(tmp_path)), log=False)
    batch = engine.to_device(_touch_batch(engine.config))
    loss, _, names = device_trace(lambda: float(engine.train_step(batch, engine.step_generator(0))))
    assert np.isfinite(loss)
    assert not any("scan_outer_dim" in n for n in names)


# -- the environment and the policies ---------------------------------------------


def _chart_cache(cloud: np.ndarray, num_actions: int, rng) -> np.ndarray:
    """A chart cache (actions, 4 fingers, 25, xyz | code) in which every
    grasp holds the three mask codes: two fingers touching (a small sheet
    about a point of the cloud), one not (collapsed onto its position), one
    failing."""
    charts = np.zeros((num_actions, 4, 25, 4), np.float32)
    for a in range(num_actions):
        for f, code in enumerate(rng.permutation([0, 1, 2, 2])):
            pos = cloud[rng.integers(len(cloud))]
            if code == 2:
                charts[a, f, :, :3] = pos + rng.normal(size=(25, 3)) * 0.003
            elif code == 1:
                charts[a, f, :, :3] = pos
            charts[a, f, :, 3] = code
    return charts


def _write_objects(root: Path, names: list, num_actions: int, device, seed: int) -> np.ndarray:
    """Per object, made from ``seed``: a 256x256 image, a surface-like gt
    cloud of 30k points and a chart cache of ``num_actions`` grasps, in the
    dataset layout the port reads.  Returns the clouds."""
    rng = np.random.default_rng(seed)
    dirs = {k: Path(v) for k, v in object_dirs(str(root)).items()}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    g = torch.Generator(device=device).manual_seed(seed + 4)
    clouds = surface_clouds(len(names), N, g, device).cpu().numpy()
    for name, cloud in zip(names, clouds):
        np.save(dirs["images_colourful"] / f"{name}.npy",
                rng.integers(0, 256, size=(256, 256, 3)).astype(np.uint8))
        np.save(dirs["point_cloud_info"] / f"{name}.npy", cloud)
        (dirs["touch_charts"] / name).mkdir(exist_ok=True)
        np.save(dirs["touch_charts"] / name / "touch_charts.npy",
                _chart_cache(cloud, num_actions, rng))
    return clouds


@pytest.fixture(scope="module")
def active_world(cuda, tmp_path_factory):
    """The dataset root the policies read: an env batch of objects in the
    splits "test" and "valid", and as many more in "RL_train" beside them,
    so that a training epoch is two env batches; each object's mesh a
    procedural one, which no grasp loads (the chart cache answers every
    signal)."""
    root = tmp_path_factory.mktemp("active_world")
    b, actions = PolicyConfig().env_batch_size, PolicyConfig().num_actions
    names = [f"object_{i:03d}" for i in range(2 * b)]
    _write_objects(root, names[:b], actions, cuda, seed=0)
    _write_objects(root, names[b:], actions, cuda, seed=1)
    info = Path(object_dirs(str(root))["object_info"])
    for i, name in enumerate(names):
        mesh = random_object(i)
        np.save(info / f"{name}_verts.npy", mesh.verts)
        np.save(info / f"{name}_faces.npy", mesh.faces)
    np.save(root / "data_split.npy", {"test": names[:b], "valid": names[:b], "RL_train": names})
    return str(root)


@pytest.fixture(scope="module")
def env(active_world, experiments):
    """The env at the default policy configuration with the latent
    observation, over a full-width frozen vision model and autoencoder from
    the seed, on the chart cache; and its first test batch."""
    cfg = PolicyConfig(use_latent=True, eval=True, experiments_root=experiments)
    env = ActiveTouchEnv(cfg, auto_model=build_autoencoder(AutoencoderConfig()),
                         chart_cache_root=active_world)
    dataset = ActiveDataset(active_world, "test", number_points=cfg.number_points,
                            env_batch_size=cfg.env_batch_size)
    yield env, next(iter(Loader(dataset, cfg.env_batch_size, shuffle=False)))
    env.sampler.disconnect()


def _observations_and_chunks(cfg: PolicyConfig, episodes: int) -> int:
    """K1's launches in greedy episodes: 2 an observation and 2 a chunk of
    candidates, every grasp scored each step."""
    chunks = -(-cfg.num_actions // ENV_CHUNK)
    return 2 * episodes * ((1 + cfg.budget) + cfg.budget * chunks)


def test_greedy_even_and_nearest_episodes(env, active_world):
    """A greedy episode that ends at the budget, then an even and a
    nearest-neighbour rollout through their engines (the nearest from the
    greedy episode's latents and actions): finite scores, and K1's 2
    launches an observation and a chunk of candidates, nothing else."""
    env, batch = env
    cfg = env.config
    with launch_calls() as calls:
        obs = env.reset(batch)
        scores, bank = [obs["score"]], []
        for _ in range(cfg.budget):
            latent = obs["latent"]
            actions, obs, _, done = env.best_step()
            scores.append(obs["score"])
            bank += list(zip(latent, actions))
        even = EvenEngine(dataclasses.replace(cfg, exp_id="even"), active_world, env=env)
        even_scores = even.evaluate("test", max_batches=1).scores
        nearest = NearestNeighborEngine(dataclasses.replace(cfg, exp_id="nn"), active_world, env=env)
        nearest.latents = [latent for latent, _ in bank]
        nearest.actions = [int(a) for _, a in bank]
        nearest_scores = nearest.evaluate("test", max_batches=1).scores
    assert done
    # 2 more episodes of 1 + budget observations, no candidates
    assert calls == NONE | {K1: _observations_and_chunks(cfg, 1) + 2 * 2 * (1 + cfg.budget)}
    assert all(np.isfinite(s).all() for s in (np.stack(scores, 1), even_scores, nearest_scores))


DDQN_KINDS = {"latent": dict(use_latent=True), "mesh": dict(use_latent=False, use_recon=True)}


@pytest.fixture(scope="module")
def ddqn(env, active_world):
    """A DDQN engine by observation, on the env, built at its first use,
    trained one epoch (two env batches: 10 env steps, updates from the 7th
    at the default burn-in of 20 transitions and batch 16) and evaluated on
    one batch: (engine, whether a checkpoint was there before, the epoch's
    stats, the evaluation, the launch calls of all of it)."""
    env, _ = env

    @functools.cache
    def train(kind):
        cfg = dataclasses.replace(env.config, exp_id=f"ddqn_{kind}", **DDQN_KINDS[kind])
        with launch_calls() as calls:
            engine = DDQNEngine(cfg, active_world, env=env)  # the default device: the card
            had_checkpoint = engine.ckpt.exists("recent")
            stats = engine.train_epoch()
            result = engine.evaluate("test", max_batches=1)
        return engine, had_checkpoint, stats, result, calls

    return train


@pytest.mark.parametrize("kind", DDQN_KINDS)
def test_ddqn_trains_an_epoch(ddqn, kind):
    """2 K1 launches an observation (2 train and 1 eval episodes of 1 +
    budget observations), no candidates and no backward; the first update
    at the env step whose transitions reach max(burn_in, batch), the 7th at
    3 a step; every transition in the replay; finite loss, reward and
    scores."""
    engine, had_checkpoint, stats, result, calls = ddqn(kind)
    cfg = engine.config
    b = cfg.env_batch_size
    assert not had_checkpoint
    assert calls == NONE | {K1: 2 * 3 * (1 + cfg.budget)}
    assert -(-max(cfg.burn_in, cfg.train_batch_size) // b) == 7
    assert engine.replay.count_seen == 2 * cfg.budget * b
    assert np.isfinite([stats["loss"], stats["reward"]]).all() and np.isfinite(result.scores).all()


@pytest.mark.parametrize("kind", DDQN_KINDS)
def test_ddqn_checkpoint_restores_the_engine(ddqn, active_world, kind):
    """A new engine of the same configuration restores the target net, the
    counters and the replay buffer."""
    engine = ddqn(kind)[0]
    again = DDQNEngine(engine.config, active_world, env=engine.env)
    assert all(torch.equal(x, y) for x, y in zip(
        again.target_model.state_dict().values(), engine.target_model.state_dict().values()))
    assert (again.epsilon, again.total_steps, again.episodes) == (
        engine.epsilon, engine.total_steps, engine.episodes)
    assert all(np.array_equal(again.replay.data[k], v) for k, v in engine.replay.data.items())


class _Bf16OnCpu(torch.autograd.Function):
    """The card's GCN product (``models/gcn.py::_Bf16Matmul``) on the CPU:
    the operands and the incoming gradient rounded to bf16, the products
    summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.bfloat16().float(), b.bfloat16().float()
        ctx.save_for_backward(a16, b16)
        return a16 @ b16

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        g16 = g.bfloat16().float()
        return g16 @ b16.T, a16.T @ g16


def _bf16_on_cpu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``models/gcn.py::_mxu_matmul``'s card path on the CPU: its fold of
    the batch, with _Bf16OnCpu as the 2-D product."""
    return gcn_module._folded_matmul(a, b, _Bf16OnCpu.apply)


# Float32 products on both sides, except the GCN's: bf16 operands on the
# card.  A gradient carries the residual q - target, a small difference of
# values of order 1, where bf16's relative error in q grows.  On an H100,
# against float32 on the CPU: the loss 1.8e-3 apart, the clamped gradients
# 2.5e-1 of their norm (5.1e-1 in one tensor), the updated nets' values
# 1.5e-2; so that comparison holds only the loss and the values, at bf16's
# size (a limit of None holds nothing).  The gradients are held against the
# card's own bf16 rounding on the CPU: 2.6e-4, 1.2e-2 (1.7e-2) and 1.7e-4,
# from the order of the sums, the sine's last bits and the bf16 roundings
# they flip.  (kind, the CPU's GCN product, limits)
UPDATE_CASES = {
    "latent, float32": ("latent", None, dict(loss=1e-4, grads=1e-4, tensor=1e-4, values=1e-4)),
    "mesh, float32": ("mesh", None, dict(loss=2e-2, grads=None, tensor=None, values=5e-2)),
    "mesh, bf16 on the CPU": ("mesh", _bf16_on_cpu,
                              dict(loss=2e-3, grads=5e-2, tensor=1e-1, values=2e-3)),
}


@pytest.mark.parametrize("case", UPDATE_CASES)
def test_ddqn_update_on_the_card_matches_the_cpu(ddqn, case):
    """One update on the card against the same on the CPU, from the same
    weights, optimizer state and replay batch: the loss, the clamped
    gradients (the norm of the difference over the norm, of all parameters
    and of the worst tensor) and the two updated nets' values on the batch,
    computed on the CPU, each within its limit; the parameters after the
    step within 2 x lr of each other (an Adam step moves a parameter by
    about lr, whatever the size of its gradient)."""
    kind, cpu_matmul, tol = UPDATE_CASES[case]
    engine = ddqn(kind)[0]
    cpu = copy.copy(engine)
    cpu.device = torch.device("cpu")
    cpu.model = copy.deepcopy(engine.model).cpu()
    cpu.target_model = copy.deepcopy(engine.target_model).cpu()
    cpu.optimizer = torch.optim.Adam(cpu.model.parameters(), lr=engine.config.lr)
    # a copy: loading keeps a tensor already on the CPU, and the card's step
    # would then move the CPU optimizer's state too
    cpu.optimizer.load_state_dict(copy.deepcopy(engine.optimizer.state_dict()))
    cpu.adj = None if engine.adj is None else engine.adj.cpu()
    batch = engine.replay.sample()
    loss_card = float(engine.update_on(batch))
    with pytest.MonkeyPatch.context() as mp:
        if cpu_matmul is not None:
            mp.setattr(gcn_module, "_mxu_matmul", cpu_matmul)
        loss_cpu = float(cpu.update_on(batch))
    grads = [(a.grad.cpu(), b.grad) for a, b in zip(engine.model.parameters(), cpu.model.parameters())]
    ratios = [float((a - b).norm() / (b.norm() + 1e-30)) for a, b in grads]
    overall = float(torch.cat([(a - b).flatten() for a, b in grads]).norm()
                    / torch.cat([b.flatten() for _, b in grads]).norm())
    moved = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(engine.model.parameters(), cpu.model.parameters()))
    with torch.no_grad():
        q_card = copy.deepcopy(engine.model).cpu()(*cpu._inputs(batch))
        q_cpu = cpu.model(*cpu._inputs(batch))
    found = dict(loss=abs(loss_card - loss_cpu) / abs(loss_cpu), grads=overall, tensor=max(ratios),
                 values=float((q_card - q_cpu).abs().max() / q_cpu.abs().max()))
    assert all(tol[k] is None or found[k] <= tol[k] for k in tol), found
    assert moved <= 2 * engine.config.lr


def test_supervised_levels_0_and_1(env, active_world):
    """The supervised policy's nets of steps 0 and 1 at 5 probes, then one
    evaluation batch: finite losses and scores; 2 K1 launches an
    observation and a chunk of probes (per level and train batch, the
    observations up to the step, then one chunk; then 1 eval episode); a
    new engine restores the nets."""
    env, _ = env
    cfg = dataclasses.replace(env.config, exp_id="supervised")
    with launch_calls() as calls:
        engine = SupervisedEngine(cfg, active_world, env=env)
        losses = [engine.train_step_level(step) for step in (0, 1)]
        result = engine.evaluate("test", max_batches=1)
    assert np.isfinite(losses).all() and np.isfinite(result.scores).all()
    observations, chunks = 2 * (1 + 2) + (1 + cfg.budget), 2 * 2
    assert calls == NONE | {K1: 2 * (observations + chunks)}
    again = SupervisedEngine(cfg, active_world, env=env)
    assert all(torch.equal(x, y) for n1, n2 in zip(again.nets, engine.nets)
               for x, y in zip(n1.state_dict().values(), n2.state_dict().values()))


# -- training from files, dataset generation, live grasps ---------------------------


@pytest.fixture(scope="module")
def training_world(cuda, tmp_path_factory):
    """A dataset for the trainers in the JAX package's layout: 32 objects in
    "recon_train" and 8 in "valid" (two training batches of the vision
    trainer's 16), each with 2 grasps of 4 touching fingers (a 121x121 gel
    image, a local cloud of 2000 to 6000 points, the sensor's frame): 4
    training batches of the touch trainer's 64 and one validation batch."""
    root = tmp_path_factory.mktemp("training_world")
    names = [f"train_{i:03d}" for i in range(32)] + [f"valid_{i:03d}" for i in range(8)]
    clouds = _write_objects(root, names, VisionConfig().num_actions, cuda, seed=2)
    rng = np.random.default_rng(5)
    grasps = Path(object_dirs(str(root))["grasp_info"])
    for name, cloud in zip(names, clouds):
        for grasp in rng.choice(50, size=2, replace=False):
            gdir = grasps / name / str(grasp)
            gdir.mkdir(parents=True)
            for finger in range(4):
                pos = cloud[rng.integers(len(cloud))]
                np.save(gdir / f"{finger}_touch.npy",
                        rng.integers(0, 256, size=(121, 121, 3)).astype(np.uint8))
                np.save(gdir / f"{finger}_points.npy",
                        (rng.normal(size=(rng.integers(2000, 6000), 3)) * 0.003).astype(np.float32))
                np.save(gdir / f"{finger}_ref_frame.npy",
                        {"pos": pos, "rot": np.linalg.qr(rng.normal(size=(3, 3)))[0]})
    np.save(root / "data_split.npy", {"recon_train": names[:32], "valid": names[32:]})
    return str(root)


@pytest.mark.parametrize("kind", ["vision", "touch"])
def test_fit_from_files(training_world, experiments, kind):
    """One ``fit`` epoch of ``VisionEngine(VisionConfig())`` (the clustered
    loss) or ``TouchEngine(TouchConfig())`` from loaders over the files, as
    the command line feeds them: each kernel run as often as the epoch's
    steps need (a vision train step 2 chunk tables, 2 pruned scans and 2
    segment sums, an eval step the first two; a touch train step 2 K1 and 2
    K2, an eval step 2 K1); a finite validation loss; best and recent
    checkpoints."""
    if kind == "vision":
        cfg = VisionConfig(epochs=1, exp_id="vision_from_files", experiments_root=experiments)
        dataset = functools.partial(
            VisionDataset, training_world, use_img=cfg.use_img, use_touch=cfg.use_touch,
            finger=cfg.finger, num_grasps=cfg.num_grasps, number_points=cfg.number_points,
            eval_mode=cfg.eval, seed=cfg.seed)
        engine = VisionEngine(cfg)
    else:
        cfg = TouchConfig(epochs=1, exp_id="touch_from_files", experiments_root=experiments)
        dataset = functools.partial(TouchDataset, training_world, num_samples=cfg.num_samples)
        engine = TouchEngine(cfg)
    train, valid = (functools.partial(Loader, dataset(split), batch_size=cfg.batch_size, shuffle=shuffle)
                    for split, shuffle in (("recon_train", True), ("valid", False)))
    steps = (len(train()), len(valid()))
    assert steps[0] >= 2 and steps[1] >= 1
    best, ran, _ = device_trace(lambda: engine.fit(train, valid))
    if kind == "vision":
        expected = {K3: 2 * sum(steps), SEL: 2 * sum(steps), K2: 2 * steps[0]}
    else:
        expected = {K1: 2 * sum(steps), K2: 2 * steps[0]}
    assert ran == NONE | expected
    assert np.isfinite(best)
    assert engine.ckpt.exists("best") and engine.ckpt.exists("recent")


@pytest.fixture(scope="module")
def generated(cuda, tmp_path_factory, experiments):
    """The port's ``generate_dataset`` of 8 procedural objects (version 3,
    50 actions, 128^3 voxels, 30k points), then ``make_touch_charts`` over
    ``TouchEngine(TouchConfig())`` on the card: (root, names, the touch
    engine, the launch calls of ``make_touch_charts``)."""
    root = tmp_path_factory.mktemp("generated_world")
    generation.generate_dataset(str(root), GEN_OBJECTS, seed=0, num_actions=GEN_ACTIONS,
                                point_dim=GEN_DIM, num_points=N, version=3)
    engine = TouchEngine(TouchConfig(experiments_root=experiments), log=False)
    with launch_calls() as calls:
        generation.make_touch_charts(str(root), engine, num_actions=GEN_ACTIONS)
    return root, [f"{i:06d}" for i in range(GEN_OBJECTS)], engine, calls


def test_touch_charts_launch_no_hand_written_kernel(generated):
    assert generated[3] == NONE


def test_generated_files_and_chart_codes(generated):
    """Every file of the dataset layout for each generated object, and its
    chart cache: shape (actions, 4, 25, 4), finite, one mask code in {0, 1,
    2} a slot, and that code the one the slot's files give: 2 where
    ``<finger>_touch.npy`` exists (with its ``_points.npy`` and
    ``_ref_frame.npy``), 1 where only ``_ref_frame.npy`` exists, else 0."""
    root, names, _, _ = generated
    dirs = {k: Path(v) for k, v in object_dirs(str(root)).items()}
    split = np.load(root / "data_split.npy", allow_pickle=True).item()
    assert set(split) == set(SPLIT_NAMES) and sorted(sum(split.values(), [])) == names
    for n in names:
        for suffix in ("_verts.npy", "_faces.npy", ".obj"):
            assert (dirs["object_info"] / f"{n}{suffix}").exists()
        cloud = np.load(dirs["point_cloud_info"] / f"{n}.npy")
        assert cloud.shape == (N, 3) and cloud.dtype == np.float32 and np.isfinite(cloud).all()
        img = np.load(dirs["images_colourful"] / f"{n}.npy")
        assert img.shape == (256, 256, 3) and img.dtype == np.uint8 and img.min() < 255
        charts = np.load(dirs["touch_charts"] / n / "touch_charts.npy")
        assert charts.shape == (GEN_ACTIONS, 4, 25, 4) and charts.dtype == np.float32
        assert np.isfinite(charts).all()
        codes = charts[..., 3]
        assert set(np.unique(codes)) <= {0.0, 1.0, 2.0} and (codes == codes[..., :1]).all()
        for a in range(GEN_ACTIONS):
            gdir = dirs["grasp_info"] / n / str(a)
            assert gdir.is_dir()
            for f in range(4):
                touch, ref, points = ((gdir / f"{f}_{kind}.npy").exists()
                                      for kind in ("touch", "ref_frame", "points"))
                assert codes[a, f, 0] == (2 if touch else 1 if ref else 0), (n, a, f)
                assert points == touch and (ref or not touch), (n, a, f)
                if touch:
                    image, local = np.load(gdir / f"{f}_touch.npy"), np.load(gdir / f"{f}_points.npy")
                    assert image.shape == (121, 121, 3) and image.dtype == np.uint8
                    assert local.ndim == 2 and 0 < len(local) <= 4096


def test_clustered_neighbours_on_generated_clouds(generated):
    """Each generated object's 30k-point cloud against a second 30k-point
    draw of the same surface (``extract_surface_points`` with another
    generator), through the sort, padding and selection of
    ``chamfer_clustered_tiled_gt`` as the vision step calls it (the draw in
    the predictions' place): no clustered distance below K1's, either
    way."""
    root, names, _, _ = generated
    dirs = object_dirs(str(root))
    y = np.stack([np.load(Path(dirs["point_cloud_info"]) / f"{n}.npy") for n in names])
    x = np.stack([generation.extract_surface_points(
        np.load(Path(dirs["object_info"]) / f"{n}_verts.npy"),
        np.load(Path(dirs["object_info"]) / f"{n}_faces.npy"),
        dim=GEN_DIM, num_points=N, rng=np.random.default_rng(1)) for n in names])
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    ys1, yperm1 = cluster._sort_by_morton(y)
    (xs, ys, _, _, _, _), dx, dy = cluster._pair_min_dists_sorted(
        x, ys1, CHUNK, CHUNKS_PER_TILE, y_sorted=(ys1, yperm1), y_distinct=y.shape[0])
    assert bool((dx >= min_dists(xs, ys)[0]).all() and (dy >= min_dists(ys, xs)[0]).all())


@pytest.fixture(scope="module")
def live(generated, experiments):
    """Two envs at the default policy configuration with the latent
    observation on the generated world, over the touch model that made its
    charts: one with its default simulator and no chart cache, one on the
    chart cache; and the test batch of the split that holds an env batch."""
    root, _, touch_engine, _ = generated
    cfg = PolicyConfig(use_latent=True, eval=True, experiments_root=experiments)
    dataset = ActiveDataset(str(root), LIVE_SPLIT, number_points=cfg.number_points,
                            env_batch_size=cfg.env_batch_size)
    assert len(dataset) == cfg.env_batch_size
    auto = build_autoencoder(AutoencoderConfig())
    envs = [ActiveTouchEnv(cfg, touch_model=copy.deepcopy(touch_engine.model), auto_model=auto,
                           chart_cache_root=cache) for cache in (None, str(root))]
    yield *envs, next(iter(Loader(dataset, cfg.env_batch_size, shuffle=False)))
    for e in envs:
        e.sampler.disconnect()


def _greedy_episode(env, batch):
    """A greedy episode: (whether it ended at the budget, the scores, the
    launch calls, the episodes whose objects the simulator loaded)."""
    loads = profiler.snapshot()["counters"].get("env.sim_loads", 0)
    with launch_calls() as calls:
        obs = env.reset(batch)
        scores = [obs["score"]]
        for _ in range(env.config.budget):
            _, obs, _, done = env.best_step()
            scores.append(obs["score"])
    return done, scores, calls, profiler.snapshot()["counters"].get("env.sim_loads", 0) - loads


def test_live_episode_matches_the_cached_one(live):
    """The live env builds its own simulator; its greedy episode grasps
    every (object, action) pair at its first step, loads the episode's
    objects once, and launches K1 as the same episode on the chart cache
    does.  Their signals for every pair: equal codes, equal positions of
    code-1 slots, code-2 charts within LIVE_CHART_TOL."""
    live_env, cached, batch = live
    assert isinstance(live_env.sampler, Sampler)
    done, scores, calls, loads = _greedy_episode(live_env, batch)
    assert done and all(np.isfinite(s).all() for s in scores)
    assert calls == NONE | {K1: _observations_and_chunks(live_env.config, 1)}
    assert loads == 1
    keys = [(str(n), a) for n in batch["names"] for a in range(live_env.config.num_actions)]
    assert all(k in live_env._sig_cache for k in keys)
    assert _greedy_episode(cached, batch)[2] == calls
    worst = 0.0
    for key in keys:
        c_live, codes, pos_live = live_env._sig_cache[key]
        c_cache, codes_cache, pos_cache = cached._sig_cache[key]
        assert np.array_equal(codes, codes_cache), key
        assert np.array_equal(pos_live[codes == 1], pos_cache[codes == 1]), key
        if (codes == 2).any():
            worst = max(worst, float(np.abs(c_live[codes == 2] - c_cache[codes == 2]).max()))
    assert worst <= LIVE_CHART_TOL


@pytest.mark.parametrize("which", ["chart cache", "live grasps"])
def test_a_chunk_of_scores_on_kernels_matches_plain(request, monkeypatch, which):
    """One chunk of candidate scores with the same draws through K1 (2
    launches) and through its plain version: finite, and the same scores to
    1e-6 (K1 is bit-exact)."""
    if which == "chart cache":
        env, batch = request.getfixturevalue("env")
    else:
        env, _, batch = request.getfixturevalue("live")
    b = env.config.env_batch_size
    env.reset(batch)
    cands = np.tile(np.arange(ENV_CHUNK), (b, 1))
    draws = draw_sample_noise(b * ENV_CHUNK, REPEAT * env.config.number_points,
                              torch.Generator(device=env.device).manual_seed(6), env.device)
    with launch_calls() as calls:
        on_kernels = env.score_candidates(cands, draws=[draws])
    monkeypatch.setattr(chamfer_module, "min_dists", min_dists_plain)
    on_plain = env.score_candidates(cands, draws=[draws])
    assert calls[K1] == 2
    assert np.isfinite(on_kernels).all()
    assert float(np.max(np.abs(on_kernels - on_plain) / np.abs(on_plain))) <= 1e-6


def test_native_rasterizer_matches_numpy(generated):
    """On a generated object's first placed grasp (placed again after all
    50 were tried), the three fingertip
    views that see the most of the object (121x121) and the scene camera on
    the object and the hand (256x256): the native rasterizer against
    ``use_native=False`` by the JAX package's rule, more than 100 pixels hit
    by both, under 1% of pixels differing in coverage, depths within 1e-4
    where both hit.  (The CPU suite holds the same on its own machine's
    build, ``test_torch_sim.py``.)"""
    root, names, _, _ = generated
    prefix = os.path.join(object_dirs(str(root))["object_info"], names[0])
    scene = Scene(vision=True)
    scene.load_obj(np.load(prefix + "_verts.npy"), np.load(prefix + "_faces.npy"))
    placed = [action for action in range(50) if scene.grasp(action)]
    assert placed and scene.grasp(placed[0])
    mesh = scene.obj
    views = []
    for f in range(4):
        pos, rot = scene.hand.fingertip_camera(f)
        view = (mesh.verts, mesh.faces, pos, rot, scene._touch_focal, 121, 121)
        views.append(((raster.rasterize_depth(*view)[1] >= 0).sum(), view))
    views = [view for _, view in sorted(views, key=lambda v: -v[0])[:3]]
    hand, cam = scene.hand.link_meshes(), scene.renderer.camera
    offsets = np.cumsum([mesh.num_verts] + [m.num_verts for m in hand])
    views.append((np.concatenate([mesh.verts] + [m.verts for m in hand]),
                  np.concatenate([mesh.faces] + [m.faces + o for m, o in zip(hand, offsets[:-1])]),
                  np.asarray(cam.position), cam.rotation, cam.focal, 256, 256))
    for view in views:
        (d1, i1), (d2, i2) = raster.rasterize_depth(*view, use_native=False), raster.rasterize_depth(*view)
        both = (i1 >= 0) & (i2 >= 0)
        assert both.sum() > 100
        assert ((i1 >= 0) != (i2 >= 0)).mean() < 0.01
        assert float(np.abs(d1[both] - d2[both]).max()) <= 1e-4


# -- the multi-rank layer at world 1 -------------------------------------------------


@contextlib.contextmanager
def _one_rank_group(tmp_path: Path):
    """A process group of one rank on NCCL, through a ``FileStore``."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shards_combined(x: torch.Tensor, y: torch.Tensor, shards: int, nn: str) -> torch.Tensor:
    """``y``'s point axis cut into ``shards`` shards run one after the other
    through ``chamfer_shard_terms``, combined as the collectives would: the
    MIN of the per-query minima, the SUM of the shard sums."""
    terms = [chamfer_shard_terms(x, ys, nn) for ys in torch.chunk(y, shards, dim=1)]
    dx = torch.stack([d for d, _ in terms]).amin(dim=0)
    dy = torch.stack([s for _, s in terms]).sum(dim=0)
    return dx.mean(dim=1) + dy / y.shape[1]


# the Chamfer distance of (48, 30000) x 30000 by nn, and the launches of each
SHARDED = {
    "world 1": (lambda x, y, nn: chamfer_distance_sharded(x, y, nn=nn), 1),
    "4 shards in one process": (lambda x, y, nn: _shards_combined(x, y, 4, nn), 4),
}


@pytest.mark.parametrize("case", SHARDED)
def test_sharded_chamfer_in_a_one_rank_group(cuda, tmp_path, case):
    """Exact: within 1e-6 of the unsharded Chamfer, 2 K1 launches a shard.
    Clustered: never below the exact one (each query's clustered distance
    is at least its exact one, and the sums run in the same order), 2 chunk
    tables and 2 pruned scans a shard."""
    run, shards = SHARDED[case]
    g = torch.Generator(device=cuda).manual_seed(11)
    x, y = surface_clouds(48, N, g, cuda), surface_clouds(48, N, g, cuda)
    with _one_rank_group(tmp_path):
        with launch_calls() as exact_calls:
            exact = run(x, y, "exact")
        with launch_calls() as clustered_calls:
            clustered = run(x, y, "clustered")
    assert exact_calls == NONE | {K1: 2 * shards}
    assert clustered_calls == NONE | {K3: 2 * shards, SEL: 2 * shards}
    whole = chamfer_distance(x, y)
    assert float(((exact - whole).abs() / whole.abs()).max()) <= 1e-6
    assert bool((clustered >= exact).all())


def test_train_step_in_a_one_rank_group_matches_one_without(cuda, tmp_path):
    """``VisionEngine(VisionConfig())``'s train step under the group against
    the same step without one, on the same weights, batch and draws.  With
    the BatchNorms on their running statistics: the loss within 1e-6, each
    gradient within 1e-3 of its norm (in train mode the card's atomic adds
    move some gradients by 1e-3 of their norm between two runs of one step,
    and those of the conv biases that feed a BatchNorm, zero in exact
    arithmetic, by all of it).  In train mode: the loss within 1e-6, 2
    chunk tables, 2 pruned scans and 2 segment sums, and under 1e-3 of the
    elements updated otherwise by more than 2% of lr (Adam's first step is
    about lr x sign(g), so an element whose gradient is rounding noise may
    step the other way)."""
    plain = VisionEngine(VisionConfig(eval=True, exp_id="plain", experiments_root=str(tmp_path)),
                         log=False)  # built before the group: one device
    with _one_rank_group(tmp_path):
        cfg = VisionConfig(eval=True, exp_id="group", experiments_root=str(tmp_path))
        grouped = VisionEngine(cfg, log=False)
        assert grouped.group is not None and grouped.world == 1 and plain.group is None
        start = copy.deepcopy(plain.state_dict())  # the weights and a fresh optimizer
        grouped.load_state_dict(start)
        batch = grouped.to_device(dict(bench_batch(cfg), gt_points=_surface_gt(cfg, cuda)))
        steps = {}
        for label, engine in (("group", grouped), ("plain", plain)):
            engine.model.train = lambda mode=True, m=engine.model: torch.nn.Module.train(m, False)
            try:
                loss = float(engine.train_step(batch, engine.step_generator(0)))
            finally:
                del engine.model.train
            steps[label] = (loss, {k: p.grad.clone() for k, p in engine.model.named_parameters()})
            engine.load_state_dict(start)
        (loss_g, grads_g), (loss_p, grads_p) = steps["group"], steps["plain"]
        assert abs(loss_g - loss_p) <= 1e-6 * abs(loss_p)
        assert max(float((grads_g[k] - g).norm() / g.norm()) for k, g in grads_p.items()) <= 1e-3

        with launch_calls() as calls:
            loss_g = float(grouped.train_step(batch, grouped.step_generator(0)))
        loss_p = float(plain.train_step(batch, plain.step_generator(0)))
    assert calls == NONE | {K3: 2, SEL: 2, K2: 2}
    assert abs(loss_g - loss_p) <= 1e-6 * abs(loss_p)
    pairs = list(zip(grouped.model.parameters(), plain.model.parameters()))
    moved = sum(int(((a - b).detach().abs() > 0.02 * cfg.lr).sum()) for a, b in pairs)
    assert moved / sum(a.numel() for a, _ in pairs) <= 1e-3


# -- the command line -----------------------------------------------------------------


def _cli(args: list, cwd: Path, timeout: int = 600) -> str:
    """``python -m active_3d_vision_and_touch_tpu_torch.cli <args>`` in
    ``cwd``; fails unless it exits with 0.  Returns its standard output."""
    path = os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))
    proc = subprocess.run([sys.executable, "-m", "active_3d_vision_and_touch_tpu_torch.cli", *args],
                          cwd=cwd, env=dict(os.environ, PYTHONPATH=path),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{' '.join(args[:2])}:\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}"
    return proc.stdout


def _png_size(path: Path) -> tuple[int, int]:
    """(height, width) from a PNG's IHDR, after its signature."""
    data = path.read_bytes()[:24]
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR", path
    return int.from_bytes(data[20:24], "big"), int.from_bytes(data[16:20], "big")


@pytest.fixture(scope="module")
def trained(generated, tmp_path_factory):
    """The command line's trainers, one epoch each, on a copy of the
    generated world (8 objects: 2 in recon_train, 3 in auto_train, 1 each in
    RL_train, valid and test; batches cut to what the splits hold):
    ``train-touch``, ``make-touch-charts`` from its checkpoint,
    ``train-vision`` (the clustered loss), ``train-auto``.  Returns the
    working directory, the world, and a checkpoint directory by id."""
    cwd = tmp_path_factory.mktemp("cli")
    root, exp = cwd / "world", cwd / "experiments"
    shutil.copytree(generated[0], root)
    common = ["--root", str(root), "--experiments-root", str(exp), "--epochs", "1"]
    ckpt = lambda exp_id: str(exp / "checkpoint" / "test" / exp_id)  # noqa: E731
    _cli(["train-touch", *common, "--exp-id", "touch"], cwd)
    _cli(["make-touch-charts", "--root", str(root), "--touch-location", ckpt("touch")], cwd)
    _cli(["train-vision", *common, "--exp-id", "vision", "--batch-size", "2"], cwd)
    _cli(["train-auto", *common, "--exp-id", "auto", "--batch-size", "3",
          "--vision-location", ckpt("vision")], cwd)
    return cwd, root, ckpt


def test_cli_even_policy_visualizes(trained):
    """``policy even --visualize`` on the test object from the trained
    checkpoints: a finite result, and its two PNGs at their promised
    sizes."""
    cwd, root, ckpt = trained
    out = _cli(["policy", "even", "--root", str(root), "--experiments-root", str(cwd / "experiments"),
                "--eval", "--visualize", "--env-batch-size", "1", "--exp-id", "even",
                "--touch-location", ckpt("touch"), "--vision-location", ckpt("vision"),
                "--auto-location", ckpt("auto")], cwd)
    assert np.isfinite(json.loads(out.strip().splitlines()[-1])["pct_cd_remaining"])
    results, a = cwd / PolicyConfig(exp_id="even").results_dir, PolicyConfig().num_actions
    assert _png_size(results / "histogram.png") == (
        viz._HIST_PLOT_H + 2 * viz._HIST_MARGIN, a * viz._HIST_BAR + 2 * viz._HIST_MARGIN)
    assert _png_size(results / "sphere_projection.png") == (2 * a, 4 * a)


def test_evaluate_detailed_renders_its_images(trained):
    """``VisionEngine.evaluate_detailed`` with ``visualize_dir`` on the
    vision checkpoint the command line wrote, over the valid split in
    batches of 2: 2 K1 launches a batch and no other kernel, a finite mean
    over 4 objects, and 256x256 PNGs."""
    cwd, root, ckpt = trained
    cfg = load_config(ckpt("vision"), VisionConfig)
    cfg.eval = True
    engine = VisionEngine(cfg, log=False)
    restored = engine.ckpt.restore("best", map_location=engine.device)
    assert restored is not None
    engine.load_state_dict(restored)
    dataset = VisionDataset(str(root), "valid", use_img=cfg.use_img, use_touch=cfg.use_touch,
                            finger=cfg.finger, num_grasps=cfg.num_grasps,
                            number_points=cfg.number_points, eval_mode=True)
    viz_dir = cwd / "evaluate_detailed"
    with launch_calls() as calls:
        mean_cd, per_object = engine.evaluate_detailed(Loader(dataset, 2, shuffle=False), str(viz_dir))
    assert calls == NONE | {K1: len(per_object)}
    assert np.isfinite(mean_cd) and len(per_object) == 4
    pngs = sorted(viz_dir.rglob("*.png"))
    assert len(pngs) >= 2 and all(_png_size(p) == (256, 256) for p in pngs)
