"""The port's active-touch environment and its six non-learned policies
against the JAX package's.

The world is written here from numpy: six objects with images, gt clouds and
a chart cache of 4 actions in which every (object, action) holds all three
mask codes; no simulator runs.  Small sizes: env batch 2, 4 actions, budget
2, 2 grasps, 128 Chamfer samples, a 2-layer x 16-wide GCN, 3 one-layer CNN
blocks on 64x64 images, an autoencoder with encoding 16.

- The env's reconstruction and candidate scores are held against a JAX
  composition of ``prepare_charts``, ``Deformation``, the sampler, the exact
  Chamfer distance and ``MeshAutoEncoder`` on the same weights and draws.
- The touch model's path (a simulator's signals → cached charts) is held
  against the JAX env's on the same fake simulator.
- Action selection and the policies are held against the JAX package's on
  envs whose scorer and observation are replaced by the same deterministic
  numpy function of the episode's state: identical actions and rollouts.
"""

import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.active.env import ActiveTouchEnv as JaxActiveTouchEnv
from active_3d_vision_and_touch_tpu.active.policies import dataset_specific as jax_dataset_specific
from active_3d_vision_and_touch_tpu.active.policies import nearest as jax_nearest
from active_3d_vision_and_touch_tpu.active.policies import simple as jax_simple
from active_3d_vision_and_touch_tpu.core.config import PolicyConfig as JaxPolicyConfig
from active_3d_vision_and_touch_tpu.models import TouchChartEncoder as JaxTouchChartEncoder
from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
from active_3d_vision_and_touch_tpu.models.autoencoder import MeshAutoEncoder as JaxMeshAutoEncoder
from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
from active_3d_vision_and_touch_tpu.train.vision import (
    build_deformation as jax_build_deformation,
)
from active_3d_vision_and_touch_tpu_torch.active import ActiveTouchEnv
from active_3d_vision_and_touch_tpu_torch.active import env as env_module
from active_3d_vision_and_touch_tpu_torch.active.policies import dataset_specific, nearest, simple
from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.rollout import RolloutResult
from active_3d_vision_and_touch_tpu_torch.convert import (
    autoencoder_from_flax,
    deformation_from_flax,
    touch_encoder_from_flax,
)
from active_3d_vision_and_touch_tpu_torch.core.config import (
    AutoencoderConfig,
    PolicyConfig,
    VisionConfig,
    save_config,
)
from active_3d_vision_and_touch_tpu_torch.data import object_dirs, random_object
from active_3d_vision_and_touch_tpu_torch.models import MeshAutoEncoder, TouchChartEncoder
from active_3d_vision_and_touch_tpu_torch.models.vision import init_modules_
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.sim import Sampler
from active_3d_vision_and_touch_tpu_torch.train.vision import build_deformation
from active_3d_vision_and_touch_tpu_torch.utils import profiler
from test_torch_autoencoder import _jax_sample, _sampler_inputs, random_variables

B, ACTIONS, POINTS = 2, 4, 128
NAMES = [f"{i:06d}" for i in range(6)]
SMALL = dict(
    use_img=True, use_touch=True, finger=False, num_gcn_layers=2, hidden_gcn_size=16,
    num_cnn_blocks=3, layers_per_block=1, number_points=POINTS, env_batch_size=B, budget=2, num_grasps=2,
    num_actions=ACTIONS, use_latent=True, greedy_checks=2, eval=True,
)
AE = dict(encoding_size=16, grid_size=8, num_gcn_layers=2, hidden_gcn_size=16)



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many small torch ops on the CPU, beside other test
    processes that share its cores: one intra-op thread each is faster
    there than a pool of threads that wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _write_world(root, rng):
    """Images, gt clouds (on a sphere of radius 0.1), a data split, a
    chart cache (actions, 4 fingers, 25, xyz | code) in which each action's
    four fingers hold the codes 0, 1, 2, 2 in a drawn order (a code-1 slot
    is collapsed onto its finger's position, as the touch-chart stage
    stores it), and each object's mesh, a procedural object, which the
    env's default simulator loads at an episode's first grasp that the
    chart cache lacks."""
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
                if code == 2:
                    charts[a, f, :, :3] = pos + rng.normal(size=(25, 3)) * 0.01
                elif code == 1:
                    charts[a, f, :, :3] = pos
                charts[a, f, :, 3] = code
        os.makedirs(os.path.join(dirs["touch_charts"], n))
        np.save(os.path.join(dirs["touch_charts"], n, "touch_charts.npy"), charts)
    np.save(os.path.join(root, "data_split.npy"),
            {"RL_train": NAMES[:4], "test": NAMES[4:], "valid": NAMES[4:]})


def _batch(root, names):
    dirs = object_dirs(root)
    return {
        "names": [os.path.join(dirs["object_info"], n) for n in names],
        "gt_points": np.stack([np.load(os.path.join(dirs["point_cloud_info"], n + ".npy"))[:POINTS]
                               for n in names]),
        "img": np.stack([np.load(os.path.join(dirs["images_colourful"], n + ".npy"))
                         for n in names]).astype(np.float32) / 255.0,
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("active_world"))
    _write_world(root, np.random.default_rng(0))
    return root


def _loaded(model, state):
    model.load_state_dict(state)
    return model


def _jax_models(rng, cfg):
    """The flax Deformation and autoencoder of the env's config, their
    variables (running statistics away from their initial values), and the
    adjacency info."""
    jmodel, jinfo, jmesh = jax_build_deformation(JaxPolicyConfig(**cfg))
    adj, orig = jnp.asarray(jinfo.adj), jnp.asarray(jinfo.original)
    charts = jax_prepare_charts(jnp.zeros((1, 2 * 4 * 25, 4)), jmesh, 1)
    jvars = random_variables(jmodel, rng, jnp.zeros((1, 64, 64, 3)), charts, adj, orig)
    jae = JaxMeshAutoEncoder(**AE)
    v = jinfo.num_verts
    ae_params = random_variables(jae, rng, jnp.zeros((1, v, 3)), jnp.zeros((1, v, 1)), adj)["params"]
    return jmodel, jvars, jae, ae_params, jinfo, jmesh


def test_env_reconstruction_and_scores_match_jax(world, tmp_path):
    """After a committed step, ``score_candidates`` over 4 candidates per
    element folded onto the batch, and ``_reconstruct`` (verts, mask codes,
    score, latent) of the same 8 folded chart sets, with the sampler's draws
    handed in, agree with one JAX composition on the same charts, weights
    and draws: rtol 1e-4 (verts and latent also 1e-5 absolute); the mask
    codes equal.  A draw within float rounding of a face boundary of the
    area CDF can take the neighbouring face in one package and not in the
    other, which moves one sample point by up to 2e-4 of the score: the
    weights come from a seed on which no draw does."""
    rng = np.random.default_rng(4)
    cfg = dict(SMALL, experiments_root=str(tmp_path))
    jmodel, jvars, jae, ae_params, jinfo, jmesh = _jax_models(rng, cfg)
    env = ActiveTouchEnv(
        PolicyConfig(**cfg),
        vision_model=_loaded(build_deformation(PolicyConfig(**cfg), "cpu"),
                             deformation_from_flax(jvars["params"], jvars["batch_stats"])),
        auto_model=_loaded(MeshAutoEncoder(**AE), autoencoder_from_flax(ae_params)),
        chart_cache_root=world, device="cpu",
    )
    batch = _batch(world, NAMES[:2])
    obs = env.reset(batch)
    assert obs["score"].shape == (B,) and obs["latent"].shape == (B, 16)
    obs, reward, done = env.step(np.array([1, 3]))
    assert not done and np.isfinite(reward).all()
    charts, masks = env.current["touch_charts"], env.current["touch_masks"]
    assert set(np.unique(masks[:, :, 0])) == {0.0, 1.0, 2.0}

    # candidates for grasp slot 1, read from the chart cache as the env
    # stores them: charts where touched, the finger position where not
    cands = np.array([[0, 1, 2, 3], [2, 0, 3, 1]])
    k = cands.shape[1]
    dirs = object_dirs(world)
    all_charts = np.repeat(charts[:, None], k, axis=1)  # (b, k, nf, g, 25, 3)
    all_masks = np.repeat(masks[:, None], k, axis=1)
    for i, name in enumerate(NAMES[:2]):
        cache = np.load(os.path.join(dirs["touch_charts"], name, "touch_charts.npy"))
        for j, a in enumerate(cands[i]):
            code = cache[a, :, 0, 3]
            xyz = np.where((code == 2)[:, None, None], cache[a, :, :, :3],
                           np.where((code == 1)[:, None, None], cache[a, :, :1, :3], 0.0))
            all_charts[i, j, :, 1] = xyz
            all_masks[i, j, :, 1] = code[:, None, None]
    all_charts = all_charts.reshape(B * k, 4, 2, 25, 3)
    all_masks = all_masks.reshape(B * k, 4, 2, 25, 1)
    img = np.repeat(batch["img"], k, axis=0)
    gt = np.repeat(batch["gt_points"], k, axis=0)
    draws = draw_sample_noise(B * k, 3 * POINTS, torch.Generator().manual_seed(11))

    adj, orig, faces = (jnp.asarray(a) for a in (jinfo.adj, jinfo.original, jinfo.faces))
    stacked = np.concatenate([all_charts.reshape(B * k, -1, 3), all_masks.reshape(B * k, -1, 1)], -1)

    @jax.jit
    def jax_reconstruct(stacked, img, gt, u_face, w):
        b = gt.shape[0]
        verts, mask = jmodel.apply(jvars, img, jax_prepare_charts(stacked, jmesh, b), adj, orig)
        cd = jax_chamfer(_jax_sample(verts, faces, u_face, w), jnp.tile(gt, (3, 1, 1)))
        latent = jae.apply({"params": ae_params}, verts, mask, adj, only_encode=True)
        return verts, mask, 9000.0 * cd.reshape(3, b).mean(0), latent

    expected = jax_reconstruct(stacked, img, gt, *_sampler_inputs(draws))

    scores = env.score_candidates(cands, chunk=k, draws=[draws])
    np.testing.assert_allclose(scores, np.asarray(expected[2]).reshape(B, k), rtol=1e-4)
    # scoring committed nothing
    assert env.steps == 1 and np.array_equal(env.current["touch_charts"], charts)
    t = torch.from_numpy
    out = env._reconstruct(t(img), t(all_charts), t(all_masks), t(gt), draws=draws)
    # verts and latent of order 1: rtol 1e-4, and 1e-5 absolute near zero
    for name, got, want in zip(("verts", "mask", "score", "latent"), out, expected):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=name)


class _FakeSimulator:
    """A simulator's interface with seeded signals: gel images, fingertip
    poses, and statuses covering all three codes; ``loads`` holds the names
    of each ``load_objects`` call."""

    def __init__(self, b):
        self.b, self.calls, self.loads = b, 0, []

    def load_objects(self, names, from_dataset=True):
        self.loads.append(list(names))

    def sample(self, actions, touch=True):
        rng = np.random.default_rng(int(np.sum(actions)) + 7 * self.calls)
        self.calls += 1
        statuses = ["touch", "no_touch", "no_intersection", "touch"]
        return {
            "touch_status": [statuses[i:] + statuses[:i] for i in range(self.b)],
            "touch_signal": rng.uniform(0, 255, size=(self.b, 4, 121, 121, 3)).astype(np.float32),
            "finger_transform_pos": (rng.normal(size=(self.b, 4, 3)) * 0.1).astype(np.float32),
            "finger_transform_rot_M": np.linalg.qr(rng.normal(size=(self.b, 4, 3, 3)))[0]
            .astype(np.float32),
        }

    def disconnect(self):
        pass


def test_env_signals_from_a_simulator_match_jax(world, tmp_path):
    """Signals neither primed nor cached come from the supplied simulator
    through the frozen touch model: the cached charts within 1e-4 of the
    JAX env's on converted weights, the codes and positions equal.  Without
    a sampler, each env builds its own simulator: after ``reset`` on two
    objects, a key outside the chart cache is grasped live, and the port's
    signals match the JAX env's default simulator's to the same tolerance."""
    cfg = dict(SMALL, use_latent=False, experiments_root=str(tmp_path))
    rng = np.random.default_rng(2)
    tv = random_variables(JaxTouchChartEncoder(), rng, jnp.zeros((1, 121, 121, 3)),
                          jnp.zeros((1, 3)), jnp.eye(3)[None], jnp.zeros((25, 3)))
    jenv = JaxActiveTouchEnv(JaxPolicyConfig(**cfg), tv, {}, sampler=_FakeSimulator(B))
    touch = _loaded(TouchChartEncoder(), touch_encoder_from_flax(tv["params"], tv["batch_stats"]))
    env = ActiveTouchEnv(PolicyConfig(**cfg), touch, sampler=_FakeSimulator(B), device="cpu")
    keys = [("objA", 2), ("objB", 3)]
    for e in (jenv, env):
        e._simulate_and_cache(np.array([2, 3]), keys)
    for key in keys:
        (c_j, codes_j, pos_j), (c_t, codes_t, pos_t) = jenv._sig_cache[key], env._sig_cache[key]
        np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(codes_t, codes_j)
        np.testing.assert_array_equal(pos_t, pos_j)

    bare = ActiveTouchEnv(PolicyConfig(**cfg), touch, chart_cache_root=world, device="cpu")
    assert isinstance(bare.sampler, Sampler)
    jbare = JaxActiveTouchEnv(JaxPolicyConfig(**cfg), tv, {})
    batch = _batch(world, NAMES[:2])
    bare.reset(batch)
    jbare.sampler.load_objects(batch["names"], from_dataset=True)
    bare.current["batch"]["names"][1] = "elsewhere/unknown_object"
    bare.step(np.array([0, 1]))
    keys = [(batch["names"][0], 0), ("elsewhere/unknown_object", 1)]
    jbare._simulate_and_cache(np.array([0, 1]), keys)
    for key in keys:
        (c_j, codes_j, pos_j), (c_t, codes_t, pos_t) = jbare._sig_cache[key], bare._sig_cache[key]
        np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(codes_t, codes_j)
        np.testing.assert_array_equal(pos_t, pos_j)
    assert (codes_t == 2).any()
    for e in (bare, jbare):
        e.sampler.disconnect()


@pytest.mark.parametrize("drive", ["greedy", "steps"])
@pytest.mark.parametrize("cached", [True, False], ids=["chart_cache", "live"])
def test_env_loads_the_episode_objects_at_its_first_miss_only(world, tmp_path, cached, drive):
    """``reset`` loads nothing into the simulator.  Where the chart cache
    answers every grasp, an episode of two greedy steps or two committed
    steps loads nothing and grasps nothing; without it, the first step's
    miss loads the names given to ``reset``, once, and the later misses of
    the episode (the greedy step's other chunks, the second step's grasps)
    load nothing more.  The counters say the same."""
    cfg = PolicyConfig(**dict(SMALL, use_latent=False), experiments_root=str(tmp_path))
    sim = _FakeSimulator(B)
    env = ActiveTouchEnv(cfg, sampler=sim, chart_cache_root=world if cached else None, device="cpu")
    batch = _batch(world, NAMES[:2])
    names = list(batch["names"])
    profiler.reset()
    env.reset(batch)
    assert sim.loads == []
    loads = [] if cached else [names]
    for actions in ([0, 1], [2, 3]):
        if drive == "greedy":
            env.best_step()
        else:
            env.step(np.array(actions))
        assert sim.loads == loads
    assert sim.calls == (0 if cached else ACTIONS if drive == "greedy" else 2)
    counters = profiler.snapshot()["counters"]
    assert counters["env.resets"] == 1
    assert counters.get("env.sim_loads", 0) == len(loads)
    assert counters.get("env.signal_misses", 0) == B * sim.calls
    profiler.reset()


def test_env_loads_each_episode_into_the_simulator_it_has(world, tmp_path, monkeypatch):
    """A new ``reset`` followed by a miss loads the new episode's names, as
    ``reset`` was given them (a later edit of the batch's list changes
    nothing); after ``reset_sampler`` the next miss loads them into the
    new simulator, and the old one sees no further call."""
    cfg = PolicyConfig(**dict(SMALL, use_latent=False), experiments_root=str(tmp_path))
    first, second = _FakeSimulator(B), _FakeSimulator(B)
    monkeypatch.setattr(env_module, "Sampler", lambda **kw: second)
    env = ActiveTouchEnv(cfg, sampler=first, device="cpu")
    episodes = [_batch(world, NAMES[:2]), _batch(world, NAMES[2:4])]
    names = [list(b["names"]) for b in episodes]
    env.reset(episodes[0])
    env.step(np.array([0, 1]))
    env.reset(episodes[1])
    episodes[1]["names"][0] = "elsewhere/unknown_object"
    env.step(np.array([0, 1]))
    assert first.loads == names and first.calls == 2
    env.reset_sampler()
    assert env.sampler is second and second.loads == []
    env.step(np.array([2, 3]))
    assert second.loads == [names[1]] and second.calls == 1
    assert first.loads == names and first.calls == 2


class _EagerEnv(ActiveTouchEnv):
    """The env as it loaded the simulator before: every episode's objects at
    ``reset``."""

    def reset(self, batch):
        self.sampler.load_objects(batch["names"], from_dataset=True)
        obs = super().reset(batch)
        self._sim_loaded = True
        return obs


def test_env_signals_of_a_lazily_loaded_simulator_equal_an_eager_load(world, tmp_path):
    """On the default simulator and no chart cache, an episode whose
    objects load at its first miss grasps what an episode that loaded them
    at ``reset`` grasps: its cached signals, committed charts and scores
    equal, bit for bit."""
    cfg = PolicyConfig(**dict(SMALL, use_latent=False), experiments_root=str(tmp_path))
    touch = init_modules_(TouchChartEncoder(), torch.Generator().manual_seed(3))
    deform = build_deformation(cfg, "cpu")
    envs = [cls(cfg, touch, deform, device="cpu") for cls in (ActiveTouchEnv, _EagerEnv)]
    obs = []
    for e in envs:
        assert isinstance(e.sampler, Sampler)
        o = [e.reset(_batch(world, NAMES[:2]))]
        for actions in ([0, 1], [3, 2]):
            o.append(e.step(np.array(actions))[0])
        obs.append(o)
    lazy, eager = envs
    assert set(lazy._sig_cache) == set(eager._sig_cache) and len(lazy._sig_cache) == 2 * B
    for key in eager._sig_cache:
        for got, want in zip(lazy._sig_cache[key], eager._sig_cache[key]):
            np.testing.assert_array_equal(got, want)
    assert any((codes == 2).any() for _, codes, _ in eager._sig_cache.values())
    for name in ("touch_charts", "touch_masks"):
        np.testing.assert_array_equal(lazy.current[name], eager.current[name])
    for got, want in zip(*obs):
        np.testing.assert_array_equal(got["score"], want["score"])
    for e in envs:
        e.sampler.disconnect()


def test_env_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ActiveTouchEnv(PolicyConfig(eval=True, experiments_root=str(tmp_path)))


# ---- action selection and policies on a deterministic scorer ------------

def _key(env, i, *extra) -> int:
    name = os.path.basename(str(env.current["batch"]["names"][i]))
    state = env.current["mask"][i].astype(np.int8).tobytes().hex()
    return zlib.crc32(":".join([name, state, str(env.steps), *map(str, extra)]).encode())


def _table_scores(env, candidates, chunk=10, **_):
    """(b, K) scores, a fixed function of object, committed actions, step
    and candidate."""
    return np.array([[(_key(env, i, int(a)) % 9973) / 9973.0 + 0.5 for a in row]
                     for i, row in enumerate(candidates)], np.float32)


def _table_obs(env, to_array):
    """(verts, mask, score, latent) as a fixed function of object and
    committed actions."""
    b = len(env.current["batch"]["names"])
    score = np.array([1.0 + (_key(env, i) % 1000) / 1000.0 for i in range(b)], np.float32)
    latent = np.stack([np.random.default_rng(_key(env, i)).normal(size=8) for i in range(b)])
    outs = (np.zeros((b, 3, 3)), np.full((b, 3, 1), 3.0), score, latent.astype(np.float32))
    return tuple(to_array(a) for a in outs)


def _table_envs(world, root):
    """A JAX env and a port env over the same chart cache, each scoring
    with the table."""
    cfg = dict(SMALL, experiments_root=str(root))
    jenv = JaxActiveTouchEnv(JaxPolicyConfig(**cfg), {}, {}, auto_state={}, auto_model=object(),
                             sampler=_FakeSimulator(B), chart_cache_root=world)
    env = ActiveTouchEnv(PolicyConfig(**cfg), auto_model=MeshAutoEncoder(**AE),
                         chart_cache_root=world, device="cpu")
    for e, to_array in ((jenv, np.asarray), (env, torch.as_tensor)):
        e.score_candidates = lambda c, chunk=10, e=e, **kw: _table_scores(e, c)
        e._dispatch_obs = lambda e=e, to_array=to_array: _table_obs(e, to_array)
    return jenv, env


def test_best_action_matches_jax(world, tmp_path):
    """``best_action`` on every action, on ``greedy_checks`` drawn unseen
    actions (the same numpy generator), and with fewer unseen actions than
    checks; ``best_step`` commits the same action: identical actions."""
    jenv, env = _table_envs(world, tmp_path)
    batch = _batch(world, NAMES[:2])
    for e in (jenv, env):
        e.reset(dict(batch))
    for checks in (None, 2, 3, 2):
        acts = [e.best_action(greedy_checks=checks) for e in (jenv, env)]
        np.testing.assert_array_equal(acts[1], acts[0])
    steps = [e.best_step(greedy_checks=2) for e in (jenv, env)]
    np.testing.assert_array_equal(steps[1][0], steps[0][0])
    np.testing.assert_array_equal(steps[1][1]["score"], steps[0][1]["score"])
    for e in (jenv, env):
        e.current["mask"][:] = 1
        e.current["mask"][:, 2] = 0  # one unseen action left
    acts = [e.best_action(greedy_checks=3) for e in (jenv, env)]
    np.testing.assert_array_equal(acts[1], acts[0])
    assert (acts[1] == 2).all()


POLICIES = {
    "random": (jax_simple.RandomEngine, simple.RandomEngine),
    "even": (jax_simple.EvenEngine, simple.EvenEngine),
    "greedy": (jax_simple.GreedyEngine, simple.GreedyEngine),
    "mfba": (jax_dataset_specific.MFBAEngine, dataset_specific.MFBAEngine),
    "leba": (jax_dataset_specific.LEBAEngine, dataset_specific.LEBAEngine),
    "nearest": (jax_nearest.NearestNeighborEngine, nearest.NearestNeighborEngine),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_policy_matches_jax(world, tmp_path, monkeypatch, policy):
    """Each policy trains where it learns (MFBA and LEBA their action
    sequence, NN its latent bank, over the whole RL_train split) and is
    evaluated on the test split, in the JAX package and in the port, on
    envs with the same scorer: the same learned state, identical actions
    and ``RolloutResult``s, and the same files written."""
    monkeypatch.chdir(tmp_path)  # the results directory is relative
    jenv, env = _table_envs(world, tmp_path)
    results = []
    for side, cls, e in (("jax", POLICIES[policy][0], jenv), ("port", POLICIES[policy][1], env)):
        cfg = (JaxPolicyConfig if side == "jax" else PolicyConfig)(
            **SMALL, experiments_root=str(tmp_path / side), exp_id=f"{policy}_{side}")
        engine = cls(cfg, data_root=world, env=e)
        learned = engine.train(train_fraction=1.0) if hasattr(engine, "train") else None
        result = engine.evaluate(split="test")
        results.append((learned, result, engine, cfg))
    (learned_j, result_j, engine_j, cfg_j), (learned_t, result_t, engine_t, cfg_t) = results
    assert isinstance(result_t, RolloutResult) and result_t.scores.shape == (B, 3)
    assert learned_t == learned_j
    if policy == "nearest":
        np.testing.assert_array_equal(np.stack(engine_t.latents), np.stack(engine_j.latents))
        assert engine_t.actions == engine_j.actions
    np.testing.assert_array_equal(result_t.actions, result_j.actions)
    np.testing.assert_array_equal(result_t.scores, result_j.scores)
    assert result_t.names == result_j.names and result_t.summary() == result_j.summary()
    saved = [np.load(os.path.join(c.results_dir, "eval_trajectories.npz")) for c in (cfg_j, cfg_t)]
    for key in ("scores", "actions"):
        np.testing.assert_array_equal(saved[1][key], saved[0][key])


def test_policy_engine_without_an_env_reads_the_chart_cache(world, tmp_path, monkeypatch):
    """A policy engine built from checkpoint locations (configs, no
    checkpoints) copies the frozen vision model's setting into its config,
    builds the autoencoder its config names, reads its signals from the data
    root's chart cache, and with ``visualize`` draws the action plots
    beside its result: the sphere map equal to the JAX package's for the
    same actions."""
    monkeypatch.chdir(tmp_path)
    vision = {k: v for k, v in SMALL.items() if k in VisionConfig.__dataclass_fields__}
    save_config(str(tmp_path / "vision"), VisionConfig(**vision))
    save_config(str(tmp_path / "auto"), AutoencoderConfig(**{**vision, **AE}))
    cfg = PolicyConfig(**dict(SMALL, num_gcn_layers=5, visualize=True),
                       experiments_root=str(tmp_path), touch_location=str(tmp_path / "touch"),
                       vision_location=str(tmp_path / "vision"), auto_location=str(tmp_path / "auto"))
    engine = simple.EvenEngine(cfg, data_root=world, device="cpu")
    assert isinstance(engine, PolicyEngine)
    assert cfg.num_gcn_layers == SMALL["num_gcn_layers"]
    assert engine.env.auto_model.encoding_size == AE["encoding_size"]
    result = engine.evaluate(split="test")
    with open(os.path.join(cfg.results_dir, "eval.json")) as f:
        assert np.isfinite(json.load(f)["pct_cd_remaining"])
    from PIL import Image

    from active_3d_vision_and_touch_tpu.utils.viz import visualize_actions

    visualize_actions(str(tmp_path / "jax_plots"), result.actions, cfg.num_actions,
                      use_img=cfg.use_img)
    ours, theirs = (np.asarray(Image.open(os.path.join(d, "sphere_projection.png")))
                    for d in (cfg.results_dir, tmp_path / "jax_plots"))
    np.testing.assert_array_equal(ours, theirs)
    assert os.path.exists(os.path.join(cfg.results_dir, "histogram.png"))


def test_loader_matches_jax_and_raises_a_worker_error(world):
    """The rollout loader yields the JAX loader's batches, in its shuffled
    order; an error in a worker reaches the consumer."""
    from active_3d_vision_and_touch_tpu.data.datasets import ActiveDataset as JaxActiveDataset
    from active_3d_vision_and_touch_tpu.data.datasets import Loader as JaxLoader
    from active_3d_vision_and_touch_tpu_torch.data import ActiveDataset, Loader

    kw = dict(split="RL_train", number_points=POINTS, env_batch_size=B)
    ours = list(Loader(ActiveDataset(world, **kw), B, seed=3))
    theirs = list(JaxLoader(JaxActiveDataset(world, **kw), B, seed=3))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a["names"] == b["names"]
        for key in ("gt_points", "img"):
            np.testing.assert_array_equal(a[key], b[key])

    class Broken(ActiveDataset):
        def __getitem__(self, index):
            raise OSError(f"unreadable object {index}")

    with pytest.raises(OSError, match="unreadable"):
        list(Loader(Broken(world, **kw), B))
