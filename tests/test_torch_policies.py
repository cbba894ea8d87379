"""The port's learned policies (DDQN over latent or mesh observations, the
supervised value regression), their value nets and replay memory, against
the JAX package's.

Small sizes: env batch 2, 4 actions, budget 2, value nets 2 layers x 16
wide over a 16-wide latent or the 1736-vertex atlas of 2 grasps.  The
engines run on the table envs of ``test_torch_active.py``: a scorer and an
observation that are the same deterministic numpy function of the
episode's state in both packages, so the learned part is all that is held.
JAX and the port run float32 on the CPU; the port's nets start from the JAX
engine's weights, converted.
"""

import copy
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.active.env import ActiveTouchEnv as JaxActiveTouchEnv
from active_3d_vision_and_touch_tpu.active.policies.ddqn import DDQNEngine as JaxDDQNEngine
from active_3d_vision_and_touch_tpu.active.policies.supervised import (
    SupervisedEngine as JaxSupervisedEngine,
)
from active_3d_vision_and_touch_tpu.active.replay import ReplayMemory as JaxReplayMemory
from active_3d_vision_and_touch_tpu.core.config import PolicyConfig as JaxPolicyConfig
from active_3d_vision_and_touch_tpu.core.config import save_config as jax_save_config
from active_3d_vision_and_touch_tpu.models.policy_nets import GraphValueNet as JaxGraphValueNet
from active_3d_vision_and_touch_tpu.models.policy_nets import LatentValueNet as JaxLatentValueNet
from active_3d_vision_and_touch_tpu_torch.active import ActiveTouchEnv
from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.ddqn import DDQNEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.supervised import SupervisedEngine
from active_3d_vision_and_touch_tpu_torch.active.replay import ReplayMemory
from active_3d_vision_and_touch_tpu_torch.convert import value_net_from_flax
from active_3d_vision_and_touch_tpu_torch.core.config import (
    PolicyConfig,
    VisionConfig,
    load_config,
    save_config,
)
from active_3d_vision_and_touch_tpu_torch.models import (
    GraphValueNet,
    LatentValueNet,
    MeshAutoEncoder,
)
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from test_torch_active import AE, B, SMALL, _FakeSimulator, _key, _table_scores, world  # noqa: F401
from test_torch_autoencoder import random_variables

LATENT = AE["encoding_size"]
NETS = dict(hidden_dim=16, layers=2, pretrained_recon=False)
# a replay batch of 4 after 2 env steps of 2 transitions; ε 0 after the
# burn-in, so every later action is the value net's argmax
DDQN = dict(NETS, burn_in=2, train_batch_size=4, mem_capacity=16, epsilon_start=0.0,
            epsilon_end=0.0)
VARIANTS = {"latent": dict(use_latent=True), "mesh": dict(use_latent=False, use_recon=True)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small torch ops beside other test processes: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The engines write their results under the relative ``results/``."""
    monkeypatch.chdir(tmp_path)


def _policy_obs(env, to_array):
    """(verts, mask, score, latent) as a fixed function of object and
    committed actions: a mesh of the env atlas's vertex count with all four
    mask codes, a latent of the autoencoder's width."""
    b = len(env.current["batch"]["names"])
    v = env.adj_info.num_verts
    score = np.array([1.0 + (_key(env, i) % 1000) / 1000.0 for i in range(b)], np.float32)
    rngs = [np.random.default_rng(_key(env, i)) for i in range(b)]
    latent = np.stack([r.normal(size=LATENT) for r in rngs]).astype(np.float32)
    verts = np.stack([r.normal(size=(v, 3)) * 0.1 for r in rngs]).astype(np.float32)
    mask = np.stack([r.integers(0, 4, size=(v, 1)) for r in rngs]).astype(np.float32)
    return tuple(to_array(a) for a in (verts, mask, score, latent))


def _policy_envs(world, root, **extra):
    """A JAX env and a port env over the same chart cache, both scoring and
    observing by the table."""
    cfg = dict(SMALL, experiments_root=str(root), **extra)
    jenv = JaxActiveTouchEnv(JaxPolicyConfig(**cfg), {}, {}, auto_state={},
                             auto_model=SimpleNamespace(encoding_size=LATENT),
                             sampler=_FakeSimulator(B), chart_cache_root=world)
    env = ActiveTouchEnv(PolicyConfig(**cfg), auto_model=MeshAutoEncoder(**AE),
                         chart_cache_root=world, device="cpu")
    for e, to_array in ((jenv, np.asarray), (env, torch.as_tensor)):
        e.score_candidates = lambda c, chunk=10, e=e, **kw: _table_scores(e, c)
        e._dispatch_obs = lambda e=e, to_array=to_array: _policy_obs(e, to_array)
    return jenv, env


def _configs(root, name, **kw):
    """The JAX and the port config of one engine, each under its own root."""
    return tuple(cls(**dict(SMALL, **kw), experiments_root=str(root / side), exp_id=f"{name}_{side}")
                 for side, cls in (("jax", JaxPolicyConfig), ("port", PolicyConfig)))


def _load_flax(net, params):
    net.load_state_dict(value_net_from_flax(jax.device_get(params)))


def _assert_net_matches(net, params, **tol):
    for key, want in value_net_from_flax(jax.device_get(params)).items():
        np.testing.assert_allclose(net.state_dict()[key].numpy(), want.numpy(), err_msg=key, **tol)


# ---- value nets ---------------------------------------------------------

@pytest.mark.parametrize("squash", [None, "normalize", "img", "wide"])
def test_latent_value_net_matches_flax(squash):
    """On converted weights, the values equal flax's to 1e-5 relative,
    and 1e-5 of the squash's half range (1 without one) absolute."""
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=(3, 6)) < 0.4).astype(np.float32)
    latent, first = (rng.normal(size=(3, 16)).astype(np.float32) for _ in range(2))
    jnet = JaxLatentValueNet(num_actions=6, latent_size=16, hidden_dim=16, layers=3, squash=squash)
    params = random_variables(jnet, rng, mask, latent, first)["params"]
    net = LatentValueNet(6, 16, 16, 3, squash)
    _load_flax(net, params)
    want = np.asarray(jnet.apply({"params": params}, mask, latent, first))
    got = net(*map(torch.from_numpy, (mask, latent, first))).detach().numpy()
    half = {None: 1.0, "normalize": 1.0, "img": 3.0, "wide": 100.0}[squash]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * half)


def test_graph_value_net_matches_flax():
    """On converted weights over a 40-vertex row-stochastic adjacency and
    all four mask codes: the values equal flax's to 1e-5."""
    rng = np.random.default_rng(1)
    v = 40
    adj = rng.uniform(size=(v, v)).astype(np.float32) * (rng.uniform(size=(v, v)) < 0.2)
    adj = (adj + np.eye(v, dtype=np.float32)) / (adj.sum(1, keepdims=True) + 1)
    mask = (rng.uniform(size=(2, 6)) < 0.4).astype(np.float32)
    mesh = np.concatenate([rng.normal(size=(2, v, 3)) * 0.1,
                           rng.integers(0, 4, size=(2, v, 1))], -1).astype(np.float32)
    jnet = JaxGraphValueNet(num_actions=6, hidden_dim=16, layers=3, feature_size=16)
    params = random_variables(jnet, rng, mask, mesh, adj)["params"]
    net = GraphValueNet(6, 16, 3, feature_size=16)
    _load_flax(net, params)
    want = np.asarray(jnet.apply({"params": params}, mask, mesh, adj))
    got = net(*map(torch.from_numpy, (mask, mesh, adj))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- replay memory ------------------------------------------------------

def test_replay_memory_matches_jax(tmp_path):
    """The same pushes give the same buffer and, for the same seed, the
    same samples: None below max(burn_in, batch), then distinct
    transitions; a save loads back into a fresh memory, and a file the JAX
    package wrote loads into the port's."""
    kw = dict(capacity=8, num_actions=6, batch_size=4, burn_in=5, mesh_verts=3, latent_size=2,
              seed=7)
    mems = JaxReplayMemory(**kw), ReplayMemory(**kw)
    rng = np.random.default_rng(3)
    for t in range(6):  # 12 transitions into 8 slots: the ring wraps
        obs, nxt = ({"score": rng.uniform(size=2), "first_score": rng.uniform(size=2),
                     "mask": (rng.uniform(size=(2, 6)) < 0.3).astype(np.float32),
                     "mesh": rng.normal(size=(2, 3, 4)), "latent": rng.normal(size=(2, 2)),
                     "first_latent": rng.normal(size=(2, 2))} for _ in range(2))
        actions, rewards = np.array([2 * t, 2 * t + 1]), rng.normal(size=2)
        samples = []
        for m in mems:
            m.push(actions, obs, nxt, rewards)
            samples.append(m.sample())
        if mems[1].count_seen < 5:
            assert samples[0] is None and samples[1] is None
            continue
        assert samples[0].keys() == samples[1].keys()
        for key in samples[0]:
            np.testing.assert_array_equal(samples[1][key], samples[0][key], err_msg=key)
        assert len(set(samples[1]["actions"].tolist())) == kw["batch_size"]  # distinct
    assert mems[1].position == mems[0].position == 4 and mems[1].count_seen == 12

    for side, m in zip(("jax", "port"), mems):
        m.save(str(tmp_path / side))
        fresh = ReplayMemory(**kw)
        assert fresh.load(str(tmp_path / side))
        assert (fresh.position, fresh.count_seen) == (mems[1].position, mems[1].count_seen)
        for key, value in mems[1].data.items():
            np.testing.assert_array_equal(fresh.data[key], value, err_msg=key)
    assert not ReplayMemory(**kw).load(str(tmp_path / "nothing"))


# ---- DDQN ---------------------------------------------------------------

def _ddqn_pair(world, tmp_path, variant, **kw):
    """A JAX and a port DDQN engine on the table envs, the port's online and
    target nets loaded with the JAX engine's initial weights."""
    jenv, env = _policy_envs(world, tmp_path, **VARIANTS[variant])
    cfg_j, cfg_t = _configs(tmp_path, f"ddqn_{variant}", **VARIANTS[variant], **dict(DDQN, **kw))
    ej = JaxDDQNEngine(cfg_j, data_root=world, env=jenv)
    et = DDQNEngine(cfg_t, data_root=world, env=env)
    _load_flax(et.model, ej.params)
    _load_flax(et.target_model, ej.target_params)
    return ej, et


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ddqn_update_matches_jax(world, tmp_path, monkeypatch, variant):
    """Three updates on the same replay batches (rewards of tens, so that
    gradient elements far above 1 are clamped, and γ 0.9 with some episodes
    not done, so that the target net's double-Q value counts): each loss to
    1e-5 relative, and the online net's parameters after the three
    Adam steps to 1e-5 absolute (3 steps of lr 3e-4 each move a parameter
    by at most about 9e-4).  The clamp is elementwise, as optax.clip:
    Adam's later steps weigh the clamped gradients, so a norm clip or none
    moves the parameters elsewhere."""
    ej, et = _ddqn_pair(world, tmp_path, variant, gamma=0.9, normalization="none")
    rng = np.random.default_rng(5)
    # the target net differs from the online net
    target = jax.tree_util.tree_map(lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                    jax.device_get(ej.params))
    ej.target_params = jax.tree_util.tree_map(jnp.asarray, target)
    _load_flax(et.target_model, target)
    v = et.env.adj_info.num_verts
    raw = []
    clamp = torch.nn.utils.clip_grad_value_

    def spy(params, clip_value):
        params = list(params)
        raw.append(max(float(p.grad.abs().max()) for p in params))
        return clamp(params, clip_value)

    monkeypatch.setattr(torch.nn.utils, "clip_grad_value_", spy)
    for _ in range(3):
        n = 4
        mask = (rng.uniform(size=(n, 4)) < 0.3).astype(np.float32)
        batch = {
            "mask": mask, "mask_n": np.maximum(mask, np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]),
            "actions": rng.integers(0, 4, n), "rewards": (rng.normal(size=n) * 30).astype(np.float32),
            "score": rng.uniform(1, 2, n).astype(np.float32),
            "score_n": rng.uniform(1, 2, n).astype(np.float32),
            "first_score": rng.uniform(1, 2, n).astype(np.float32),
        }
        if variant == "latent":
            for key in ("latent", "latent_n", "first_latent"):
                batch[key] = rng.normal(size=(n, LATENT)).astype(np.float32)
        else:
            for key in ("mesh", "mesh_n"):
                batch[key] = np.concatenate([rng.normal(size=(n, v, 3)) * 0.1,
                                             rng.integers(0, 4, size=(n, v, 1))], -1).astype(np.float32)
        ej.params, ej.opt_state, loss_j = ej._update(
            ej.params, ej.target_params, ej.opt_state, {k: jnp.asarray(a) for k, a in batch.items()})
        loss_t = float(et.update_on(batch))
        np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    assert min(raw) > 10.0, raw  # the clamp bites in every update
    _assert_net_matches(et.model, ej.params, rtol=0, atol=1e-5)
    _assert_net_matches(et.target_model, ej.target_params, rtol=0, atol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ddqn_train_epoch_and_evaluate_match_jax(world, tmp_path, variant):
    """Two epochs over the train split (4 env steps each) after a burn-in
    of 2 steps drawn by the same seeded sampler, ε 0 after it: identical
    actions, rewards and replay contents, each epoch's mean loss to 1e-5
    relative; then the test rollout: identical actions and scores.  A
    fresh engine resumes from the checkpoint: nets, optimizer, counters
    and replay buffer."""
    ej, et = _ddqn_pair(world, tmp_path, variant, target_update=3)
    for _ in range(2):
        stats_j, stats_t = ej.train_epoch(), et.train_epoch()
        assert stats_t["reward"] == stats_j["reward"] and stats_t["epsilon"] == 0.0
        np.testing.assert_allclose(stats_t["loss"], stats_j["loss"], rtol=1e-5)
    assert (et.total_steps, et.episodes, et.replay.count_seen) == (8, 4, 16)
    assert (ej.total_steps, ej.episodes) == (et.total_steps, et.episodes)
    for key, value in ej.replay.data.items():
        np.testing.assert_array_equal(et.replay.data[key], value, err_msg=key)
    _assert_net_matches(et.model, ej.params, rtol=0, atol=1e-5)
    # the target copy every 3 steps: the last at step 6
    _assert_net_matches(et.target_model, ej.target_params, rtol=0, atol=1e-5)

    result_j, result_t = ej.evaluate("test"), et.evaluate("test")
    np.testing.assert_array_equal(result_t.actions, result_j.actions)
    np.testing.assert_array_equal(result_t.scores, result_j.scores)

    again = DDQNEngine(et.config, data_root=world, env=et.env)
    assert (again.epsilon, again.total_steps, again.episodes) == (0.0, 8, 4)
    for mine, theirs in ((again.model, et.model), (again.target_model, et.target_model)):
        for (key, a), b in zip(theirs.state_dict().items(), mine.state_dict().values()):
            assert torch.equal(a, b), key
    assert again.optimizer.state_dict()["state"][0]["step"] == et.optimizer.state_dict()["state"][0]["step"]
    assert (again.replay.position, again.replay.count_seen) == (et.replay.position, 16)
    for key, value in et.replay.data.items():
        np.testing.assert_array_equal(again.replay.data[key], value, err_msg=key)


def test_ddqn_draws_epsilon_from_its_own_generator(world, tmp_path):
    """At ε 0.5 the actions (random-sampler draws or the net's argmax) are
    a function of the config's seed, whatever numpy's global state: the ε
    draw comes from the engine's own generator."""
    _, env = _policy_envs(world, tmp_path)
    cfg = PolicyConfig(**dict(SMALL, **dict(DDQN, epsilon_start=0.5, epsilon_end=0.5)),
                       experiments_root=str(tmp_path))
    rng = np.random.default_rng(9)
    obs = {"mask": np.zeros((B, 4), np.float32),
           "latent": rng.normal(size=(B, LATENT)).astype(np.float32),
           "first_latent": rng.normal(size=(B, LATENT)).astype(np.float32)}
    actions = []
    for state in (0, 1):
        engine = DDQNEngine(dataclasses.replace(cfg, exp_id=f"eps{state}"), env=env)
        np.random.seed(state)
        actions.append(np.stack([engine.get_action(obs) for _ in range(12)]))
    np.testing.assert_array_equal(actions[0], actions[1])
    greedy = np.argmax(engine.q_values(obs), axis=1)
    drawn = (actions[1] != greedy).any(axis=1)
    assert drawn.any() and not drawn.all()  # both kinds of action occur


# ---- supervised ---------------------------------------------------------

def _supervised_pair(world, tmp_path, **kw):
    jenv, env = _policy_envs(world, tmp_path)
    cfg_j, cfg_t = _configs(tmp_path, "supervised", **dict(NETS, training_actions=3, **kw))
    ej = JaxSupervisedEngine(cfg_j, data_root=world, env=jenv)
    et = SupervisedEngine(cfg_t, data_root=world, env=env)
    for net, params in zip(et.nets, ej.params):
        _load_flax(net, params)
    return ej, et


def test_supervised_matches_jax(world, tmp_path):
    """``train_step_level`` for steps 0 and 1 (step 1 rolls step 0's net
    first) with a poisoned first reset: the same probes (and so the same
    targets, from the same table), each level's loss to 1e-5 relative, the
    parameters after to 1e-5 absolute; then ``_select`` under argmin and
    argmax with taken actions pinned, and ``evaluate``: identical actions
    and scores."""
    ej, et = _supervised_pair(world, tmp_path)
    probes = {"jax": [], "port": []}
    for side, e in (("jax", ej.env), ("port", et.env)):
        table = e.score_candidates
        e.score_candidates = lambda c, table=table, side=side: probes[side].append(c) or table(c)
        reset, calls = e.reset, []

        def poisoned(batch, reset=reset, calls=calls):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("degenerate object")
            return reset(batch)

        e.reset = poisoned
    for step in (0, 1):
        loss_j, loss_t = ej.train_step_level(step), et.train_step_level(step)
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    assert len(probes["port"]) == 3  # 2 batches a level, the first one skipped once
    for a, b in zip(probes["port"], probes["jax"]):
        np.testing.assert_array_equal(a, b)
    for net, params in zip(et.nets, ej.params):
        _assert_net_matches(net, params, rtol=0, atol=1e-5)

    rng = np.random.default_rng(8)
    obs = {"mask": np.zeros((B, 4), np.float32),
           "latent": rng.normal(size=(B, LATENT)).astype(np.float32),
           "first_latent": rng.normal(size=(B, LATENT)).astype(np.float32)}
    for rule in ("argmin", "argmax"):
        for e in (ej, et):
            e.config = dataclasses.replace(e.config, supervised_select=rule)
        for step in (0, 1):
            taken = [et._select(0, obs, [])] if step else []
            np.testing.assert_array_equal(et._select(step, obs, taken), ej._select(step, obs, taken))
    for e in (ej, et):
        e.config = dataclasses.replace(e.config, supervised_select="argmin")
    result_j, result_t = ej.evaluate("test"), et.evaluate("test")
    np.testing.assert_array_equal(result_t.actions, result_j.actions)
    np.testing.assert_array_equal(result_t.scores, result_j.scores)

    again = SupervisedEngine(et.config, data_root=world, env=et.env)  # resumes
    for mine, theirs in zip(again.nets, et.nets):
        for (key, a), b in zip(theirs.state_dict().items(), mine.state_dict().values()):
            assert torch.equal(a, b), key


def test_supervised_train_keeps_the_best_epochs_weights(world, tmp_path):
    """With 3 epochs of which the first validates best, ``train`` ends on
    the weights that epoch left, not on the last epoch's (the optimizer
    updates the live tensors in place, so a kept ``state_dict()`` without a
    copy would be the last epoch's), and the checkpoint holds them."""
    _, env = _policy_envs(world, tmp_path)
    cfg = PolicyConfig(**dict(SMALL, **NETS, budget=1, training_actions=3),
                       experiments_root=str(tmp_path), exp_id="best")
    engine = SupervisedEngine(cfg, data_root=world, env=env)
    scores = iter([0.5, 0.7, 0.9])
    engine._validate_step = lambda step: next(scores)
    after = []
    level = engine.train_step_level

    def snapshot(step, **kw):
        loss = level(step, **kw)
        after.append(copy.deepcopy(engine.nets[0].state_dict()))
        return loss

    engine.train_step_level = snapshot
    engine.train(epochs=3, patience=5)
    assert len(after) == 3
    final = engine.nets[0].state_dict()
    assert not all(torch.equal(final[k], v) for k, v in after[-1].items())
    for key, value in after[0].items():
        assert torch.equal(final[key], value), key
    saved = engine.ckpt.restore("recent")["nets"][0]
    for key, value in after[0].items():
        assert torch.equal(saved[key], value), key


# ---- configs and the frozen vision model --------------------------------

def test_load_config_reads_a_jax_policy_config(tmp_path):
    """A ``PolicyConfig`` file the JAX package wrote, with every learned
    policy field away from its default, rebuilds the same config in the
    port; ``result_tag`` is dropped.  The defaults agree."""
    changed = dict(use_recon=True, pretrained_recon=False, epsilon_start=0.5, epsilon_decay=0.9,
                   epsilon_end=0.1, mem_capacity=64, burn_in=3, train_batch_size=8, gamma=0.5,
                   target_update=10, normalization="current", hidden_dim=32, layers=3,
                   normalize=True, training_actions=7, supervised_select="argmax",
                   supervised_epochs=4, result_tag="supervised_max")
    jax_save_config(str(tmp_path), JaxPolicyConfig(**changed))
    cfg = load_config(str(tmp_path), PolicyConfig)
    changed.pop("result_tag")
    assert cfg == PolicyConfig(**changed)
    ours, theirs = dataclasses.asdict(PolicyConfig()), dataclasses.asdict(JaxPolicyConfig())
    assert set(theirs) - set(ours) == {"result_tag"}
    assert ours == {k: v for k, v in theirs.items() if k in ours}


@pytest.mark.parametrize("pathway", ["touch_global", "touch_plane"])
def test_policy_engine_loads_a_vision_checkpoint_with_a_pathway(world, tmp_path, pathway):
    """A vision checkpoint trained with ``touch_global`` or ``touch_plane``
    loads through ``PolicyEngine`` whose config leaves both off: the
    checkpoint's config turns the pathway on, and the env's frozen model
    holds the checkpoint's weights, the pathway's included."""
    vision = {k: v for k, v in SMALL.items() if k in VisionConfig.__dataclass_fields__}
    vcfg = VisionConfig(**dict(vision, eval=False, seed=3, **{pathway: True}),
                        experiments_root=str(tmp_path / "vision_run"))
    trained = VisionEngine(vcfg, device="cpu", log=False)
    trained.ckpt.save(trained.state_dict(), "best")
    cfg = PolicyConfig(**dict(SMALL, use_latent=False), experiments_root=str(tmp_path),
                       touch_location=str(tmp_path / "touch"), vision_location=vcfg.checkpoint_dir)
    assert not (cfg.touch_global or cfg.touch_plane)
    engine = PolicyEngine(cfg, data_root=world, device="cpu")
    assert getattr(cfg, pathway)
    head = "touch_context" if pathway == "touch_global" else "plane_vertex"
    assert hasattr(engine.env.deform, head)
    loaded = engine.env.deform.state_dict()
    assert loaded.keys() == trained.model.state_dict().keys()
    for key, value in trained.model.state_dict().items():
        assert torch.equal(loaded[key], value), key


def test_learned_engines_default_to_cuda(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    _, env = _policy_envs(world, tmp_path)
    cfg = PolicyConfig(**dict(SMALL, **DDQN), experiments_root=str(tmp_path))
    for cls in (DDQNEngine, SupervisedEngine):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg, data_root=world, env=env, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DDQNEngine(cfg, data_root=world)
