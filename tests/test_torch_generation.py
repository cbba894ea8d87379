"""The port's dataset generation (``data/primitives.py``,
``data/generation.py``) and its env on the default simulator, against the
JAX package's.

Both packages run the same numpy, scipy and C++ source here, so the objects,
the point clouds and every file ``generate_dataset`` writes are equal, not
close.  The touch charts come from two frameworks' convolutions on the same
weights: rtol 1e-4, atol 1e-6, the tolerance of the touch model's parity
tests.  Small sizes: 3 objects, 4 actions, 32^3 voxels, 500 points; the env
at the ``SMALL`` widths of ``test_torch_active.py``.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.active.env import ActiveTouchEnv as JaxActiveTouchEnv
from active_3d_vision_and_touch_tpu.core.config import PolicyConfig as JaxPolicyConfig
from active_3d_vision_and_touch_tpu.core.mesh import touch_chart as jax_touch_chart
from active_3d_vision_and_touch_tpu.data import generation as jax_generation
from active_3d_vision_and_touch_tpu.data.primitives import random_object as jax_random_object
from active_3d_vision_and_touch_tpu.models import TouchChartEncoder as JaxTouchChartEncoder
from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
from active_3d_vision_and_touch_tpu_torch.active import ActiveTouchEnv
from active_3d_vision_and_touch_tpu_torch.convert import deformation_from_flax, touch_encoder_from_flax
from active_3d_vision_and_touch_tpu_torch.core.config import PolicyConfig, TouchConfig
from active_3d_vision_and_touch_tpu_torch.core.mesh import save_obj
from active_3d_vision_and_touch_tpu_torch.data import generation, object_dirs, random_object
from active_3d_vision_and_touch_tpu_torch.models import TouchChartEncoder
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.sim import Sampler
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import build_deformation
from test_torch_active import SMALL, _jax_models, _loaded
from test_torch_autoencoder import _jax_sample, _sampler_inputs, random_variables

OBJECTS, ACTIONS, DIM, POINTS = 3, 4, 32, 500


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The same dataset generated by each package into its own root."""
    roots = {}
    for side, module in (("port", generation), ("jax", jax_generation)):
        roots[side] = str(tmp_path_factory.mktemp(f"generated_{side}"))
        module.generate_dataset(roots[side], OBJECTS, seed=0, num_actions=ACTIONS,
                                point_dim=DIM, num_points=POINTS)
    return roots


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_random_objects_match_jax(version):
    for seed in range(8):
        ours, theirs = random_object(seed, version=version), jax_random_object(seed, version=version)
        np.testing.assert_array_equal(ours.verts, theirs.verts)
        np.testing.assert_array_equal(ours.faces, theirs.faces)


def test_surface_points_match_jax():
    mesh = random_object(5)
    for seed in (0, 1):
        np.testing.assert_array_equal(
            generation.extract_surface_points(mesh.verts, mesh.faces, dim=DIM, num_points=POINTS,
                                              rng=np.random.default_rng(seed)),
            jax_generation.extract_surface_points(mesh.verts, mesh.faces, dim=DIM, num_points=POINTS,
                                                  rng=np.random.default_rng(seed)),
        )


def test_generated_dataset_matches_jax(generated):
    """Every file of ``object_info``, ``point_cloud_info``,
    ``images_colourful`` and ``grasp_info`` (the ``_ref_frame.npy`` dicts
    too) and ``data_split.npy``: the same names, equal arrays; the OBJ
    files equal byte for byte."""
    port, jax_root = generated["port"], generated["jax"]
    files = _files(port)
    assert files == _files(jax_root)
    kinds = {f.split(os.sep)[0] for f in files}
    assert kinds == {"object_info", "point_cloud_info", "images_colourful", "grasp_info",
                     "data_split.npy"}
    assert any(f.endswith("_touch.npy") for f in files)
    assert any(f.endswith("_points.npy") for f in files)
    for f in files:
        a, b = os.path.join(port, f), os.path.join(jax_root, f)
        if f.endswith(".obj"):
            assert open(a, "rb").read() == open(b, "rb").read(), f
            continue
        x, y = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
        if x.dtype == object:
            x, y = x.item(), y.item()
            assert x.keys() == y.keys(), f
            for key in x:
                if isinstance(x[key], list):
                    assert x[key] == y[key], (f, key)
                else:
                    np.testing.assert_array_equal(x[key], y[key], err_msg=f"{f} {key}")
        else:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_ingested_obj_files_match_jax(tmp_path):
    src = tmp_path / "objs"
    src.mkdir()
    for seed, name in ((3, "b_part.obj"), (4, "a_part.obj")):
        mesh = random_object(seed)
        save_obj(str(src / name), mesh.verts * 7.0 + 1.0, mesh.faces)
    names = {}
    for side, module in (("port", generation), ("jax", jax_generation)):
        names[side] = module.ingest_obj_dir(str(tmp_path / side), str(src))
    assert names["port"] == names["jax"] == ["000000", "000001"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for f in _files(tmp_path / "port"):
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=f)
        else:
            assert a.read_bytes() == b.read_bytes(), f


def _touch_variables():
    return random_variables(JaxTouchChartEncoder(), np.random.default_rng(7),
                            jnp.zeros((1, 121, 121, 3)), jnp.zeros((1, 3)), jnp.eye(3)[None],
                            jnp.zeros((25, 3)))


def test_touch_charts_match_jax(generated, tmp_path):
    """``make_touch_charts`` over the port's ``TouchEngine`` on the CPU, its
    weights converted from the variables the JAX producer runs, batches of
    5 (so an object takes several, the last one short): the mask channel
    equal, the chart xyz within rtol 1e-4, atol 1e-6."""
    tv = _touch_variables()
    engine = TouchEngine(TouchConfig(experiments_root=str(tmp_path)), device="cpu", log=False)
    engine.model.load_state_dict(touch_encoder_from_flax(tv["params"], tv["batch_stats"]))
    generation.make_touch_charts(generated["port"], engine, batch=5, num_actions=ACTIONS)
    model, chart = JaxTouchChartEncoder(), jnp.asarray(jax_touch_chart().verts)
    jax_engine = SimpleNamespace(
        predict=lambda state, t, p, r: model.apply(state, t, p, r, chart))
    jax_generation.make_touch_charts(generated["jax"], jax_engine, tv, batch=5, num_actions=ACTIONS)
    for name in ("000000", "000001", "000002"):
        ours, theirs = (np.load(os.path.join(object_dirs(r)["touch_charts"], name, "touch_charts.npy"))
                        for r in (generated["port"], generated["jax"]))
        assert ours.shape == (ACTIONS, 4, 25, 4)
        np.testing.assert_array_equal(ours[..., 3], theirs[..., 3])
        assert (ours[..., 3] == 2).sum() > 5 * 25
        np.testing.assert_allclose(ours[..., :3], theirs[..., :3], rtol=1e-4, atol=1e-6)


def test_env_on_the_default_simulator_matches_jax(generated, tmp_path):
    """The JAX env and the port env, both without a sampler or a chart
    cache, at the SMALL widths on converted weights, over 2 generated
    objects: after ``reset`` and a ``step`` on 2 actions, the signal caches
    hold equal codes and positions and charts within rtol 1e-4, atol 1e-6
    (the touch model's parity tolerance); the committed state's scores, on
    the same sampler draws, within rtol 1e-4 (the env test's)."""
    cfg = dict(SMALL, use_latent=False, num_actions=ACTIONS, experiments_root=str(tmp_path))
    jmodel, jvars, _, _, jinfo, jmesh = _jax_models(np.random.default_rng(4), cfg)
    tv = _touch_variables()
    jenv = JaxActiveTouchEnv(JaxPolicyConfig(**cfg), tv, jvars)
    env = ActiveTouchEnv(
        PolicyConfig(**cfg),
        _loaded(TouchChartEncoder(), touch_encoder_from_flax(tv["params"], tv["batch_stats"])),
        _loaded(build_deformation(PolicyConfig(**cfg), "cpu"),
                deformation_from_flax(jvars["params"], jvars["batch_stats"])),
        device="cpu",
    )
    assert isinstance(env.sampler, Sampler)
    dirs = object_dirs(generated["port"])
    names = ["000000", "000001"]
    batch = {
        "names": [os.path.join(dirs["object_info"], n) for n in names],
        "gt_points": np.stack([np.load(os.path.join(dirs["point_cloud_info"], n + ".npy"))[:128]
                               for n in names]),
        # the SMALL model's 64x64 input, from the 256x256 images
        "img": np.stack([np.load(os.path.join(dirs["images_colourful"], n + ".npy"))[::4, ::4]
                         for n in names]).astype(np.float32) / 255.0,
    }
    actions = np.array([1, 3])
    for e in (jenv, env):
        e.reset(dict(batch, names=list(batch["names"])))
        e.step(actions)
    keys = [(str(p), int(a)) for p, a in zip(batch["names"], actions)]
    assert set(env._sig_cache) == set(jenv._sig_cache) == set(keys)
    for key in keys:
        (c_j, codes_j, pos_j), (c_t, codes_t, pos_t) = jenv._sig_cache[key], env._sig_cache[key]
        np.testing.assert_array_equal(codes_t, codes_j)
        np.testing.assert_array_equal(pos_t, pos_j)
        np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-6)
    assert any((env._sig_cache[k][1] == 2).any() for k in keys)
    np.testing.assert_array_equal(env.current["touch_masks"], jenv.current["touch_masks"])
    np.testing.assert_allclose(env.current["touch_charts"], jenv.current["touch_charts"],
                               rtol=1e-4, atol=1e-6)

    b = len(names)
    draws = draw_sample_noise(b, 3 * 128, torch.Generator().manual_seed(11))
    charts, masks = jenv.current["touch_charts"], jenv.current["touch_masks"]
    stacked = np.concatenate([charts.reshape(b, -1, 3), masks.reshape(b, -1, 1)], -1)
    adj, orig, faces = (jnp.asarray(a) for a in (jinfo.adj, jinfo.original, jinfo.faces))
    verts, _ = jmodel.apply(jvars, batch["img"], jax_prepare_charts(stacked, jmesh, b), adj, orig)
    cd = jax_chamfer(_jax_sample(verts, faces, *_sampler_inputs(draws)),
                     jnp.tile(batch["gt_points"], (3, 1, 1)))
    want = 9000.0 * np.asarray(cd).reshape(3, b).mean(0)
    t = torch.from_numpy
    score = env._reconstruct(t(batch["img"]), t(env.current["touch_charts"]),
                             t(env.current["touch_masks"]), t(batch["gt_points"]), draws=draws)[2]
    np.testing.assert_allclose(score.numpy(), want, rtol=1e-4)
    old = env.sampler
    env.reset_sampler()
    assert isinstance(env.sampler, Sampler) and env.sampler is not old
    for e in (env, jenv):
        e.sampler.disconnect()
