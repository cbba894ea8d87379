"""The port's train steps against the JAX package's, and the engines.

One ``VisionEngine.train_step`` (plain versions on the CPU), with the exact
and with the default clustered loss, and one ``TouchEngine.train_step`` are
held against JAX's loss and ``jax.grad`` on the same converted weights and
the same numpy-made sampler draws.  The JAX side is composed from the JAX
package's ``face_areas``/``_inverse_cdf_sorted``/``_interpolate`` and its
Chamfer functions, as its engines' ``_loss`` composes them inside
``mesh_chamfer_distance``.
"""

import ast
import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from active_3d_vision_and_touch_tpu.core.config import TouchConfig as JaxTouchConfig
from active_3d_vision_and_touch_tpu.core.config import VisionConfig as JaxVisionConfig
from active_3d_vision_and_touch_tpu.models import TouchChartEncoder as JaxTouchChartEncoder
from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
from active_3d_vision_and_touch_tpu.ops.chamfer_cluster import (
    chamfer_clustered_tiled_gt as jax_chamfer_clustered_tiled_gt,
)
from active_3d_vision_and_touch_tpu.ops.sample import (
    _interpolate as jax_interpolate,
    _inverse_cdf_sorted as jax_inverse_cdf_sorted,
    face_areas as jax_face_areas,
)
from active_3d_vision_and_touch_tpu.train.vision import (
    build_deformation as jax_build_deformation,
)
from active_3d_vision_and_touch_tpu_torch.convert import (
    deformation_from_flax,
    touch_encoder_from_flax,
)
from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig, VisionConfig
from active_3d_vision_and_touch_tpu_torch.models import prepare_charts
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise, sample_faces
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(
    use_img=True, use_touch=True, finger=False, batch_size=2, number_points=128,
    num_gcn_layers=3, hidden_gcn_size=32, num_cnn_blocks=3, loss_nn="exact",
    eval=True,
)


def _batch(rng, cfg):
    b = cfg["batch_size"]
    touch = (rng.normal(size=(b, 5, 4, 25, 4)) * 0.1).astype(np.float32)
    touch[..., 3] = rng.integers(0, 3, size=touch.shape[:-1])
    return {
        "img": rng.uniform(size=(b, 64, 64, 3)).astype(np.float32),
        "gt_points": (rng.normal(size=(b, cfg["number_points"], 3)) * 0.1).astype(np.float32),
        "touch_charts": touch,
    }


def _jax_mesh_cd(faces, gt_points, draws, loss_nn, repeat=3):
    """JAX's ``mesh_chamfer_distance`` with the sampler's draws handed in:
    verts → ((B,) Chamfer distances, face ids)."""
    e, u, v = draws
    b = gt_points.shape[0]
    c = np.cumsum(e.astype(np.float64), axis=1).astype(np.float32)
    u_face = jnp.asarray(c[:, :-1] / c[:, -1:])
    su = np.sqrt(u)
    w = jnp.asarray(np.concatenate([1.0 - su, su * (1.0 - v), su * v], axis=-1))
    gt = jnp.asarray(gt_points)

    def mesh_cd(verts):
        areas = jax.lax.stop_gradient(jax_face_areas(verts, faces))
        areas = jnp.where(jnp.isnan(areas), 0.0, jnp.abs(areas))
        cdf = jnp.cumsum(areas / jnp.sum(areas, axis=1, keepdims=True), axis=1)
        idx = jnp.clip(jax_inverse_cdf_sorted(cdf, u_face), 0, faces.shape[0] - 1)
        pts = jax_interpolate(verts, idx, w, faces)
        preds = jnp.concatenate(jnp.split(pts, repeat, axis=1))
        if loss_nn == "clustered":  # the gt is not tiled by the caller
            cd = jax_chamfer_clustered_tiled_gt(preds, gt, repeat)
        else:
            cd = jax_chamfer(preds, jnp.tile(gt, (repeat, 1, 1)))
        return cd.reshape(repeat, b).mean(0), idx

    return mesh_cd


def _jax_loss_fn(model, faces, adj, orig, mesh, batch, draws, coeff, loss_nn):
    """JAX's ``VisionEngine._loss`` in train mode with the sampler's draws
    handed in: (params, batch_stats) → (loss, (new_stats, face ids))."""
    b = batch["gt_points"].shape[0]
    charts = jax_prepare_charts(jnp.asarray(batch["touch_charts"]), mesh, b)
    mesh_cd = _jax_mesh_cd(faces, batch["gt_points"], draws, loss_nn)

    def loss(params, batch_stats):
        (verts, _), upd = model.apply(
            {"params": params, "batch_stats": batch_stats},
            jnp.asarray(batch["img"]), charts, adj, orig,
            train=True, mutable=["batch_stats"],
        )
        cd, idx = mesh_cd(verts)
        return coeff * jnp.mean(cd), (upd["batch_stats"], idx)

    return loss


def _close_by_norm(a, b, scale, rtol=1e-3):
    """||a - b|| <= rtol ||b|| + 1e-6 scale, with ``scale`` the largest
    gradient element of the whole model.  The second term is for the conv
    biases that feed a train-mode BatchNorm: their gradient is zero in exact
    arithmetic, and what both frameworks compute is rounding noise."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.linalg.norm(a - b) <= rtol * np.linalg.norm(b) + 1e-6 * scale)


def test_train_step_matches_jax_loss_grads_and_batch_stats(tmp_path, rng):
    """One v_t_g train step: the loss to rtol 1e-3 of JAX's, every gradient
    to rtol 1e-3 in norm, the BatchNorm running statistics after the step to
    1e-5.  Post-Adam parameters are not compared: the first Adam step is
    about lr * sign(g) wherever |g| is tiny."""
    _check_vision_train_step(tmp_path, rng, "exact")


def test_clustered_train_step_matches_jax(tmp_path, rng):
    """The same step at the default ``loss_nn="clustered"`` (left unset in
    the config), against JAX's ``chamfer_clustered_tiled_gt`` with its
    Pallas kernel in interpret mode: the same tolerances."""
    _check_vision_train_step(tmp_path, rng, None)


def _check_vision_train_step(tmp_path, rng, loss_nn):
    cfg = dict(SMALL, experiments_root=str(tmp_path))
    if loss_nn is None:
        del cfg["loss_nn"]
        assert VisionConfig(**cfg).loss_nn == JaxVisionConfig(**cfg).loss_nn == "clustered"
    engine = VisionEngine(VisionConfig(**cfg), device="cpu", log=False)
    jmodel, jinfo, jmesh = jax_build_deformation(JaxVisionConfig(**cfg))
    adj, orig = jnp.asarray(jinfo.adj), jnp.asarray(jinfo.original)
    faces = jnp.asarray(jinfo.faces)
    batch = _batch(rng, cfg)
    b, n = cfg["batch_size"], 3 * cfg["number_points"]
    draws = tuple(t.numpy() for t in draw_sample_noise(b, n, torch.Generator().manual_seed(7)))

    jcharts = jax_prepare_charts(jnp.asarray(batch["touch_charts"]), jmesh, b)
    variables = jax.device_get(
        jmodel.init(jax.random.PRNGKey(3), jnp.asarray(batch["img"]), jcharts, adj, orig)
    )
    engine.model.load_state_dict(
        deformation_from_flax(variables["params"], variables["batch_stats"])
    )
    loss_fn = _jax_loss_fn(
        jmodel, faces, adj, orig, jmesh, batch, draws, 9000.0, engine.config.loss_nn
    )
    (loss_j, (stats_j, idx_j)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True)
    )(variables["params"], variables["batch_stats"])

    tbatch = engine.to_device(batch)
    # the face draw on the port's own verts must pick JAX's faces, or the
    # two losses sample different points
    probe = copy.deepcopy(engine.model).train()
    with torch.no_grad():
        charts = prepare_charts(tbatch["touch_charts"], engine.initial_mesh, b)
        verts_t, _ = probe(tbatch["img"], charts, engine.adj, engine.original_adj)
        idx_t = sample_faces(verts_t, engine.faces, torch.from_numpy(draws[0]))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))

    loss_t = engine.train_step(tbatch, draws=tuple(torch.from_numpy(a) for a in draws))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)

    grads_t = {k: p.grad for k, p in engine.model.named_parameters()}
    expected = deformation_from_flax(jax.device_get(grads_j))
    assert expected.keys() == grads_t.keys()
    scale = max(float(g.abs().max()) for g in expected.values())
    for key, g in expected.items():
        assert _close_by_norm(grads_t[key].numpy(), g.numpy(), scale), key

    state = engine.model.state_dict()
    for key, value in deformation_from_flax({}, jax.device_get(stats_j)).items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-5, err_msg=key)


def test_engine_trains_evaluates_and_resumes(tmp_path, rng):
    """fit() lowers the loss over a few epochs on one batch, writes best and
    recent checkpoints, and a new engine resumes from them."""
    cfg = VisionConfig(**dict(SMALL, eval=False, epochs=3, experiments_root=str(tmp_path)))
    engine = VisionEngine(cfg, device="cpu", log=True)
    batch = _batch(rng, SMALL)
    first = engine.run_epoch([batch], train=False)
    best = engine.fit(lambda: [batch], lambda: [batch])
    assert np.isfinite(first) and best < first
    assert engine.ckpt.exists("recent") and engine.ckpt.exists("best")
    assert (Path(cfg.checkpoint_dir) / "config.json").exists()
    again = VisionEngine(cfg, device="cpu", log=False)
    again.build()
    assert again.epoch == 3
    for (k, a), b in zip(engine.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), k
    engine.epoch = again.epoch  # the same step generators
    assert again.evaluate([batch]) == engine.evaluate([batch])


def test_entry_points_default_to_cuda(tmp_path):
    """Without a device the engines run on the card, and raise where there
    is none; the default configurations (clustered loss for vision, exact
    for touch, as in the JAX package) construct when the CPU is asked for."""
    cfg = VisionConfig(**dict(SMALL, experiments_root=str(tmp_path)))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VisionEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TouchEngine(TouchConfig(eval=True, experiments_root=str(tmp_path)))
    assert VisionConfig().loss_nn == JaxVisionConfig().loss_nn == "clustered"
    assert TouchConfig().loss_nn == JaxTouchConfig().loss_nn == "exact"
    for field in ("lr", "batch_size", "num_samples"):
        assert getattr(TouchConfig(), field) == getattr(JaxTouchConfig(), field)
    engine = VisionEngine(
        VisionConfig(eval=True, num_gcn_layers=2, hidden_gcn_size=8, num_cnn_blocks=3,
                     touch_global=True, touch_plane=True, experiments_root=str(tmp_path)),
        device="cpu", log=False,
    )
    assert engine.config.loss_nn == "clustered" and hasattr(engine.model, "plane_vertex")


def _touch_batch(rng, b, num):
    rot = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0].astype(np.float32)
    return {
        "sim_touch": rng.uniform(size=(b, 121, 121, 3)).astype(np.float32),
        "ref_pos": (rng.normal(size=(b, 3)) * 0.1).astype(np.float32),
        "ref_rot": rot,
        "samples": (rng.normal(size=(b, num, 3)) * 0.01).astype(np.float32),
    }


def test_touch_train_step_matches_jax(tmp_path, rng):
    """One touch-chart train step: the loss to rtol 1e-3 of JAX's, every
    gradient to rtol 1e-3 in norm, the running statistics to 1e-5, and the
    one-step parameter change against optax's Adam on JAX's gradients: to
    2% of the learning rate wherever the gradient is not tiny (the first
    Adam step is lr * g / (|g| + eps), about lr * sign(g), so where |g| is
    rounding noise the two signs are free to differ).  A conv bias that
    feeds a train-mode BatchNorm has a zero gradient in exact arithmetic:
    both frameworks return rounding noise there, held to 1e-5 of the largest
    gradient element."""
    b, num = 4, 200
    cfg = TouchConfig(batch_size=b, num_samples=num, eval=True, experiments_root=str(tmp_path))
    engine = TouchEngine(cfg, device="cpu", log=False)
    batch = _touch_batch(rng, b, num)
    draws = tuple(t.numpy() for t in draw_sample_noise(b, 3 * num, torch.Generator().manual_seed(7)))

    jmodel = JaxTouchChartEncoder()
    chart, faces = jnp.asarray(engine.chart_verts.numpy()), jnp.asarray(engine.chart_faces.numpy())
    inputs = tuple(jnp.asarray(batch[k]) for k in ("sim_touch", "ref_pos", "ref_rot"))
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(3), *inputs, chart))
    engine.model.load_state_dict(
        touch_encoder_from_flax(variables["params"], variables["batch_stats"])
    )
    before = {k: p.detach().clone() for k, p in engine.model.named_parameters()}
    mesh_cd = _jax_mesh_cd(faces, batch["samples"], draws, cfg.loss_nn)

    def loss_fn(params, batch_stats):
        verts, upd = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, *inputs, chart,
            train=True, mutable=["batch_stats"],
        )
        return cfg.loss_coeff * jnp.mean(mesh_cd(verts)[0]), upd["batch_stats"]

    (loss_j, stats_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"]
    )
    tx = optax.adam(cfg.lr)
    updates, _ = tx.update(grads_j, tx.init(variables["params"]), variables["params"])

    loss_t = engine.train_step(
        engine.to_device(batch), draws=tuple(torch.from_numpy(a) for a in draws)
    )
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)
    grads_t = {k: p.grad for k, p in engine.model.named_parameters()}
    expected = touch_encoder_from_flax(jax.device_get(grads_j))
    deltas = touch_encoder_from_flax(jax.device_get(updates))
    assert expected.keys() == grads_t.keys()
    scale = max(float(g.abs().max()) for g in expected.values())
    after = dict(engine.model.named_parameters())
    for key, g in expected.items():
        if key.endswith("bias") and ".convs." in key and key != "blocks.5.convs.2.bias":
            assert float(g.abs().max()) <= 1e-5 * scale, key
            assert float(grads_t[key].abs().max()) <= 1e-5 * scale, key
        else:
            assert _close_by_norm(grads_t[key].numpy(), g.numpy(), scale), key
        solid = g.abs() > 1e-4 * scale
        delta_t = (after[key].detach() - before[key])[solid]
        np.testing.assert_allclose(
            delta_t.numpy(), deltas[key][solid].numpy(), atol=0.02 * cfg.lr, err_msg=key
        )
    state = engine.model.state_dict()
    for key, value in touch_encoder_from_flax({}, jax.device_get(stats_j)).items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-5, err_msg=key)


def test_touch_engine_trains_and_predicts(tmp_path, rng):
    """fit() lowers the touch loss on one batch, ``predict`` is the frozen
    eval-mode forward, and a new engine resumes from the checkpoint."""
    cfg = TouchConfig(batch_size=4, num_samples=100, epochs=3, lr=1e-3,
                      experiments_root=str(tmp_path))
    engine = TouchEngine(cfg, device="cpu", log=False)
    batch = _touch_batch(rng, 4, 100)
    first = engine.run_epoch([batch], train=False)
    best = engine.fit(lambda: [batch], lambda: [batch])
    assert np.isfinite(first) and best < first
    tb = engine.to_device(batch)
    verts = engine.predict(tb["sim_touch"], tb["ref_pos"], tb["ref_rot"])
    assert verts.shape == (4, 25, 3) and not verts.requires_grad
    assert not engine.model.training
    again = TouchEngine(cfg, device="cpu", log=False)
    again.build()
    assert again.epoch == 3
    assert torch.equal(again.predict(tb["sim_touch"], tb["ref_pos"], tb["ref_rot"]), verts)


# the card's machine has neither OpenCV nor PIL: the port writes its PNGs
# with its own encoder (utils/viz.py::write_png)
_BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "active_3d_vision_and_touch_tpu", "cv2", "PIL"}


# the tests that run on the card's machine, which has no JAX
_CARD_TESTS = ("test_torch_kernels.py", "test_torch_step_graph.py", "test_torch_card.py")


def _port_sources():
    return sorted((REPO / "active_3d_vision_and_touch_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ] + [REPO / "tests" / name for name in _CARD_TESTS]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    """No module of the port, not chip_smoke.py and none of the tests run
    on the card imports JAX, flax, optax, orbax, the JAX package, OpenCV or
    PIL (at any level of the file)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in _BANNED, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter, importing every module of the port (and
    chip_smoke.py) leaves jax, the JAX package, OpenCV and PIL out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import active_3d_vision_and_touch_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(_BANNED)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
