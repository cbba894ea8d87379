"""The port's multi-rank layer against the JAX package's mesh layer.

Ranks are processes spawned with ``torch.multiprocessing`` that meet
through a ``file://`` rendezvous under the test's temporary directory and
talk over gloo on the CPU; each spawn is joined with a timeout, and its
ranks are killed and the test fails when it passes.  JAX runs in this
process, on virtual CPU devices.  The rank workers import no JAX: this
module imports it inside the tests only.

- ``chamfer_distance_sharded`` at 2 and 4 ranks against JAX's on a
  ``data_parallel_mesh`` of 2 and 4 devices: exact to rtol 1e-6; the
  clustered search never below the exact one.
- ``hybrid_mesh(2, 2)`` / ``data_parallel_mesh`` and ``shard_batch``: each
  rank's rows equal the rows JAX's batch sharding puts on the device at
  the same mesh position; ``replicate`` gives every rank rank 0's weights.
- One 2-rank ``VisionEngine`` train step (a 2-layer, 16-wide GCN and the
  BatchNorms of a 3-block image encoder, global batch 4) against JAX's
  step on a 2-device mesh with the same weights and draws, at the
  tolerances of ``tests/test_torch_train.py``; and the same step with the
  cross-rank BatchNorm switched off, which does not match.
- A 2-rank ``fit`` over a dataset whose ranks' shares differ by a batch:
  every rank runs the same steps.
- ``Loader(process_shard=...)`` against JAX's, and
  ``maybe_init_distributed``'s reading of torchrun's variables.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from active_3d_vision_and_touch_tpu_torch import cli, parallel
from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig, VisionConfig
from active_3d_vision_and_touch_tpu_torch.data.datasets import TouchDataset
from active_3d_vision_and_touch_tpu_torch.models.vision import BatchNorm, sync_batchnorm_
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import (
    chamfer_distance,
    chamfer_distance_sharded,
)
from active_3d_vision_and_touch_tpu_torch.ops import sample as sampler
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise, sample_faces
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

SPAWN_TIMEOUT_S = 120
B, N, M = 2, 300, 512  # the Chamfer clouds: x (B, N, 3) whole, y (B, M, 3) sharded
# a small v_t_g step: a 2-layer, 16-wide GCN, a 3-block image encoder with
# its BatchNorms, a global batch of 4 (2 rows a rank)
STEP = dict(
    use_img=True, use_touch=True, finger=False, num_grasps=2, batch_size=4,
    number_points=32, num_gcn_layers=2, hidden_gcn_size=16, num_cnn_blocks=3,
    layers_per_block=1, loss_nn="exact", eval=True,
)
STEP_SEED = 0  # the step whose generator draws the sampler noise
# the uneven fit: 11 touch items at a global batch of 6 over 2 ranks; the
# ranks' shares of 6 and 5 items hold 2 and 1 local batches of 3
FIT_ITEMS, FIT_BATCH, FIT_EPOCHS = 11, 6, 2


# -- rank workers (spawned: top-level, torch only) ---------------------------

def _join_group(rank: int, world: int, tmp: str, name: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, name)}", rank=rank, world_size=world
    )


def _chamfer_terms(rank: int, world: int, tmp: str) -> dict:
    clouds = np.load(os.path.join(tmp, "clouds.npz"))
    x = torch.from_numpy(clouds["x"])
    m = M // world
    y = torch.from_numpy(clouds["y"][:, rank * m : (rank + 1) * m].copy())
    out = {nn: chamfer_distance_sharded(x, y, nn=nn) for nn in ("exact", "clustered")}
    try:
        chamfer_distance_sharded(x.requires_grad_(), y)
        out["grad_refused"] = False
    except ValueError:
        out["grad_refused"] = True
    return out


def _four_ranks(rank: int, world: int, tmp: str) -> None:
    _join_group(rank, world, tmp, "rendezvous4")
    out = {"chamfer": _chamfer_terms(rank, world, tmp)}
    batch = {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3), "names": ["a"] * 16}
    for label, mesh in (("hybrid", parallel.hybrid_mesh(2, 2)),
                        ("dp", parallel.data_parallel_mesh())):
        local = parallel.shard_batch(batch, mesh)
        out[label] = {"sharding": parallel.batch_sharding(mesh), "rows": torch.from_numpy(local["x"]),
                      "names": local["names"], "dims": mesh.mesh_dim_names,
                      "shape": tuple(mesh.mesh.shape)}
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank))
    out["replicated"] = parallel.replicate(module).weight.detach().clone()
    torch.save(out, os.path.join(tmp, f"four_rank{rank}.pt"))
    dist.destroy_process_group()


def _vision_step(rank: int, world: int, tmp: str, sync: bool) -> dict:
    data = torch.load(os.path.join(tmp, "step.pt"))
    cfg = VisionConfig(**dict(STEP, experiments_root=os.path.join(tmp, f"exp{rank}")))
    engine = VisionEngine(cfg, device="cpu", log=False)
    engine.model.load_state_dict(data["state"] if rank == 0 else data["other_state"])
    engine.build()  # rank 1 loaded other weights: build takes rank 0's
    if not sync:
        sync_batchnorm_(engine.model, None)
    b = cfg.batch_size // world
    local = {k: v[rank * b : (rank + 1) * b] for k, v in data["batch"].items()}
    before = {k: p.detach().clone() for k, p in engine.model.named_parameters()}
    faces = []  # the sampler's face draw on this rank's rows

    def record(*args):
        faces.append(sample_faces(*args))
        return faces[-1]

    sampler.sample_faces = record
    try:
        loss = engine.train_step(local, engine.step_generator(STEP_SEED))
    finally:
        sampler.sample_faces = sample_faces
    return {
        "loss": float(loss),
        "faces": faces[0],
        "before": before,
        "grads": {k: p.grad.clone() for k, p in engine.model.named_parameters()},
        "after": {k: p.detach().clone() for k, p in engine.model.named_parameters()},
        "state": {k: v.clone() for k, v in engine.model.state_dict().items()},
        "synced": [m.group is not None for m in engine.model.modules() if isinstance(m, BatchNorm)],
    }


def _bn_inputs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 5, 6, 6, generator=g) * 2.0 + 1.0
    upstream = torch.randn(4, 5, 6, 6, generator=g)
    return x, upstream


def _batchnorm_layer(rank: int, world: int) -> dict:
    """One cross-rank BatchNorm on this rank's rows of a fixed batch, its
    output and the gradients of sum(output * upstream)."""
    x, upstream = _bn_inputs()
    b = x.shape[0] // world
    x = x[rank * b : (rank + 1) * b].clone().requires_grad_()
    bn = sync_batchnorm_(BatchNorm(5), dist.group.WORLD).train()
    y = bn(x)
    (y * upstream[rank * b : (rank + 1) * b]).sum().backward()
    parallel.average_gradients(bn)
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad * world,
            "bias_grad": bn.bias.grad * world, "running_var": bn.running_var}


class _TouchItems:
    """``FIT_ITEMS`` seeded touch items in ``TouchDataset``'s layout."""

    collate = staticmethod(TouchDataset.collate)

    def __len__(self):
        return FIT_ITEMS

    def __getitem__(self, i):
        rng = np.random.default_rng(100 + i)
        return {
            "names": f"obj{i}",
            "sim_touch": rng.uniform(size=(121, 121, 3)).astype(np.float32),
            "ref_pos": (rng.normal(size=3) * 0.1).astype(np.float32),
            "ref_rot": np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
            "samples": (rng.normal(size=(50, 3)) * 0.01).astype(np.float32),
        }


def _uneven_fit(rank: int, world: int, tmp: str) -> dict:
    """``fit`` on the command line's sharded loaders of ``_TouchItems``."""
    cfg = TouchConfig(batch_size=FIT_BATCH, num_samples=50, epochs=FIT_EPOCHS,
                      experiments_root=os.path.join(tmp, "fit"))
    engine = TouchEngine(cfg, device="cpu", log=False)
    steps = []
    train_step = engine.train_step
    engine.train_step = lambda *a, **k: steps.append(len(a[0]["ref_pos"])) or train_step(*a, **k)
    make = lambda shuffle: cli._sharded_loader(_TouchItems(), cfg, shuffle, rank, world)  # noqa: E731
    best = engine.fit(make(True), make(False))
    return {"best": best, "local_batches": len(make(True)()), "steps": steps,
            "state": {k: v.clone() for k, v in engine.model.state_dict().items()}}


def _two_ranks(rank: int, world: int, tmp: str) -> None:
    _join_group(rank, world, tmp, "rendezvous2")
    out = {"chamfer": _chamfer_terms(rank, world, tmp),
           "batchnorm": _batchnorm_layer(rank, world),
           "step": _vision_step(rank, world, tmp, sync=True),
           "unsynced": _vision_step(rank, world, tmp, sync=False),
           "fit": _uneven_fit(rank, world, tmp)}
    torch.save(out, os.path.join(tmp, f"two_rank{rank}.pt"))
    dist.destroy_process_group()


def _spawn(fn, world: int, tmp: str):
    """Start ``fn(rank, world, tmp)`` on ``world`` spawned ranks."""
    return mp.start_processes(fn, args=(world, tmp), nprocs=world, join=False,
                              start_method="spawn")


def _join(contexts: list, deadline: float) -> None:
    """Wait for every rank of ``contexts``; kill them all and fail at
    ``deadline`` (``time.monotonic()``)."""
    try:
        for ctx in contexts:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    pytest.fail(f"the ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)


# -- shared inputs ------------------------------------------------------------

@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The inputs written for the ranks, then both spawns' results:
    {"four": [...], "two": [...], "clouds": ..., "step": ...}."""
    from active_3d_vision_and_touch_tpu_torch.convert import deformation_from_flax

    tmp = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.default_rng(0)
    # surface-like clouds, so the clustered search prunes as on real data
    theta = rng.uniform(0, 2 * np.pi, size=(B, N + M))
    phi = np.arccos(rng.uniform(-1, 1, size=(B, N + M)))
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    pts = (pts * rng.uniform(0.1, 0.2, size=(B, 1, 3))).astype(np.float32)
    clouds = {"x": pts[:, :N].copy(), "y": pts[:, N:].copy()}
    np.savez(os.path.join(tmp, "clouds.npz"), **clouds)

    step = _step_inputs()
    state = deformation_from_flax(step["variables"]["params"], step["variables"]["batch_stats"])
    torch.save({
        "state": state,
        "other_state": {k: v + 1.0 for k, v in state.items()},
        "batch": {k: torch.from_numpy(v) for k, v in step["batch"].items()},
    }, os.path.join(tmp, "step.pt"))
    # both spawns at once: their start-up (importing torch) overlaps
    _join([_spawn(_four_ranks, 4, tmp), _spawn(_two_ranks, 2, tmp)],
          time.monotonic() + SPAWN_TIMEOUT_S)
    return {
        **{name: [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt")) for r in range(world)]
           for name, world in (("four", 4), ("two", 2))},
        "clouds": clouds, "step": step,
    }


def _step_inputs() -> dict:
    """A global batch of 4, JAX weights drawn from numpy, and the step's
    sampler noise as the engine draws it from ``step_generator(STEP_SEED)``."""
    import jax.numpy as jnp
    from test_torch_autoencoder import random_variables

    from active_3d_vision_and_touch_tpu.core.config import VisionConfig as JaxVisionConfig
    from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
    from active_3d_vision_and_touch_tpu.train.vision import build_deformation

    rng = np.random.default_rng(1)
    b = STEP["batch_size"]
    touch = (rng.normal(size=(b, STEP["num_grasps"], 4, 25, 4)) * 0.1).astype(np.float32)
    touch[..., 3] = rng.integers(0, 3, size=touch.shape[:-1])
    batch = {
        "img": rng.uniform(size=(b, 64, 64, 3)).astype(np.float32),
        "gt_points": (rng.normal(size=(b, STEP["number_points"], 3)) * 0.1).astype(np.float32),
        "touch_charts": touch,
    }
    model, info, mesh = build_deformation(JaxVisionConfig(**STEP))
    variables = random_variables(
        model, rng, jnp.asarray(batch["img"]), jax_prepare_charts(jnp.asarray(touch), mesh, b),
        jnp.asarray(info.adj), jnp.asarray(info.original),
    )
    engine = SimpleNamespace(config=VisionConfig(), device=torch.device("cpu"))
    draws = draw_sample_noise(b, 3 * STEP["number_points"],
                              VisionEngine.step_generator(engine, STEP_SEED))
    return {"batch": batch, "variables": variables, "draws": draws, "model": model,
            "info": info, "mesh": mesh}


# -- the sharded Chamfer ------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_chamfer_matches_jax_mesh(spawned, world):
    """Exact: every rank's value equals JAX's ``chamfer_distance_sharded``
    on a ``data_parallel_mesh`` of as many devices to rtol 1e-6 (and the
    port's unsharded ``chamfer_distance``); an input that needs a gradient
    is refused."""
    import jax.numpy as jnp

    from active_3d_vision_and_touch_tpu.ops.chamfer import (
        chamfer_distance_sharded as jax_sharded,
    )
    from active_3d_vision_and_touch_tpu.parallel import data_parallel_mesh

    x, y = spawned["clouds"]["x"], spawned["clouds"]["y"]
    expected = np.asarray(jax_sharded(jnp.asarray(x), jnp.asarray(y), data_parallel_mesh(world)))
    whole = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(whole, expected, rtol=1e-6)
    for out in spawned["four" if world == 4 else "two"]:
        np.testing.assert_allclose(out["chamfer"]["exact"].numpy(), expected, rtol=1e-6)
        assert out["chamfer"]["grad_refused"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_clustered_never_below_exact(spawned, world):
    """The clustered search per shard finds a neighbour at least as far as
    the exact one for every query, so its value is never below the exact
    value; on these surface clouds it stays within 5% of it."""
    for out in spawned["four" if world == 4 else "two"]:
        exact, clustered = out["chamfer"]["exact"], out["chamfer"]["clustered"]
        assert bool((clustered >= exact).all())
        assert bool((clustered <= 1.05 * exact).all())


# -- meshes and batch sharding --------------------------------------------------

def test_hybrid_mesh_rows_match_jax_shard_layout(spawned):
    """Rank r of a 2 x 2 ``("dcn", "dp")`` mesh holds the rows that JAX's
    ``hybrid_mesh(2, 2)`` batch sharding puts on the device at mesh
    position r (host-major over both axes); names pass through whole."""
    from active_3d_vision_and_touch_tpu.parallel import hybrid_mesh, shard_batch

    batch = {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)}
    mesh = hybrid_mesh(dcn=2, ici=2)
    sharded = shard_batch(batch, mesh)["x"]
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for rank, out in enumerate(spawned["four"]):
        device = mesh.devices.reshape(-1)[rank]
        assert out["hybrid"]["dims"] == ("dcn", "dp") and out["hybrid"]["shape"] == (2, 2)
        assert out["hybrid"]["sharding"] == (rank, 4)
        np.testing.assert_array_equal(out["hybrid"]["rows"], by_device[device])
        assert out["hybrid"]["names"] == ["a"] * 16


def test_data_parallel_mesh_rows_and_replicate(spawned):
    """A 1-D ``("dp",)`` mesh of 4 ranks shards rows as JAX's
    ``data_parallel_mesh(4)`` does, and ``replicate`` leaves every rank with
    rank 0's weights."""
    from active_3d_vision_and_touch_tpu.parallel import data_parallel_mesh, shard_batch

    batch = {"x": np.arange(16 * 3, dtype=np.float32).reshape(16, 3)}
    mesh = data_parallel_mesh(4)
    sharded = shard_batch(batch, mesh)["x"]
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for rank, out in enumerate(spawned["four"]):
        assert out["dp"]["dims"] == ("dp",) and out["dp"]["sharding"] == (rank, 4)
        np.testing.assert_array_equal(out["dp"]["rows"], by_device[mesh.devices[rank]])
        assert torch.equal(out["replicated"], torch.zeros(2, 3))


# -- the multi-rank train step ---------------------------------------------------

def _jax_mesh_step(step: dict, devices: int) -> dict:
    """JAX's train step on a ``data_parallel_mesh`` of ``devices``: the
    batch and the draws sharded on the batch axis, the weights replicated,
    the sampler fed the draws (the injected noise of
    tests/test_torch_train.py).  Returns the loss, the gradients, the
    running statistics and optax Adam's update."""
    import jax
    import jax.numpy as jnp
    import optax
    from test_torch_autoencoder import _sampler_inputs

    from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
    from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
    from active_3d_vision_and_touch_tpu.ops.sample import (
        _interpolate as jax_interpolate,
        _inverse_cdf_sorted as jax_inverse_cdf_sorted,
        face_areas as jax_face_areas,
    )
    from active_3d_vision_and_touch_tpu.parallel import data_parallel_mesh, replicate, shard_batch

    model, info = step["model"], step["info"]
    adj, orig = jnp.asarray(info.adj), jnp.asarray(info.original)
    faces = jnp.asarray(info.faces)
    mesh = data_parallel_mesh(devices)
    u_face, w = _sampler_inputs(step["draws"])
    sharded = shard_batch({**step["batch"], "u_face": u_face, "w": w}, mesh)
    variables = replicate(step["variables"], mesh)

    def loss_fn(params, batch_stats, batch):
        b = batch["gt_points"].shape[0]
        charts = jax_prepare_charts(batch["touch_charts"], step["mesh"], b)
        (verts, _), upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, batch["img"], charts, adj, orig,
            train=True, mutable=["batch_stats"],
        )
        areas = jnp.abs(jax_face_areas(verts, faces))
        cdf = jnp.cumsum(areas / jnp.sum(areas, axis=1, keepdims=True), axis=1)
        idx = jnp.clip(jax_inverse_cdf_sorted(cdf, batch["u_face"]), 0, faces.shape[0] - 1)
        pts = jax_interpolate(verts, idx, batch["w"], faces)
        preds = jnp.concatenate(jnp.split(pts, 3, axis=1))
        cd = jax_chamfer(preds, jnp.tile(batch["gt_points"], (3, 1, 1)))
        return 9000.0 * jnp.mean(cd.reshape(3, b).mean(axis=0)), (upd["batch_stats"], idx)

    (loss, (stats, faces)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], sharded
    )
    tx = optax.adam(VisionConfig().lr)
    updates, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    return {"loss": float(loss), **jax.device_get({"grads": grads, "stats": stats,
                                                   "updates": updates, "faces": faces})}


@pytest.fixture(scope="module")
def jax_step(spawned):
    from active_3d_vision_and_touch_tpu_torch.convert import deformation_from_flax

    out = _jax_mesh_step(spawned["step"], 2)
    one = _jax_mesh_step(spawned["step"], 1)
    return {
        "loss": out["loss"],
        "grads": deformation_from_flax(out["grads"]),
        "grads_one_device": deformation_from_flax(one["grads"]),
        "deltas": deformation_from_flax(out["updates"]),
        "stats": deformation_from_flax({}, out["stats"]),
        "faces": np.asarray(out["faces"]),
    }


@pytest.mark.parametrize("rank", [0, 1])
def test_two_rank_step_matches_jax_two_device_step(spawned, jax_step, rank):
    """Each rank of the 2-rank step, at tests/test_torch_train.py's
    tolerances: the face draw equal to JAX's, the loss (the global
    batch's) to rtol 1e-3, every gradient to rtol 1e-3 in norm, the
    parameter change to 2% of the learning rate wherever the gradient is
    not tiny (Adam's first step is about lr * sign(g)), the running
    statistics to 1e-5; both ranks start from rank 0's weights and end with
    the same ones.

    A gradient's bound in norm is ``_close_by_norm``'s (1e-3 of the
    reference's norm plus 1e-6 of the model's largest element) plus twice
    the leaf's spread: the norm of the difference between JAX's own
    gradients on 1 and on 2 devices, which draw the same faces and differ
    only in the order of their float32 reductions.  Where JAX's gradient
    does not move by 1e-3 between the two, the bound is about 1e-3; where
    the reduction order alone moves it further, float32 does not fix it to
    1e-3 for any implementation.  ``pytest -s`` prints each leaf's
    reading."""
    out, other = spawned["two"][rank]["step"], spawned["two"][1 - rank]["step"]
    assert all(out["synced"]) and len(out["synced"]) > 0
    assert all(torch.equal(v, other["before"][k]) for k, v in out["before"].items())
    # the face draw on the port's verts must pick JAX's faces, or the two
    # losses sample different points (a draw within rounding of a face
    # boundary of the area CDF may take the neighbouring face)
    b = STEP["batch_size"] // 2
    np.testing.assert_array_equal(out["faces"].numpy(), jax_step["faces"][rank * b : (rank + 1) * b])
    lr = VisionConfig().lr
    np.testing.assert_allclose(out["loss"], jax_step["loss"], rtol=1e-3)
    scale = max(float(g.abs().max()) for g in jax_step["grads"].values())
    print(f"\nrank {rank}: leaf, |port - JAX 2 devices| / |g|, |JAX 1 - JAX 2 devices| / |g|, |g|")
    for key, g in jax_step["grads"].items():
        norm = float(g.norm())
        err = float((out["grads"][key] - g).norm())
        spread = float((jax_step["grads_one_device"][key] - g).norm())
        print(f"  {key:34s} {err / norm:.3e} {spread / norm:.3e} {norm:.4e}")
        assert err <= 1e-3 * norm + 1e-6 * scale + 2 * spread, (key, err, spread, norm)
        solid = g.abs() > 1e-4 * scale
        delta = (out["after"][key] - out["before"][key])[solid]
        np.testing.assert_allclose(delta.numpy(), jax_step["deltas"][key][solid].numpy(),
                                   atol=0.02 * lr, err_msg=key)
        assert torch.equal(out["after"][key], other["after"][key]), key
    for key, value in jax_step["stats"].items():
        np.testing.assert_allclose(out["state"][key].numpy(), value.numpy(), atol=1e-5,
                                   err_msg=key)


def test_cross_rank_batchnorm_layer_equals_whole_batch_layer(spawned):
    """One BatchNorm over 2 ranks' rows against the same layer over the
    whole batch in one process: the output, the gradient of each rank's
    rows (it flows back through the differentiable ``all_reduce``), the
    weight and bias gradients summed over ranks and the running variance,
    all to 1e-5."""
    x, upstream = _bn_inputs()
    x.requires_grad_()
    bn = BatchNorm(5).train()
    y = bn(x)
    (y * upstream).sum().backward()
    for rank, out in enumerate(spawned["two"]):
        got = out["batchnorm"]
        rows = slice(2 * rank, 2 * rank + 2)
        for name, want in (("y", y.detach()[rows]), ("x_grad", x.grad[rows]),
                           ("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad),
                           ("running_var", bn.running_var)):
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=1e-5,
                                       err_msg=name)


def test_two_rank_step_without_cross_rank_batchnorm_differs(spawned, jax_step):
    """With the cross-rank statistics switched off, each rank normalises
    over its own 2 rows: its running statistics leave JAX's global-batch
    ones by more than ten times the 1e-5 tolerance, and its loss leaves
    JAX's by more than the 1e-3 tolerance; the synchronised step above
    meets both."""
    for out in spawned["two"]:
        unsynced = out["unsynced"]
        assert not any(unsynced["synced"])
        worst = max(float((unsynced["state"][k] - v).abs().max())
                    for k, v in jax_step["stats"].items())
        assert worst > 10 * 1e-5
        assert abs(unsynced["loss"] - jax_step["loss"]) > 1e-3 * abs(jax_step["loss"])


def test_uneven_shards_fit_runs_the_same_steps_on_every_rank(spawned):
    """11 items at a global batch of 6 over 2 ranks: the command line's
    sharded loaders give the ranks 2 and 1 local batches of 3, and ``fit``
    runs floor(11 / 6) = 1 train step an epoch on both, each on 3 rows, so
    every collective meets its peer; both ranks end with the same weights
    and the same best loss."""
    fits = [out["fit"] for out in spawned["two"]]
    assert [f["local_batches"] for f in fits] == [2, 1]
    for f in fits:
        assert f["steps"] == [FIT_BATCH // 2] * FIT_EPOCHS
        assert np.isfinite(f["best"]) and f["best"] == fits[0]["best"]
        for key, value in f["state"].items():
            assert torch.equal(value, fits[0]["state"][key]), key


# -- the loader's shards and torchrun's variables -------------------------------

@pytest.mark.parametrize("shard", [(0, 2), (1, 2)])
def test_loader_process_shard_matches_jax(tmp_path, shard):
    """A shuffled ``Loader(process_shard=...)`` yields JAX's batches in
    JAX's order and counts the local share; the two shards are disjoint and
    cover the dataset."""
    from active_3d_vision_and_touch_tpu.data.datasets import Loader as JaxLoader
    from active_3d_vision_and_touch_tpu_torch.data import Loader

    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"i": np.array([i])}

        @staticmethod
        def collate(items):
            return {"i": np.concatenate([it["i"] for it in items])}

    ours = Loader(Items(), 2, seed=5, process_shard=shard)
    theirs = JaxLoader(Items(), 2, seed=5, process_shard=shard)
    assert len(ours) == len(theirs) == (3 if shard == (0, 2) else 2)
    for epoch in range(2):
        a = [b["i"].tolist() for b in ours]
        assert a == [b["i"].tolist() for b in theirs], epoch
    other = Loader(Items(), 1, seed=5, process_shard=(1 - shard[0], 2), drop_last=False)
    mine = Loader(Items(), 1, seed=5, process_shard=shard, drop_last=False)
    rows = [b["i"][0] for b in mine] + [b["i"][0] for b in other]
    assert sorted(rows) == list(range(11))


def test_maybe_init_distributed_reads_torchrun_variables(monkeypatch):
    """Without torchrun's variables it is a no-op returning False; with
    them it joins a gloo group for the CPU with their rank and world
    size through ``env://``."""
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.maybe_init_distributed("cpu") is False and not calls
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    assert parallel.maybe_init_distributed("cpu") is True
    assert calls == [(("gloo",), {"init_method": "env://", "rank": 1, "world_size": 3})]
    assert parallel.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            parallel.maybe_init_distributed("cuda")
