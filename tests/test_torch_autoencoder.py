"""The port's mesh autoencoder and its trainer against the JAX package's.

Small sizes: a 2-layer x 16-wide GCN, encoding 16, an 8 x 8 folding grid,
128 Chamfer samples, batch 2, on the atlas of 2 grasps.  The frozen vision
model is a 3-layer x 16-wide ``Deformation`` with 3 one-layer CNN blocks on
64x64 images, whose BatchNorm running statistics are set away from their initial
values so that eval mode shows.  JAX and the port run float32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.core.config import AutoencoderConfig as JaxAutoencoderConfig
from active_3d_vision_and_touch_tpu.core.config import VisionConfig as JaxVisionConfig
from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
from active_3d_vision_and_touch_tpu.models.autoencoder import MeshAutoEncoder as JaxMeshAutoEncoder
from active_3d_vision_and_touch_tpu.models.autoencoder import folding_grid as jax_folding_grid
from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
from active_3d_vision_and_touch_tpu.ops.sample import (
    _interpolate as jax_interpolate,
    _inverse_cdf_sorted as jax_inverse_cdf_sorted,
    face_areas as jax_face_areas,
)
from active_3d_vision_and_touch_tpu.parallel import data_parallel_mesh
from active_3d_vision_and_touch_tpu.train.autoencoder import (
    AutoencoderEngine as JaxAutoencoderEngine,
)
from active_3d_vision_and_touch_tpu.train.vision import VisionEngine as JaxVisionEngine
from active_3d_vision_and_touch_tpu.train.vision import (
    build_deformation as jax_build_deformation,
)
from active_3d_vision_and_touch_tpu_torch.convert import (
    autoencoder_from_flax,
    deformation_from_flax,
)
from active_3d_vision_and_touch_tpu_torch.core.config import AutoencoderConfig, VisionConfig
from active_3d_vision_and_touch_tpu_torch.models import MeshAutoEncoder, folding_grid
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

VISION = dict(
    use_img=True, use_touch=True, finger=False, num_grasps=2, batch_size=2,
    number_points=128, num_gcn_layers=3, hidden_gcn_size=16, num_cnn_blocks=3,
    layers_per_block=1, eval=True,
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

def _batch(rng, b=2, grasps=2, points=128):
    touch = (rng.normal(size=(b, grasps, 4, 25, 4)) * 0.1).astype(np.float32)
    touch[..., 3] = rng.integers(0, 3, size=touch.shape[:-1])
    return {
        "img": rng.uniform(size=(b, 64, 64, 3)).astype(np.float32),
        "gt_points": (rng.normal(size=(b, points, 3)) * 0.1).astype(np.float32),
        "touch_charts": touch,
    }


def random_variables(module, rng, *args) -> dict:
    """Variables of the structure ``module.init`` gives for ``args``, drawn
    from numpy without compiling the init: kernels and GCN weights normal
    over the square root of their fan-in (as flax's default), embeddings
    normal over the square root of their width, scales near 1, biases and
    running means small, running variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("kernel", "weight"):
            value = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            value = rng.normal(size=shape) / np.sqrt(shape[-1])
        elif name == "scale":
            value = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, size=shape)
        else:  # bias, mean
            value = rng.uniform(-0.1, 0.1, size=shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_vision(rng, batch):
    """(flax Deformation, its variables with running statistics away from
    their initial values, adj info, initial mesh) at the small vision
    config."""
    jmodel, jinfo, jmesh = jax_build_deformation(JaxVisionConfig(**VISION))
    charts = jax_prepare_charts(jnp.asarray(batch["touch_charts"]), jmesh, 2)
    adj, orig = jnp.asarray(jinfo.adj), jnp.asarray(jinfo.original)
    variables = random_variables(jmodel, rng, jnp.asarray(batch["img"]), charts, adj, orig)
    return jmodel, variables, jinfo, jmesh


def _sampler_inputs(draws):
    """The port's sampler draws (torch) → the JAX sampler's sorted face
    uniforms and barycentric weights (numpy)."""
    e, u, v = (d.numpy() for d in draws)
    c = np.cumsum(e.astype(np.float64), axis=1).astype(np.float32)
    su = np.sqrt(u)
    return c[:, :-1] / c[:, -1:], np.concatenate([1.0 - su, su * (1.0 - v), su * v], axis=-1)


def _jax_sample(verts, faces, u_face, w, repeat=3):
    """The JAX sampler on given draws: (B, V, 3) → (repeat*B, num, 3)
    folded clouds, as ``mesh_chamfer_distance`` folds them."""
    areas = jnp.abs(jax_face_areas(verts, faces))
    cdf = jnp.cumsum(areas / jnp.sum(areas, axis=1, keepdims=True), axis=1)
    idx = jnp.clip(jax_inverse_cdf_sorted(cdf, u_face), 0, faces.shape[0] - 1)
    return jnp.concatenate(jnp.split(jax_interpolate(verts, idx, w, faces), repeat, axis=1))


@pytest.mark.parametrize("size", [1, 8, 80])
def test_folding_grid_is_bit_equal(size):
    np.testing.assert_array_equal(folding_grid(size), jax_folding_grid(size))


def test_autoencoder_matches_jax_on_converted_weights(rng):
    """Latent and decoded cloud within 1e-4 of flax's, on a deformed-mesh
    sized input (1736 vertices of the 2-grasp atlas, all four mask codes)."""
    _, jinfo, _ = jax_build_deformation(JaxVisionConfig(**VISION))
    v = jinfo.num_verts
    verts = (rng.normal(size=(2, v, 3)) * 0.2).astype(np.float32)
    mask = rng.integers(0, 4, size=(2, v, 1)).astype(np.float32)
    jae = JaxMeshAutoEncoder(**AE)
    params = random_variables(jae, rng, verts, mask, jinfo.adj)["params"]
    decoded_j, latent_j = jax.jit(jae.apply)({"params": params}, verts, mask, jinfo.adj)

    model = MeshAutoEncoder(**AE)
    model.load_state_dict(autoencoder_from_flax(params))
    with torch.no_grad():
        decoded, latent = model(torch.from_numpy(verts), torch.from_numpy(mask),
                                torch.from_numpy(jinfo.adj))
        alone = model(torch.from_numpy(verts), torch.from_numpy(mask),
                      torch.from_numpy(jinfo.adj), only_encode=True)
    assert decoded.shape == (2, 64, 3) and latent.shape == (2, 16)
    np.testing.assert_allclose(latent.numpy(), np.asarray(latent_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(decoded_j), rtol=1e-4, atol=1e-4)
    assert torch.equal(alone, latent)


def test_autoencoder_converter_consumes_every_leaf_once(rng):
    jae = JaxMeshAutoEncoder(**AE)
    verts, mask, adj = np.zeros((1, 6, 3), np.float32), np.zeros((1, 6, 1), np.float32), np.eye(6)
    params = random_variables(jae, rng, verts, mask, adj)["params"]
    state = autoencoder_from_flax(params)
    assert state.keys() == MeshAutoEncoder(**AE).state_dict().keys()
    params["encoder"]["Conv_0"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError, match="encoder/Conv_0"):
        autoencoder_from_flax(params)


def test_autoencoder_train_step_matches_jax(tmp_path, rng):
    """One ``AutoencoderEngine.train_step`` at ``loss_nn="exact"`` against a
    JAX composition of the frozen ``Deformation`` (eval mode), the flax
    autoencoder and the exact Chamfer distance, on the same weights and
    sampler draws: loss rtol 1e-3, every gradient rtol 1e-3 in norm.  The
    frozen model stays in eval mode, unchanged, with no gradient."""
    batch = _batch(rng)
    jmodel, jvars, jinfo, jmesh = _jax_vision(rng, batch)
    adj, orig, faces = (jnp.asarray(a) for a in (jinfo.adj, jinfo.original, jinfo.faces))
    draws = draw_sample_noise(2, 3 * 128, torch.Generator().manual_seed(5))

    @jax.jit
    def frozen(touch_charts, img, u_face, w):
        charts = jax_prepare_charts(touch_charts, jmesh, 2)
        verts, mask = jmodel.apply(jvars, img, charts, adj, orig)
        return verts, mask, _jax_sample(verts, faces, u_face, w)

    verts, mask, preds = frozen(batch["touch_charts"], batch["img"], *_sampler_inputs(draws))
    jae = JaxMeshAutoEncoder(**AE)
    ae_params = random_variables(jae, rng, verts, mask, adj)["params"]

    def loss_fn(params):
        decoded, _ = jae.apply({"params": params}, verts, mask, adj)
        cd = jax_chamfer(preds, jnp.tile(decoded, (3, 1, 1))).reshape(3, 2).mean(0)
        return 9000.0 * jnp.mean(cd)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(ae_params)

    vision = VisionEngine(VisionConfig(**VISION, experiments_root=str(tmp_path)),
                          device="cpu", log=False)
    cfg = AutoencoderConfig(**{**VISION, **AE}, experiments_root=str(tmp_path), exp_id="ae")
    assert cfg.loss_nn == "exact"
    engine = AutoencoderEngine(
        cfg, vision_engine=vision,
        vision_state=deformation_from_flax(jvars["params"], jvars["batch_stats"]),
        device="cpu", log=False,
    )
    engine.model.load_state_dict(autoencoder_from_flax(ae_params))
    frozen = {k: v.clone() for k, v in vision.model.state_dict().items()}
    tbatch = engine.to_device(batch)
    verts_t, _ = engine.deform(tbatch)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts), rtol=1e-4, atol=1e-5)
    loss_t = engine.train_step(tbatch, draws=draws)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)
    grads_t = {k: p.grad for k, p in engine.model.named_parameters()}
    expected = autoencoder_from_flax(jax.device_get(grads_j))
    assert expected.keys() == grads_t.keys()
    scale = max(float(g.abs().max()) for g in expected.values())
    for key, g in expected.items():
        err = float(torch.linalg.vector_norm(grads_t[key] - g))
        assert err <= 1e-3 * float(torch.linalg.vector_norm(g)) + 1e-6 * scale, key

    assert not vision.model.training
    assert all(p.grad is None and not p.requires_grad for p in vision.model.parameters())
    for key, value in vision.model.state_dict().items():
        assert torch.equal(value, frozen[key]), key


def test_autoencoder_refuses_clustered_and_defaults_to_cuda(tmp_path):
    """``loss_nn="clustered"`` (the JAX package's inherited default) raises
    ValueError and says why; the default ``"exact"`` engine runs on the card
    and raises where there is none."""
    assert AutoencoderConfig().loss_nn == "exact"
    assert JaxAutoencoderConfig().loss_nn == "clustered"
    cfg = AutoencoderConfig(**{**VISION, **AE}, experiments_root=str(tmp_path), loss_nn="clustered")
    with pytest.raises(ValueError, match="no gradient"):
        AutoencoderEngine(cfg, device="cpu", log=False)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoencoderEngine(AutoencoderConfig(eval=True, experiments_root=str(tmp_path)))


@pytest.fixture(scope="module")
def jax_ae_grad_norms(tmp_path_factory):
    """The JAX package's autoencoder gradient norm under each loss, one
    frozen vision model, one batch and one set of autoencoder weights for
    both."""
    small = dict(use_img=False, use_touch=True, num_gcn_layers=2, hidden_gcn_size=16,
                 number_points=128, num_grasps=2, eval=True,
                 experiments_root=str(tmp_path_factory.mktemp("jax_ae")))
    vision = JaxVisionEngine(JaxVisionConfig(**small), mesh=data_parallel_mesh(), log=False)
    vision_state = jax.jit(vision.init_state)(jax.random.PRNGKey(0))
    batch = {k: v for k, v in _batch(np.random.default_rng(0)).items() if k != "img"}
    norms, params = {}, None
    for loss_nn in ("clustered", "exact"):
        engine = JaxAutoencoderEngine(
            JaxAutoencoderConfig(**small, encoding_size=16, grid_size=8, loss_nn=loss_nn),
            vision_engine=vision, vision_state=vision_state, mesh=data_parallel_mesh(), log=False,
        )
        if params is None:
            params = jax.jit(engine.init_state)(jax.random.PRNGKey(1))["params"]
        grads = jax.jit(jax.grad(engine._loss))(params, batch, jax.random.PRNGKey(2))
        norms[loss_nn] = float(jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads))))
    return norms


@pytest.mark.parametrize("loss_nn", ["clustered", "exact"])
def test_jax_autoencoder_gradient_is_zero_with_the_clustered_loss(jax_ae_grad_norms, loss_nn):
    """Why the port's autoencoder refuses ``"clustered"``: in the JAX package
    the autoencoder's gradient norm is exactly 0 with the clustered loss
    (its cotangent for the decoded cloud, the gt argument, is zero) and
    positive with the exact one.  If the reference changes, this says so."""
    norm = jax_ae_grad_norms[loss_nn]
    if loss_nn == "clustered":
        assert norm == 0.0
    else:
        assert norm > 0.0 and np.isfinite(norm)


def test_autoencoder_engine_trains_encodes_and_clusters(tmp_path, rng):
    """fit() lowers the loss on one batch; ``collect_latents`` encodes a
    loader's batches with the names kept; ``cluster`` writes its collages."""
    vcfg = VisionConfig(**VISION, experiments_root=str(tmp_path))
    vision = VisionEngine(vcfg, device="cpu", log=False)
    cfg = AutoencoderConfig(**{**VISION, **AE, "eval": False}, epochs=3, lr=1e-3,
                            experiments_root=str(tmp_path), exp_id="ae")
    engine = AutoencoderEngine(cfg, vision_engine=vision, device="cpu", log=False)
    batch = _batch(rng)
    first = engine.run_epoch([batch], train=False)
    best = engine.fit(lambda: [batch], lambda: [batch])
    assert np.isfinite(first) and best < first
    assert not vision.model.training

    image_dir = tmp_path / "images"
    image_dir.mkdir()
    for name in ("obj_a", "obj_b"):
        np.save(image_dir / f"{name}.npy", rng.integers(0, 255, size=(8, 8, 3)).astype(np.uint8))
    named = dict(batch, names=[("obj_a", ()), ("obj_b", ())])
    latents, names = engine.collect_latents([named])
    assert latents.shape == (2, 16) and np.isfinite(latents).all()
    assert names == named["names"]
    paths = engine.cluster([named], str(image_dir), str(tmp_path / "collages"),
                           examples=2, neighbors=1)
    assert len(paths) == 2 and all(p.endswith(".png") for p in paths)
