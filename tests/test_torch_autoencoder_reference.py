"""The port's mesh-autoencoder trainer against the benchmark's plain
reference (``benchmark/reference/autoencoder.py``), on the CPU at batch 2:
a frozen v_t_g model of 2 GCN layers x 16 and 3 one-layer CNN blocks on
64x64 images, an autoencoder of 3 GCN layers x 16, a 16-d latent, an 8x8
grid and 128 samples a repeat.

Both sides start from the benchmark's seeded weights and take the same
drawn sampler noise; the reference's autoencoder takes the port's frozen
vertices and masks, as the benchmark's cell feeds it.  Compared: the
frozen eval-mode vertices, the latent and the decoded cloud, each of 3
steps' losses, each kept leaf's first gradient norm and the parameters
after 3 Adam steps."""

import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu_torch.core.config import AutoencoderConfig, VisionConfig
from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from benchmark.reference import vision as vision_reference
from benchmark.reference.autoencoder import AutoencoderReference, FrozenVision, param_specs
from benchmark.reference.compare import kept_leaves, worst_leaf
from benchmark.reference.vision import draw_noise
from benchmark.runners.autoencoder import AUTO_SEED
from benchmark.weights import seeded_weights

B, NUM, REPEAT, STEPS, GRASPS, IMAGE = 2, 128, 3, 3, 2, 64
VISION = dict(use_img=True, use_touch=True, finger=False, num_grasps=GRASPS, num_actions=8, number_points=NUM,
              num_gcn_layers=2, hidden_gcn_size=16, cut=0.33, num_cnn_blocks=3, layers_per_block=1, cnn_kernel=5,
              batch_size=B, lr=3e-4, loss_coeff=9000.0)
AUTO = dict(VISION, num_gcn_layers=3, hidden_gcn_size=16, encoding_size=16, grid_size=8, loss_nn="exact")
MODEL = dict(AUTO, repeat=REPEAT, feature_size=50)
# Tolerances, float32 on both sides, summed in other orders (measured on
# seeds 1-6, one thread).  The frozen vertices agree to 1.1e-7 of a row's
# norm: the same products in another order, through eval-mode BatchNorm
# (no batch statistics).  The latent agrees exactly, the decoded cloud to
# 8.7e-7 of its norm (the reference concatenates code and points where
# the port splits the fold's first product).  The first gradients agree
# to 1.7e-6 of the larger of a leaf's norm and the median leaf's.  Adam's
# first steps move every element by about lr whatever its gradient's
# size, so an element whose gradient lies near its round-off parts by
# that much, and the later steps hold only to that: the losses to 5.2e-5,
# the parameters after 3 steps to 9.4e-3 of the larger of a leaf's change
# and the median leaf's (seed 3; 9.2e-5 and 1.1e-5 on seeds 1 and 2).  A
# row counted twice moves the first loss by about 0.3.
VERTS_RTOL = 1e-5
CODE_RTOL = 1e-5
LOSS_RTOL = 5e-4
GRAD_GAP = 1e-4
PARAM_GAP = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batches(seed: int) -> list[dict]:
    """Noise images, touch slots (two fingers touching a small sheet, one
    not, one failed, as the benchmark's chart caches) and gt clouds."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        codes = np.stack([g.permutation([0, 1, 2, 2]) for _ in range(B * GRASPS)]).reshape(B, GRASPS, 4)
        at = g.normal(size=(B, GRASPS, 4, 1, 3)) * 0.15
        sheets = at + g.normal(size=(B, GRASPS, 4, 25, 3)) * 0.003
        xyz = np.where(codes[..., None, None] == 2, sheets, np.where(codes[..., None, None] == 1, at, 0.0))
        charts = np.concatenate([xyz, np.broadcast_to(codes[..., None, None], (B, GRASPS, 4, 25, 1))], axis=-1)
        out.append({"img": g.uniform(size=(B, IMAGE, IMAGE, 3)), "touch_charts": charts,
                    "gt_points": g.normal(size=(B, 300, 3)) * 0.2})
    return [{k: torch.as_tensor(v, dtype=torch.float32) for k, v in b.items()} for b in out]


def setup(tmp_path, seed: int):
    """The port's engine with the benchmark's seeded weights, and those
    weights ({"vision", "auto"})."""
    cpu = torch.device("cpu")
    weights = {"vision": seeded_weights(vision_reference.param_specs(VISION), seed, cpu),
               "auto": seeded_weights(param_specs(MODEL), seed ^ AUTO_SEED, cpu)}
    common = dict(seed=seed, experiments_root=str(tmp_path), eval=True)
    vision = VisionEngine(VisionConfig(**VISION, **common), device="cpu", log=False)
    engine = AutoencoderEngine(AutoencoderConfig(**AUTO, **common), vision_engine=vision,
                               vision_state=weights["vision"], device="cpu", log=False)
    engine.model.load_state_dict(weights["auto"])
    return engine, weights


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)


@pytest.mark.parametrize("seed", [1, 2])
def test_frozen_vertices_match_the_plain_reference(tmp_path, seed):
    engine, weights = setup(tmp_path, seed)
    ref = FrozenVision(VISION, "cpu")
    for batch in batches(seed):
        verts, mask = engine.deform(batch)
        want = ref.deform_eval(weights["vision"], batch)
        assert verts.shape == want.shape == (B, 1536 + 25 * 4 * GRASPS, 3)
        assert float(row_gaps(verts, want).max()) <= VERTS_RTOL
        # the mask codes: 3 on the vision vertices, each touch slot's own
        codes = torch.cat([torch.full((B, 1536), 3.0), batch["touch_charts"][..., 3].reshape(B, -1)], dim=1)
        assert torch.equal(mask[..., 0], codes)


@pytest.mark.parametrize("seed", [1, 2])
def test_latent_and_decoded_cloud_match_the_plain_reference(tmp_path, seed):
    engine, weights = setup(tmp_path, seed)
    ref = AutoencoderReference(MODEL, "cpu")
    verts, mask = engine.deform(batches(seed)[0])
    with torch.no_grad():
        latent = engine.model.encode(verts, mask, engine.adj)
        decoded = engine.model.decoder(latent)
        want_latent = ref.encode(weights["auto"], verts, mask)
        want_decoded = ref.decode(weights["auto"], want_latent)
    assert latent.shape == (B, 16) and decoded.shape == (B, 64, 3)
    assert float(row_gaps(latent, want_latent).max()) <= CODE_RTOL
    assert float(row_gaps(decoded, want_decoded).max()) <= CODE_RTOL
    # the decoded cloud is spread out, not a point: its nearest pairs decide the loss
    assert float(decoded.std(dim=1).min()) > 1e-2


@pytest.mark.parametrize("seed", [1, 2])
def test_train_steps_match_the_plain_reference(tmp_path, seed):
    engine, weights = setup(tmp_path, seed)
    data = batches(seed)
    gen = torch.Generator().manual_seed(seed)
    draws = [draw_noise(gen, B, NUM * REPEAT, "cpu") for _ in range(STEPS)]
    frozen = [engine.deform(batch) for batch in data]

    losses, grads = [], None
    for batch, d in zip(data, draws):
        losses.append(float(engine.train_step(batch, draws=d)))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in engine.model.named_parameters()}

    ref = AutoencoderReference(MODEL, "cpu")
    p = {k: v.clone().requires_grad_(True) for k, v in weights["auto"].items()}
    opt = torch.optim.Adam(list(p.values()), lr=AUTO["lr"])
    ref_losses, ref_grads = [], None
    for (verts, mask), d in zip(frozen, draws):
        opt.zero_grad(set_to_none=True)
        loss = ref.loss(p, {"verts": verts, "mask": mask}, d, train=True)
        loss.backward()
        if ref_grads is None:
            ref_grads = {k: t.grad.clone() for k, t in p.items()}
        opt.step()
        ref_losses.append(float(loss.detach()))

    assert losses == pytest.approx(ref_losses, rel=LOSS_RTOL)
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    kept = kept_leaves(norms)
    assert kept == list(norms)  # no leaf of the autoencoder sits before a BatchNorm
    gap, leaf = worst_leaf({k: float(grads[k].norm()) for k in kept}, norms, kept)
    assert gap <= GRAD_GAP, leaf
    state = dict(engine.model.named_parameters())
    change = {k: float((p[k].detach() - weights["auto"][k]).norm()) for k in kept}
    floor = float(np.median(list(change.values())))
    for k in kept:
        assert change[k] > 0
        assert float((state[k].detach() - p[k].detach()).norm()) <= PARAM_GAP * max(change[k], floor), k
