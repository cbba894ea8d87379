"""The port's touch-chart trainer against the benchmark's plain reference
(``benchmark/reference/touch.py``), on the CPU at batch 4 and 256 samples a
chart (121x121 gel images: the encoder's flatten fixes the size).

Both sides start from the benchmark's seeded weights and take the same
drawn sampler noise.  Compared: the loss of each of 3 steps, each kept
leaf's first gradient norm and the parameters after 3 Adam steps (the
conv biases ahead of a train-mode BatchNorm, whose exact gradient is 0,
are left out as the benchmark leaves them out); and the rigid transform
alone against ``R @ v + t``."""

import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from benchmark.reference.compare import kept_leaves, worst_leaf
from benchmark.reference.touch import TouchReference, param_specs, rigid
from benchmark.reference.vision import draw_noise, is_parameter
from benchmark.weights import seeded_weights

B, NUM, REPEAT, STEPS = 4, 256, 3, 3
# Tolerances, float32 on both sides, summed in other orders (measured on 6
# seeds, one thread).  The first loss agrees to round-off: 3.4e-7 to
# 6.2e-6.  The first gradients agree to round-off carried back through
# six train-mode BatchNorms over 4 rows (2x2 maps in the last block): a
# leaf's norm to 6.6e-3 of the larger of its own and the median leaf's.
# Adam's first step moves every element by +-lr whatever its size, so the
# elements whose gradient lies near its round-off step apart, and from
# the second step on the two trainings hold only to that: the later
# losses to 2.0e-2, the parameters to 0.10 of the larger of the leaf's
# change and the median leaf's.  A row left out or counted twice moves
# the first loss by about 0.3.
FIRST_LOSS_RTOL = 1e-4
LOSS_RTOL = 0.05
GRAD_GAP = 0.02
PARAM_GAP = 0.3


def config() -> dict:
    return dict(batch_size=B, num_samples=NUM, lr=1e-4, loss_coeff=9000.0, loss_nn="exact")


def batches(seed: int) -> list[dict]:
    """Gel images, fingertip frames and touch clouds (curved patches about
    each fingertip), float32."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        rot = np.linalg.qr(g.normal(size=(B, 3, 3)))[0]
        pos = g.normal(size=(B, 3)) * 0.1
        xy = g.uniform(-0.01, 0.01, size=(B, 600, 2))
        local = np.concatenate([xy, (10 * xy**2).sum(-1, keepdims=True)], axis=-1)
        out.append({
            "sim_touch": g.uniform(size=(B, 121, 121, 3)),
            "ref_pos": pos,
            "ref_rot": rot,
            "samples": np.einsum("bij,bpj->bpi", rot, local) + pos[:, None],
        })
    return [{k: torch.as_tensor(v, dtype=torch.float32) for k, v in b.items()} for b in out]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [1, 2])
def test_train_steps_match_the_plain_reference(tmp_path, seed):
    cfg = config()
    engine = TouchEngine(TouchConfig(**cfg, seed=seed, experiments_root=str(tmp_path), eval=True),
                         device="cpu", log=False)
    weights = seeded_weights(param_specs(cfg), seed, torch.device("cpu"))
    engine.model.load_state_dict(weights)
    data = batches(seed)
    gen = torch.Generator().manual_seed(seed)
    draws = [draw_noise(gen, B, NUM * REPEAT, "cpu") for _ in range(STEPS)]

    losses, grads = [], None
    for batch, d in zip(data, draws):
        losses.append(float(engine.train_step(batch, draws=d)))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in engine.model.named_parameters()}

    ref = TouchReference({**cfg, "repeat": REPEAT}, "cpu")
    names = [k for k in weights if is_parameter(k)]
    p = {k: v.clone().requires_grad_(k in names) for k, v in weights.items()}
    opt = torch.optim.Adam([p[k] for k in names], lr=cfg["lr"])
    ref_losses, ref_grads = [], None
    for batch, d in zip(data, draws):
        opt.zero_grad(set_to_none=True)
        loss = ref.loss(p, batch, d, train=True)
        loss.backward()
        if ref_grads is None:
            ref_grads = {k: p[k].grad.clone() for k in names}
        opt.step()
        ref_losses.append(float(loss.detach()))

    assert losses[0] == pytest.approx(ref_losses[0], rel=FIRST_LOSS_RTOL)
    assert losses == pytest.approx(ref_losses, rel=LOSS_RTOL)
    norms = {k: float(g.norm()) for k, g in ref_grads.items()}
    kept = kept_leaves(norms)
    before_bn = {f"blocks.{i}.convs.{k}.bias" for i in range(6) for k in range(3)} - {"blocks.5.convs.2.bias"}
    assert set(norms) - set(kept) == before_bn
    gap, leaf = worst_leaf({k: float(grads[k].norm()) for k in kept}, norms, kept)
    assert gap <= GRAD_GAP, leaf
    state = dict(engine.model.named_parameters())
    change = {k: float((p[k].detach() - weights[k]).norm()) for k in kept}
    floor = float(np.median(list(change.values())))
    for k in kept:
        assert change[k] > 0
        assert float((state[k].detach() - p[k].detach()).norm()) <= PARAM_GAP * max(change[k], floor), k


def test_rigid_transform_is_r_v_plus_t(tmp_path, monkeypatch):
    """The port's chart in the fingertip frame, with the offsets held at 0,
    and the reference's ``rigid``, against ``R @ v + t`` row by row."""
    g = np.random.default_rng(5)
    rot = np.linalg.qr(g.normal(size=(3, 3, 3)))[0].astype(np.float32)
    pos = g.normal(size=(3, 3)).astype(np.float32)
    verts = g.normal(size=(3, 25, 3)).astype(np.float32)
    want = np.stack([verts[b] @ rot[b].T + pos[b] for b in range(3)])
    got = rigid(torch.as_tensor(verts), torch.as_tensor(pos), torch.as_tensor(rot))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    engine = TouchEngine(TouchConfig(experiments_root=str(tmp_path), eval=True), device="cpu", log=False)
    monkeypatch.setattr(engine.model, "predict_verts", lambda touch: torch.zeros(touch.shape[0], 25, 3))
    chart = engine.chart_verts.numpy()
    out = engine.predict(torch.zeros(3, 121, 121, 3), torch.as_tensor(pos), torch.as_tensor(rot))
    want = np.stack([chart @ rot[b].T + pos[b] for b in range(3)])
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
