"""The plain reference against the search and the optimizer the
configurations state, on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from benchmark.reference.policy import ddqn_training
from benchmark.reference.vision import clustered_nearest, exact_nearest

SEARCH = {"chunk": 128, "tile": 256, "anchors": 8, "candidate_factor": 3, "votes": 3}


def surface(rows: int, points: int, gen: torch.Generator) -> torch.Tensor:
    v = torch.randn(rows, points, 3, generator=gen)
    v = v / v.norm(dim=-1, keepdim=True)
    return v * torch.tensor([1.0, 0.6, 0.3]) + 0.1 * v[..., :1] ** 2


@pytest.mark.parametrize("n,m,chunks_per_tile", [(3000, 2500, 4), (2000, 4000, 6)])
def test_clustered_search_matches_the_ports_plain_search(n, m, chunks_per_tile):
    """With few chunks a tile, where the pruning misses many exact
    neighbours, the reference finds the neighbour the port's plain
    clustered search finds, point for point."""
    from active_3d_vision_and_touch_tpu_torch.ops.chamfer_cluster import min_dists_clustered

    gen = torch.Generator().manual_seed(n + m)
    x, y = surface(2, n, gen), surface(2, m, gen)
    ref = clustered_nearest(x, y, {**SEARCH, "chunks_per_tile": chunks_per_tile})
    _, port = min_dists_clustered(x, y, 128, chunks_per_tile, plain=True)
    assert torch.equal(ref, port.long())
    assert (ref == exact_nearest(x, y)).float().mean() < 0.9


def test_clustered_search_is_exact_where_every_chunk_is_scanned():
    gen = torch.Generator().manual_seed(7)
    x, y = surface(2, 700, gen), surface(2, 900, gen)
    found = clustered_nearest(x, y, {**SEARCH, "chunks_per_tile": 24})
    exact = exact_nearest(x, y)
    d = lambda i: (x - torch.gather(y, 1, i[..., None].expand(-1, -1, 3))).square().sum(-1)  # noqa: E731
    assert torch.equal(d(found), d(exact))


def test_ddqn_training_follows_torch_adam_update_for_update():
    """The reference's own training, from the same weights over the same
    batches, gives the losses of the value net trained by
    ``torch.optim.Adam`` with each gradient element clamped, bit for bit
    on the CPU."""
    from active_3d_vision_and_touch_tpu_torch.models.policy_nets import LatentValueNet

    cfg = {"normalization": "first", "gamma": 0.0, "budget": 5, "layers": 3, "lr": 3e-4}
    actions, latent, rows = 12, 16, 8
    g = np.random.default_rng(3)
    torch.manual_seed(3)
    net = LatentValueNet(actions, latent, 32, cfg["layers"])
    nets = {k: v.detach().clone() for k, v in net.state_dict().items()}
    opt = torch.optim.Adam(net.parameters(), lr=cfg["lr"])
    batches, losses = [], []
    for _ in range(30):
        mask = (g.random((rows, actions)) < 0.2).astype(np.float32)
        taken = g.integers(0, actions, rows)
        mask_n = mask.copy()
        mask_n[np.arange(rows), taken] = 1
        b = {"mask": mask, "mask_n": mask_n, "actions": taken,
             "rewards": g.normal(0.02, 0.03, rows).astype(np.float32),
             "first_score": g.uniform(0.5, 1.5, rows).astype(np.float32),
             **{k: g.normal(0, 1, (rows, latent)).astype(np.float32) for k in ("latent", "latent_n", "first_latent")}}
        batches.append(b)
        t = {k: torch.as_tensor(v) for k, v in b.items()}
        q = net(t["mask"], t["latent"], t["first_latent"]).gather(1, t["actions"][:, None])[:, 0]
        loss = ((q - t["rewards"] / t["first_score"]) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_value_(net.parameters(), 1.0)
        opt.step()
        losses.append(float(loss.detach()))
    ref = ddqn_training(cfg, nets, batches, [], {30}, "cpu")
    assert ref["losses"] == losses
    for k, p in net.named_parameters():
        assert torch.equal(ref["after"][30][k], p.detach())
