"""Plain reference of the latent DDQN policy's observation and update,
after the published description (pterotactyl ``policies/DDQN/ddqn.py``,
``model.py`` and ``train.py``; Smith et al., arXiv 2107.09584).

- The observation of an env row: the deformation model's mesh of its
  committed charts (``reference.active``), its score, and its latent: the
  mesh autoencoder's encoder, a positional MLP (63 -> f/4 -> f/2 -> f) of
  each vertex plus its mask code's embedding, a GCN stack (the last layer
  aggregating every feature, no ReLU), a max over the vertices and a dense
  head (-> 500 -> 400 -> 300 -> latent, ReLU between).
- The value net: the performed-actions mask through 50 -> 200 -> 100 ->
  latent (ReLU between), beside the current and first latents, then
  ``layers - 1`` ReLU layers of ``hidden_dim`` and one value per action.
- An update on a replay batch: rewards over the first score, the double-Q
  target (the online net's best action not yet performed, valued by the
  target net, times gamma, where the episode goes on), the mean squared
  error of the taken actions' values, each gradient element clamped to
  [-1, 1], and one Adam step (betas 0.9, 0.999, eps 1e-8).
- Training: the online and target nets start from the seeded weights and
  ``torch.optim.Adam`` from nothing; the updates run in order on the
  replay batches, the target net taking the online net's weights where a
  sync falls.
"""

from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.active import GreedyReference, committed_state
from benchmark.reference.vision import cast


def dense_stack(p: dict, prefix: str, x: torch.Tensor, count: int) -> torch.Tensor:
    for k in range(count):
        x = F.linear(x, p[f"{prefix}.{k}.weight"], p[f"{prefix}.{k}.bias"])
        x = F.relu(x) if k < count - 1 else x
    return x


class ObservationReference(GreedyReference):
    """Scores and latents of the env rows' observations: ``auto`` the
    autoencoder's weights, ``caches`` the rows' chart caches."""

    def __init__(self, cfg: dict, weights: dict, auto: dict, caches: list, device, dtype=torch.float32):
        super().__init__(cfg, weights, device, dtype)
        self.auto = cast(auto, dtype, device)
        self.caches = caches

    def observe(self, img, gt, taken: list, gen: torch.Generator) -> tuple[np.ndarray, np.ndarray]:
        """(b,) scores and (b, latent) latents of the objects' observation
        once the actions ``taken`` are committed."""
        ref, a = self.ref, self.cfg["autoencoder"]
        states = committed_state(self.caches, taken, self.cfg["num_grasps"], self.fingers)
        img, gt = (torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device) for x in (img, gt))
        score, verts = self.scores(img, gt, states, gen, meshes=True)
        rows = states.shape[0]
        with torch.no_grad():
            codes = torch.cat([torch.full((rows, ref.atlas.shape[0]), 3.0, device=self.device),
                               torch.as_tensor(states[..., 3].reshape(rows, -1), device=self.device)],
                              dim=1).long()
            x = ref._positional(self.auto, verts, "positional") + self.auto["mask_enc.embed.weight"][codes]
            x = ref._gcn(self.auto, "encoder.gcn", x, ref.adj, layers=a["num_gcn_layers"]).amax(dim=1)
            latent = dense_stack(self.auto, "encoder.dense", x, 4)
        return score.float().cpu().numpy(), latent.float().cpu().numpy()


def q_values(p: dict, mask, latent, first_latent, layers: int) -> torch.Tensor:
    x = dense_stack(p, "mask_embed.dense", mask, 3)
    return dense_stack(p, "dense", torch.cat([x, latent, first_latent], dim=-1), layers)


def ddqn_loss(cfg: dict, params: dict, target: dict, batch: dict, device, dtype=torch.float32,
              fault: str | None = None) -> torch.Tensor:
    """The mean squared error of one update on a replay batch, from the
    online ``params`` and the ``target`` net.  ``fault`` "half" takes the
    first half of the batch's rows."""
    c = cfg
    t = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
    if fault == "half":
        t = {k: v[: v.shape[0] // 2] for k, v in t.items()}
    f = {k: t[k].to(dtype) for k in ("mask", "mask_n", "latent", "latent_n", "first_latent")}
    rewards = t["rewards"].to(dtype)
    if c["normalization"] == "first":
        rewards = rewards / t["first_score"].to(dtype)
    elif c["normalization"] == "current":
        rewards = rewards / t["score"].to(dtype)
    with torch.no_grad():
        nxt = q_values(params, f["mask_n"], f["latent_n"], f["first_latent"], c["layers"])
        best = nxt.masked_fill(f["mask_n"] > 0, -1e10).argmax(dim=1, keepdim=True)
        q_next = q_values(target, f["mask_n"], f["latent_n"], f["first_latent"], c["layers"]).gather(1, best)[:, 0]
        not_done = f["mask"].sum(dim=1) < c["budget"] - 1
        goal = c["gamma"] * torch.where(not_done, q_next, torch.zeros_like(q_next)) + rewards
    q = q_values(params, f["mask"], f["latent"], f["first_latent"], c["layers"]).gather(1, t["actions"].long()[:, None])[:, 0]
    return ((q - goal) ** 2).mean()


def ddqn_training(cfg: dict, nets: dict, batches: list, syncs: list, kept: set, device,
                  dtype=torch.float32, fault: str | None = None) -> dict:
    """The reference's own DDQN training: both nets from the seeded
    ``nets``, ``torch.optim.Adam`` from nothing (each gradient element
    clamped to [-1, 1] before its step), then one update on each of
    ``batches`` in order, the target net synced before update ``k`` for
    each ``k`` in ``syncs``.  Returns each update's loss and the parameters
    after each number of updates in ``kept``; in ``dtype``, with ``fault``
    ("half": every update on the first half of its batch).  PyTorch's own
    Adam rounds as the program's does: two trainings whose Adam rounds
    otherwise jump apart after tens to hundreds of updates."""
    params = {k: v.detach().to(device=device, dtype=dtype).clone().requires_grad_(True) for k, v in nets.items()}
    target = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=cfg["lr"])
    losses, after = [], {}
    for k, batch in enumerate(batches):
        for _ in range(syncs.count(k)):
            target = {n: v.detach().clone() for n, v in params.items()}
        loss = ddqn_loss(cfg, params, target, batch, device, dtype=dtype, fault=fault)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            for v in params.values():
                v.grad.clamp_(-1.0, 1.0)
        opt.step()
        losses.append(float(loss.detach()))
        if k + 1 in kept:
            after[k + 1] = {n: v.detach().clone() for n, v in params.items()}
    return {"losses": losses, "after": after}
