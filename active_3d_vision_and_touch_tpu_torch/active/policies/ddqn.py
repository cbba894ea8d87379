"""Double-DQN policy over latent or mesh observations.

Port of the JAX package's ``active/policies/ddqn.py``: an ε-greedy actor
with performed-action penalization, a small replay buffer, a double-Q
target net, rewards normalized by the first or the current score, and each
gradient element clamped to [-1, 1] before Adam (the reference's
``ddqn.py:120-122``; not a norm clip) — the reference's algorithm
(``policies/DDQN/ddqn.py:15-143`` and ``train.py:102-172``).  Kept on
purpose: γ = 0 by default, 300 replay slots.

The ε draw comes from a ``numpy`` generator the engine owns, seeded from
``config.seed``; the JAX package draws it from numpy's global state.

Spans (``utils/profiler.py``, recorded under a profiler): ``ddqn.act``,
``ddqn.update`` over the replay's ``replay.sample``, ``ddqn.update_on`` and
``ddqn.fetch`` (the loss to the host), ``ddqn.target_sync`` and
``ddqn.save``; the replay's ``replay.push``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.baselines import RandomSampler
from active_3d_vision_and_touch_tpu_torch.active.policies.rollout import run_rollouts
from active_3d_vision_and_touch_tpu_torch.active.replay import ReplayMemory
from active_3d_vision_and_touch_tpu_torch.models.policy_nets import (
    GraphValueNet,
    LatentValueNet,
)
from active_3d_vision_and_touch_tpu_torch.models.vision import init_modules_
from active_3d_vision_and_touch_tpu_torch.train.common import CheckpointManager
from active_3d_vision_and_touch_tpu_torch.utils.profiler import span


def _default_dims(use_latent: bool, use_img: bool, finger: bool) -> tuple[int, int]:
    """(hidden_dim, layers) of the value net over pretrained reconstruction
    models, per setting (reference ``ddqn.py:31-62``)."""
    if use_latent:
        return 300, (5 if (use_img or finger) else 2)
    return 100, (5 if (use_img or finger) else 2)


class DDQNEngine(PolicyEngine):
    name = "ddqn"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        c = self.config
        if not (c.use_latent or c.use_recon):
            raise ValueError("DDQN needs the latent (use_latent) or mesh (use_recon) observation")
        if c.pretrained_recon:
            c.hidden_dim, c.layers = _default_dims(c.use_latent, c.use_img, c.finger)

        if c.use_latent:
            latent = self.env.auto_model.encoding_size
            make = partial(LatentValueNet, c.num_actions, latent, c.hidden_dim, c.layers)
            # the net's inputs from an observation, and from a replay
            # batch's next observation
            self._obs_keys = ("mask", "latent", "first_latent"), ("mask_n", "latent_n", "first_latent")
            self.adj = None
            latent_size, mesh_verts = latent, None
        else:
            make = partial(GraphValueNet, c.num_actions, c.hidden_dim, c.layers, c.cut)
            self._obs_keys = ("mask", "mesh"), ("mask_n", "mesh_n")
            self.adj = self.env.adj.to(self.device)
            latent_size, mesh_verts = None, self.env.adj_info.num_verts

        self.model = init_modules_(make(), torch.Generator().manual_seed(c.seed)).to(self.device)
        self.target_model = make().to(self.device).requires_grad_(False)
        self.target_model.load_state_dict(self.model.state_dict())
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=c.lr)

        self.replay = ReplayMemory(
            capacity=c.mem_capacity,
            num_actions=c.num_actions,
            batch_size=c.train_batch_size,
            burn_in=c.burn_in,
            mesh_verts=mesh_verts,
            latent_size=latent_size,
            seed=c.seed,
        )
        self.random_sampler = RandomSampler(c.num_actions, c.seed)
        self.epsilon_rng = np.random.default_rng(c.seed)
        self.epsilon = c.epsilon_start
        self.total_steps = 0
        self.episodes = 0
        self.ckpt = CheckpointManager(c.checkpoint_dir)
        self._restore()

    # ------------------------------------------------------------- persist
    def _restore(self) -> None:
        restored = self.ckpt.restore("recent", map_location=self.device)
        if restored is None:
            return
        self.model.load_state_dict(restored["model"])
        self.target_model.load_state_dict(restored["target_model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        meta = self.ckpt.meta() or {}
        self.epsilon = meta.get("epsilon", self.epsilon)
        self.total_steps = meta.get("total_steps", 0)
        self.episodes = meta.get("episodes", 0)
        self.replay.load(self.config.checkpoint_dir)

    def save(self) -> None:
        """The online and target nets, the optimizer and the counters, and
        the replay buffer beside them."""
        with span("ddqn.save"):
            self.ckpt.save(
                {
                    "model": self.model.state_dict(),
                    "target_model": self.target_model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                },
                "recent",
                meta={"epsilon": self.epsilon, "total_steps": self.total_steps,
                      "episodes": self.episodes},
            )
            self.replay.save(self.config.checkpoint_dir)

    # --------------------------------------------------------------- actor
    def _inputs(self, data: dict, next_step: bool = False) -> list[torch.Tensor]:
        """The value net's inputs from an observation or a replay batch."""
        args = [torch.as_tensor(np.asarray(data[k]), dtype=torch.float32, device=self.device)
                for k in self._obs_keys[next_step]]
        return args if self.adj is None else args + [self.adj]

    def q_values(self, obs, penalize: bool = True) -> np.ndarray:
        with torch.no_grad():
            v = self.model(*self._inputs(obs)).cpu().numpy()
        if penalize:
            v[np.asarray(obs["mask"]) > 0] = -1e10
        return v

    def get_action(self, obs, force_random: bool = False) -> np.ndarray:
        if force_random or self.epsilon_rng.random() < self.epsilon:
            return self.random_sampler.get_action(obs["mask"])
        return np.argmax(self.q_values(obs), axis=1)

    # -------------------------------------------------------------- learner
    def update_on(self, batch: dict) -> torch.Tensor:
        """One optimizer step on a replay batch; returns the loss (on the
        device)."""
        with span("ddqn.update_on"):
            c = self.config
            dev = self.device
            rewards = torch.as_tensor(batch["rewards"], device=dev)
            if c.normalization == "first":
                rewards = rewards / torch.as_tensor(batch["first_score"], device=dev)
            elif c.normalization == "current":
                rewards = rewards / torch.as_tensor(batch["score"], device=dev)
            mask = torch.as_tensor(batch["mask"], device=dev)
            mask_n = torch.as_tensor(batch["mask_n"], device=dev)
            actions = torch.as_tensor(batch["actions"], device=dev).long()
            with torch.no_grad():
                next_args = self._inputs(batch, next_step=True)
                # the online net's argmax over the actions not yet performed
                # after this one (the next mask; the reference penalizes with
                # the current one), valued by the target net
                next_online = self.model(*next_args).masked_fill(mask_n > 0, -1e10)
                best_next = next_online.argmax(dim=1, keepdim=True)
                q_next = self.target_model(*next_args).gather(1, best_next)[:, 0]
                not_done = mask.sum(dim=1) < c.budget - 1
                target = c.gamma * torch.where(not_done, q_next, 0.0) + rewards
            q = self.model(*self._inputs(batch)).gather(1, actions[:, None])[:, 0]
            loss = ((q - target) ** 2).mean()
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            torch.nn.utils.clip_grad_value_(self.model.parameters(), 1.0)
            self.optimizer.step()
            return loss.detach()

    def update_parameters(self) -> float | None:
        with span("ddqn.update"):
            batch = self.replay.sample()
            if batch is None:
                return None
            loss = self.update_on(batch)
            with span("ddqn.fetch"):
                return float(loss)

    # ---------------------------------------------------------------- loop
    def train_epoch(self, max_batches: int | None = None) -> dict:
        c = self.config
        losses, rewards = [], []
        for v, batch in enumerate(self.loader("RL_train")):
            if max_batches is not None and v >= max_batches:
                break
            obs = self.env.reset(batch)
            for _ in range(c.budget):
                burn_in = self.total_steps < c.burn_in
                with span("ddqn.act"):
                    actions = self.get_action(obs, force_random=burn_in)
                next_obs, reward, done = self.env.step(actions)
                self.replay.push(actions, obs, next_obs, reward)
                loss = self.update_parameters()
                if loss is not None:
                    losses.append(loss)
                rewards.append(float(np.mean(reward)))
                obs = next_obs
                self.total_steps += 1
                if not burn_in:
                    self.epsilon = max(c.epsilon_end, self.epsilon * c.epsilon_decay)
                if self.total_steps % c.target_update == 0:
                    with span("ddqn.target_sync"):
                        self.target_model.load_state_dict(self.model.state_dict())
            self.episodes += 1
        self.save()
        return {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "reward": float(np.mean(rewards)) if rewards else float("nan"),
            "epsilon": self.epsilon,
        }

    def evaluate(self, split: str = "test", max_batches=None):
        result = run_rollouts(
            self.env,
            self.loader(split),
            lambda obs, step: np.argmax(self.q_values(obs), axis=1),
            self.config.budget,
            max_batches=max_batches,
        )
        self.save_result(result)
        return result
