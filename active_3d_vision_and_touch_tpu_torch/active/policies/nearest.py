"""Nearest-neighbor latent policy.

Training records (latent, oracle-best-action) pairs over a fraction of the
train set; at evaluation each element acts with the action of the nearest
stored latent that hasn't been used yet this episode (reference
``policies/NearestNeighbor/train.py:73-140``).  Requires use_latent.
"""

from __future__ import annotations

import os
import random

import numpy as np

from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.rollout import run_rollouts


class NearestNeighborEngine(PolicyEngine):
    name = "nearest_neighbor"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if not self.config.use_latent:
            raise ValueError("the nearest-neighbour policy needs latent observations (use_latent)")
        self.latents: list[np.ndarray] = []
        self.actions: list[int] = []
        self._load_bank()

    def _bank_path(self):
        return os.path.join(self.config.checkpoint_dir, "bank.npz")

    def _save_bank(self):
        np.savez(
            self._bank_path(),
            latents=np.stack(self.latents) if self.latents else np.zeros((0, 1)),
            actions=np.asarray(self.actions, np.int64),
        )

    def _load_bank(self):
        if os.path.exists(self._bank_path()):
            blob = np.load(self._bank_path())
            self.latents = list(blob["latents"])
            self.actions = [int(a) for a in blob["actions"]]

    def train(self, train_fraction: float = 0.4, max_batches: int | None = None):
        loader = self.loader("RL_train")
        n = len(loader)
        rng = random.Random(self.config.seed)
        picked = set(rng.sample(range(n), max(1, int(n * train_fraction))))
        seen = 0
        for v, batch in enumerate(loader):
            if v not in picked:
                continue
            if max_batches is not None and seen >= max_batches:
                break
            seen += 1
            obs = self.env.reset(batch)
            for _ in range(self.config.budget):
                actions, next_obs, _, _ = self.env.best_step(
                    greedy_checks=self.config.greedy_checks
                )
                for i in range(self.config.env_batch_size):
                    self.latents.append(np.asarray(obs["latent"][i]))
                    self.actions.append(int(actions[i]))
                obs = next_obs
            self._save_bank()
        return len(self.actions)

    def evaluate(self, split: str = "test", max_batches=None):
        bank = np.stack(self.latents)  # (N, latent)
        bank_actions = np.asarray(self.actions)
        used: list[list[int]] = []

        def reset_used():
            used.clear()
            used.extend([[] for _ in range(self.config.env_batch_size)])

        def select(obs, step):
            acts = []
            for i in range(self.config.env_batch_size):
                d = ((bank - obs["latent"][i]) ** 2).mean(axis=1)
                for idx in np.argsort(d):
                    a = int(bank_actions[idx])
                    if a not in used[i]:
                        acts.append(a)
                        used[i].append(a)
                        break
            return np.asarray(acts)

        result = run_rollouts(
            self.env,
            self.loader(split),
            select,
            self.config.budget,
            on_episode_start=reset_used,
            max_batches=max_batches,
        )
        self.save_result(result)
        return result
