"""Fixed-capacity transition replay of the DDQN policy.

The port's own copy of the JAX package's ``active/replay.py``: a numpy ring
buffer with the reference's fields (``policies/replay.py:16-144``): masks
before and after, action, reward, scores, and the mesh (verts | mask code)
or latent observations where asked for; an atomic save and load into
``replay_buffer.npz``.  Sizes derive from the chart atlas.  Spans
(``utils/profiler.py``, recorded under a profiler): ``replay.push``,
``replay.sample``.
"""

from __future__ import annotations

import os

import numpy as np

from active_3d_vision_and_touch_tpu_torch.utils.profiler import span


class ReplayMemory:
    def __init__(
        self,
        capacity: int,
        num_actions: int,
        batch_size: int,
        burn_in: int = 20,
        mesh_verts: int | None = None,
        latent_size: int | None = None,
        seed: int = 0,
    ):
        self.capacity = capacity
        self.batch_size = batch_size
        self.burn_in = burn_in
        self.rng = np.random.default_rng(seed)
        self.data = {
            "mask": np.zeros((capacity, num_actions), np.float32),
            "mask_n": np.zeros((capacity, num_actions), np.float32),
            "actions": np.zeros(capacity, np.int64),
            "rewards": np.zeros(capacity, np.float32),
            "score": np.zeros(capacity, np.float32),
            "score_n": np.zeros(capacity, np.float32),
            "first_score": np.zeros(capacity, np.float32),
        }
        if mesh_verts is not None:
            self.data["mesh"] = np.zeros((capacity, mesh_verts, 4), np.float32)
            self.data["mesh_n"] = np.zeros((capacity, mesh_verts, 4), np.float32)
        if latent_size is not None:
            self.data["latent"] = np.zeros((capacity, latent_size), np.float32)
            self.data["latent_n"] = np.zeros((capacity, latent_size), np.float32)
            self.data["first_latent"] = np.zeros((capacity, latent_size), np.float32)
        self.position = 0
        self.count_seen = 0

    def push(self, actions, obs: dict, next_obs: dict, rewards) -> None:
        """One transition per element of the env batch."""
        with span("replay.push"):
            for i in range(len(actions)):
                p = self.position
                self.data["actions"][p] = actions[i]
                self.data["rewards"][p] = rewards[i]
                self.data["score"][p] = obs["score"][i]
                self.data["score_n"][p] = next_obs["score"][i]
                self.data["first_score"][p] = obs["first_score"][i]
                self.data["mask"][p] = obs["mask"][i]
                self.data["mask_n"][p] = next_obs["mask"][i]
                if "mesh" in self.data:
                    self.data["mesh"][p] = obs["mesh"][i]
                    self.data["mesh_n"][p] = next_obs["mesh"][i]
                if "latent" in self.data:
                    self.data["latent"][p] = obs["latent"][i]
                    self.data["latent_n"][p] = next_obs["latent"][i]
                    self.data["first_latent"][p] = obs["first_latent"][i]
                self.count_seen += 1
                self.position = (self.position + 1) % self.capacity

    def sample(self) -> dict | None:
        """A batch of distinct transitions (with repetition only where the
        buffer holds fewer than a batch), or None before
        ``max(burn_in, batch_size)`` transitions were seen."""
        if self.count_seen < max(self.burn_in, self.batch_size):
            return None
        with span("replay.sample"):
            n = min(self.count_seen, self.capacity)
            idx = self.rng.choice(n, self.batch_size, replace=n < self.batch_size)
            return {k: v[idx] for k, v in self.data.items()}

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, "replay_buffer.tmp.npz")
        np.savez(tmp, position=self.position, count_seen=self.count_seen, **self.data)
        os.replace(tmp, os.path.join(directory, "replay_buffer.npz"))

    def load(self, directory: str) -> bool:
        path = os.path.join(directory, "replay_buffer.npz")
        if not os.path.exists(path):
            return False
        with np.load(path) as blob:
            self.position = int(blob["position"])
            self.count_seen = int(blob["count_seen"])
            for k in self.data:
                self.data[k] = blob[k]
        return True
