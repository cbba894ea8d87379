"""Action samplers for the baseline policies
(reference ``policies/baselines/baselines.py:10-57``)."""

from __future__ import annotations

import numpy as np


class RandomSampler:
    """Uniform over not-yet-performed actions."""

    def __init__(self, num_actions: int, seed: int = 0):
        self.num_actions = num_actions
        self.rng = np.random.default_rng(seed)

    def get_action(self, mask: np.ndarray) -> np.ndarray:
        actions = []
        for row in np.asarray(mask):
            options = np.nonzero(row == 0)[0]
            actions.append(self.rng.choice(options))
        return np.asarray(actions)


class EvenSampler:
    """Rotationally offset evenly spaced action ids, precomputed per
    episode."""

    def __init__(self, num_actions: int, num_grasps: int, batch_size: int, seed: int = 0):
        self.num_actions = num_actions
        self.num_grasps = num_grasps
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.reset()

    def reset(self) -> None:
        spacing = self.num_actions // self.num_grasps
        self.plans = []
        for _ in range(self.batch_size):
            offset = int(self.rng.integers(self.num_actions))
            self.plans.append(
                [(spacing * j + offset) % self.num_actions for j in range(self.num_grasps)]
            )

    def get_action(self, mask: np.ndarray) -> np.ndarray:
        return np.asarray([plan.pop(0) for plan in self.plans])
