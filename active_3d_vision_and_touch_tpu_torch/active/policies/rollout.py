"""Shared rollout evaluation for every policy engine.

The reference repeats an identical ``validate`` loop in all eight policy
engines (e.g. ``baselines/even.py:47-110``); here it exists once.  The
headline metric is the table metric of BASELINE.md: % of the initial
Chamfer distance remaining after the grasp budget (final/first x 100,
lower is better).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class RolloutResult:
    scores: np.ndarray  # (N, budget+1) score after each step
    actions: np.ndarray  # (N, budget)
    names: list = field(default_factory=list)

    @property
    def pct_cd_remaining(self) -> float:
        return float((self.scores[:, -1] / self.scores[:, 0]).mean() * 100.0)

    @property
    def mean_reward(self) -> float:
        return float(
            ((self.scores[:, 0] - self.scores[:, -1]) / self.scores[:, 0]).mean()
        )

    def summary(self) -> dict:
        return {
            "pct_cd_remaining": self.pct_cd_remaining,
            "mean_reward": self.mean_reward,
            "episodes": int(self.scores.shape[0]),
        }


def run_rollouts(
    env,
    loader,
    select_action,
    budget: int,
    on_episode_start=None,
    max_batches: int | None = None,
) -> RolloutResult:
    """Evaluate ``select_action(obs, step) -> actions`` over a loader of
    env batches."""
    all_scores, all_actions, names = [], [], []
    for v, batch in enumerate(loader):
        if max_batches is not None and v >= max_batches:
            break
        obs = env.reset(batch)
        if on_episode_start is not None:
            on_episode_start()
        names += list(batch["names"])
        scores = [obs["score"]]
        actions = []
        for step in range(budget):
            acts = np.asarray(select_action(obs, step))
            obs, reward, done = env.step(acts)
            scores.append(obs["score"])
            actions.append(acts)
        all_scores.append(np.stack(scores, axis=1))
        all_actions.append(np.stack(actions, axis=1))
    if not all_scores:
        raise ValueError(
            "rollout loader yielded no batches — the split has fewer "
            "objects than env_batch_size (ActiveDataset truncates to a "
            "multiple of it, reference data_loaders.py:285-288)"
        )
    return RolloutResult(
        scores=np.concatenate(all_scores, axis=0),
        actions=np.concatenate(all_actions, axis=0),
        names=names,
    )
