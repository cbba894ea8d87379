"""The three non-learned policies: random, even, greedy oracle
(reference ``policies/baselines/{rand,even,greedy}.py``)."""

from __future__ import annotations

import numpy as np

from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.baselines import (
    EvenSampler,
    RandomSampler,
)
from active_3d_vision_and_touch_tpu_torch.active.policies.rollout import (
    RolloutResult,
    run_rollouts,
)


class RandomEngine(PolicyEngine):
    name = "random"

    def evaluate(self, split: str = "test", max_batches=None) -> RolloutResult:
        sampler = RandomSampler(self.config.num_actions, self.config.seed)
        result = run_rollouts(
            self.env,
            self.loader(split),
            lambda obs, step: sampler.get_action(obs["mask"]),
            self.config.budget,
            max_batches=max_batches,
        )
        self.save_result(result)
        return result


class EvenEngine(PolicyEngine):
    name = "even"

    def evaluate(self, split: str = "test", max_batches=None) -> RolloutResult:
        sampler = EvenSampler(
            self.config.num_actions,
            self.config.num_grasps,
            self.config.env_batch_size,
            self.config.seed,
        )
        result = run_rollouts(
            self.env,
            self.loader(split),
            lambda obs, step: sampler.get_action(obs["mask"]),
            self.config.budget,
            on_episode_start=sampler.reset,
            max_batches=max_batches,
        )
        self.save_result(result)
        return result


class GreedyEngine(PolicyEngine):
    """Myopic oracle: exhaustive (or sampled ``greedy_checks``) lookahead
    each step via the env's batched candidate scoring."""

    name = "greedy"

    def evaluate(self, split: str = "test", max_batches=None) -> RolloutResult:
        env, budget = self.env, self.config.budget
        checks = self.config.greedy_checks
        all_scores, all_actions, names = [], [], []
        for v, batch in enumerate(self.loader(split)):
            if max_batches is not None and v >= max_batches:
                break
            obs = env.reset(batch)
            names += list(batch["names"])
            scores = [obs["score"]]
            actions = []
            for _ in range(budget):
                acts, obs, reward, done = env.best_step(greedy_checks=checks)
                scores.append(obs["score"])
                actions.append(acts)
            all_scores.append(np.stack(scores, axis=1))
            all_actions.append(np.stack(actions, axis=1))
        result = RolloutResult(
            scores=np.concatenate(all_scores, axis=0),
            actions=np.concatenate(all_actions, axis=0),
            names=names,
        )
        self.save_result(result)
        return result
