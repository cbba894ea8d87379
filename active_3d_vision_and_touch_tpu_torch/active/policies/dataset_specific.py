"""Dataset-conditioned fixed action sequences: MFBA and LEBA.

Both learn one action per budget step from the training set, then act with
the fixed sequence at evaluation:

- MFBA (Most Frequent Best Action): per step, tally the oracle-best action
  over a fraction of the train set and keep the most frequent
  (reference ``policies/dataset_specific/MFBA.py:76-112``).
- LEBA (Lowest Expected-error Best Action): per step, accumulate the
  normalized score of every remaining action over the train set and keep
  the lowest mean (``policies/dataset_specific/LEBA.py:83-144``).

Scan position + accumulators checkpoint to .npy between batches, like the
reference's preemption-resume (``MFBA.py:100-101,213-220``).
"""

from __future__ import annotations

import os
import random

import numpy as np

from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.rollout import run_rollouts


class _SequenceEngine(PolicyEngine):
    """Shared train-a-fixed-sequence scaffolding."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.chosen_actions: list[int] = []
        self._load_progress()

    # -- per-policy hooks --------------------------------------------------
    def _init_accumulators(self):
        raise NotImplementedError

    def _accumulate(self, batch):
        raise NotImplementedError

    def _select_from_accumulators(self) -> int:
        raise NotImplementedError

    # ----------------------------------------------------------------------
    def _progress_path(self):
        return os.path.join(self.config.checkpoint_dir, "progress.npz")

    def _save_progress(self):
        np.savez(
            self._progress_path(),
            chosen=np.asarray(self.chosen_actions, np.int64),
            **self._acc_state(),
        )

    def _load_progress(self):
        self._init_accumulators()
        path = self._progress_path()
        if os.path.exists(path):
            blob = np.load(path)
            self.chosen_actions = [int(a) for a in blob["chosen"]]
            self._restore_acc(blob)

    def _acc_state(self) -> dict:
        return {}

    def _restore_acc(self, blob) -> None:
        pass

    def train(self, train_fraction: float = 0.4, max_batches: int | None = None):
        """Learn the remaining steps of the action sequence."""
        while len(self.chosen_actions) < self.config.budget:
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
                self.env.reset(batch)
                for action in self.chosen_actions:
                    self.env.step(np.full(self.config.env_batch_size, action))
                self._accumulate(batch)
                self._save_progress()
            self.chosen_actions.append(self._select_from_accumulators())
            self._init_accumulators()
            self._save_progress()
        return self.chosen_actions

    def evaluate(self, split: str = "test", max_batches=None):
        seq = list(self.chosen_actions)
        result = run_rollouts(
            self.env,
            self.loader(split),
            lambda obs, step: np.full(self.config.env_batch_size, seq[step]),
            budget=len(seq),
            max_batches=max_batches,
        )
        self.save_result(result)
        return result


class MFBAEngine(_SequenceEngine):
    name = "mfba"

    def _init_accumulators(self):
        self.counts = np.zeros(self.config.num_actions)
        self.counts[getattr(self, "chosen_actions", [])] = -1e20

    def _acc_state(self):
        return {"counts": self.counts}

    def _restore_acc(self, blob):
        self.counts = blob["counts"]

    def _accumulate(self, batch):
        # selection only — the reference commits the step too but discards
        # the observation (MFBA.py:95-99), paying one reconstruction+CD
        # pass per batch for nothing
        actions = self.env.best_action(greedy_checks=self.config.greedy_checks)
        for a in actions:
            self.counts[a] += 1

    def _select_from_accumulators(self) -> int:
        return int(np.argmax(self.counts))


class LEBAEngine(_SequenceEngine):
    name = "leba"

    def _init_accumulators(self):
        chosen = getattr(self, "chosen_actions", [])
        self.action_scores = np.full(self.config.num_actions, 1e10)
        self.checks = np.ones(self.config.num_actions)
        self.action_scores[chosen] = 1e20

    def _acc_state(self):
        return {"action_scores": self.action_scores, "checks": self.checks}

    def _restore_acc(self, blob):
        self.action_scores = blob["action_scores"]
        self.checks = blob["checks"]

    def _accumulate(self, batch):
        c = self.config
        rng = random.Random(c.seed + len(self.chosen_actions))
        remaining = [i for i in range(c.num_actions) if i not in self.chosen_actions]
        per_elem = [list(remaining) for _ in range(c.env_batch_size)]
        if c.greedy_checks < c.num_actions:
            per_elem = [rng.sample(r, c.greedy_checks) for r in per_elem]
        candidates = np.asarray(per_elem)  # (b, k)
        scores = self.env.score_candidates(candidates)
        first = self.env.current["first_score"]
        norm = scores / first[:, None]
        for e in range(candidates.shape[0]):
            for action, s in zip(candidates[e], norm[e]):
                if self.action_scores[action] >= 1e10:
                    self.action_scores[action] = s
                else:
                    self.action_scores[action] += s
                self.checks[action] += 1.0

    def _select_from_accumulators(self) -> int:
        return int(np.argmin(self.action_scores / self.checks))
