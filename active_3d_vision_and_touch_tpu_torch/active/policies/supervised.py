"""Supervised value-regression policy.

Port of the JAX package's ``active/policies/supervised.py``.  One value
net per budget step, trained in turn: roll to the step with the nets
already trained (the selection rule over their values, actions already
taken pinned out), then regress the values of random probe actions onto the
score improvements the env measures for them (reference
``policies/supervised/train.py:103-210``).  Needs the latent observation.
"""

from __future__ import annotations

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.active.policies.base import PolicyEngine
from active_3d_vision_and_touch_tpu_torch.active.policies.rollout import run_rollouts
from active_3d_vision_and_touch_tpu_torch.models.policy_nets import LatentValueNet
from active_3d_vision_and_touch_tpu_torch.models.vision import init_modules_
from active_3d_vision_and_touch_tpu_torch.train.common import CheckpointManager


class SupervisedEngine(PolicyEngine):
    name = "supervised"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        c = self.config
        if not c.use_latent:
            raise ValueError("the supervised policy needs latent observations (use_latent)")
        if c.normalize:
            squash = "normalize"
        elif c.use_img:
            squash = "img"
        else:
            squash = "wide"
        latent = self._latent_size()
        self.nets = []
        for step in range(c.budget):
            # each step's weights from a generator of its own, seeded from
            # (seed, step)
            seed = int(np.random.SeedSequence([c.seed, step]).generate_state(1)[0])
            net = LatentValueNet(c.num_actions, latent, c.hidden_dim, c.layers, squash)
            self.nets.append(init_modules_(net, torch.Generator().manual_seed(seed)).to(self.device))
        self.optimizers = [torch.optim.Adam(net.parameters(), lr=c.lr) for net in self.nets]
        self.ckpt = CheckpointManager(c.checkpoint_dir)
        restored = self.ckpt.restore("recent", map_location=self.device)
        if restored is not None:
            for net, state in zip(self.nets, restored["nets"]):
                net.load_state_dict(state)

    def _latent_size(self) -> int:
        if self.env.auto_model is not None:
            return self.env.auto_model.encoding_size
        return 200

    def _tensors(self, obs, *keys) -> list[torch.Tensor]:
        return [torch.as_tensor(np.asarray(obs[k]), dtype=torch.float32, device=self.device)
                for k in keys]

    def save(self) -> None:
        self.ckpt.save({"nets": [net.state_dict() for net in self.nets]}, "recent")

    def _values(self, step: int, obs, prev_actions: list[np.ndarray]) -> np.ndarray:
        """(b, num_actions) values of step ``step``'s net, the actions of
        ``prev_actions`` pinned to the worst value of the selection rule."""
        with torch.no_grad():
            v = self.nets[step](*self._tensors(obs, "mask", "latent", "first_latent"))
        v = v.cpu().numpy()
        pin = 1e10 if self.config.supervised_select == "argmin" else -1e10
        for acts in prev_actions:
            for e, a in enumerate(acts):
                v[e, int(a)] = pin  # never repeat an action
        return v

    def _select(self, step: int, obs, prev_actions: list[np.ndarray]) -> np.ndarray:
        """One action per env from the step's value net: "argmin", the
        reference's rule, by default; "argmax" is the sign-consistent one
        (see ``PolicyConfig``)."""
        v = self._values(step, obs, prev_actions)
        if self.config.supervised_select == "argmax":
            return np.argmax(v, axis=1)
        return np.argmin(v, axis=1)

    def _loss(self, step: int, obs, probe: np.ndarray, targets: np.ndarray) -> torch.Tensor:
        values = self.nets[step](*self._tensors(obs, "mask", "latent", "first_latent"))
        picked = values.gather(1, torch.as_tensor(probe, device=self.device).long())
        target = torch.as_tensor(targets, device=self.device)
        return ((target - picked) ** 2).mean()

    def train_step_level(self, step: int, max_batches: int | None = None,
                         probes: int | None = None) -> float:
        """One pass of step ``step``'s net over the train split: one update
        per env batch; returns the mean loss."""
        c = self.config
        probes = probes or c.training_actions
        rng = np.random.default_rng(c.seed + step)
        optimizer = self.optimizers[step]
        losses = []
        for v, batch in enumerate(self.loader("RL_train")):
            if max_batches is not None and v >= max_batches:
                break
            try:
                obs = self.env.reset(batch)
            except Exception as e:  # noqa: BLE001 - poison-object guard
                # one degenerate object must not abort a training sweep
                # (reference supervised/train.py:112-114 does the same)
                print(f"skipping batch {v} ({batch.get('names')}): {e}")
                continue
            prev_actions: list[np.ndarray] = []
            for i in range(step):
                acts = self._select(i, obs, prev_actions)
                obs, _, _ = self.env.step(acts)
                prev_actions.append(acts)

            probe = rng.integers(c.num_actions, size=(c.env_batch_size, probes))
            scores = self.env.score_candidates(probe)
            first = obs["first_score"][:, None]
            if c.normalize:
                targets = ((first - scores) / first).astype(np.float32)
            else:
                targets = (first - scores).astype(np.float32)

            optimizer.zero_grad(set_to_none=True)
            loss = self._loss(step, obs, probe, targets)
            loss.backward()
            optimizer.step()
            losses.append(float(loss.detach()))
        self.save()
        return float(np.mean(losses)) if losses else float("nan")

    def _validate_step(self, step: int, max_batches: int = 4) -> float:
        """Mean share of the first score left after rolling steps 0..step on
        the valid split, the reference's per-step model-selection metric
        (``supervised/train.py:216-258``)."""
        ratios = []
        for v, batch in enumerate(self.loader("valid")):
            if v >= max_batches:
                break
            try:
                obs = self.env.reset(batch)
            except Exception as e:  # noqa: BLE001 - poison-object guard
                print(f"skipping valid batch {v}: {e}")
                continue
            first = obs["score"].copy()
            prev: list[np.ndarray] = []
            for i in range(step + 1):
                acts = self._select(i, obs, prev)
                obs, _, _ = self.env.step(acts)
                prev.append(acts)
            ratios.append(float(np.mean(obs["score"] / first)))
        return float(np.mean(ratios)) if ratios else float("inf")

    def train(self, max_batches_per_step: int | None = None, epochs: int | None = None,
              patience: int = 2) -> None:
        """Each step's net in turn, up to ``epochs`` passes (default
        ``config.supervised_epochs``), keeping the weights of the pass that
        validates best; ``epochs`` 1 skips the validation (reference
        ``supervised/train.py:63-79``: up to 3000 epochs, patience 25)."""
        epochs = epochs if epochs is not None else self.config.supervised_epochs
        for step in range(self.config.budget):
            if epochs <= 1:
                self.train_step_level(step, max_batches=max_batches_per_step)
                continue
            net = self.nets[step]
            # a copy: the optimizer updates the live tensors in place
            best, best_state, since = float("inf"), _copy_state(net), 0
            for epoch in range(epochs):
                loss = self.train_step_level(step, max_batches=max_batches_per_step)
                score = self._validate_step(step)
                print(f"supervised step {step} epoch {epoch}: "
                      f"loss {loss:.4f} valid %CD {score:.4f}", flush=True)
                if score < best:
                    best, best_state, since = score, _copy_state(net), 0
                else:
                    since += 1
                    if since >= patience:
                        break
            net.load_state_dict(best_state)
            self.save()

    def evaluate(self, split: str = "test", max_batches=None):
        prev: list[np.ndarray] = []

        def select(obs, step):
            acts = self._select(step, obs, prev)
            prev.append(acts)
            return acts

        result = run_rollouts(
            self.env,
            self.loader(split),
            select,
            self.config.budget,
            on_episode_start=prev.clear,
            max_batches=max_batches,
        )
        self.save_result(result)
        return result


def _copy_state(net: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in net.state_dict().items()}
