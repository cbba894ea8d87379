"""Engine base: the train/validate/checkpoint/early-stop loop shared by the
reconstruction trainers.

Port of the JAX package's ``train/base.py``.  One process drives one
device.  The engine owns its module and optimizer and updates them in
place; each step's randomness comes from a ``torch.Generator`` seeded from
(config seed, step), as the JAX engine folds the step into its key.

Across ranks.  An engine built while a ``torch.distributed`` process group
is up trains data-parallel over its ranks, as the JAX engine does over a
``data_parallel_mesh`` of as many devices: each rank takes an equal share
of the global batch (``Loader(process_shard=(rank, world))``), draws the
*global* batch's sampler noise from the step's generator and keeps its own
rows, so no draw depends on the number of ranks; its BatchNorms normalise
over the global batch (``models/vision.py::sync_batchnorm_``) when there
is more than one rank; the gradients are averaged and the losses reported
as their global mean.  Every rank draws the same weights from the config's
seed and takes rank 0's at ``build`` (after a checkpoint is restored);
rank 0 alone writes the config, the metrics and the checkpoints, with a
barrier before the others read them.

Spans (``utils/profiler.py``, recorded under a profiler): ``recon.to_device``,
``recon.train_step`` over ``recon.optimizer`` (``zero_grad``, then
``step``), ``recon.forward_loss`` and ``recon.backward`` (with the
gradients' exchange across ranks), and ``recon.eval_step``.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch
import torch.distributed as dist

from active_3d_vision_and_touch_tpu_torch.core.config import save_config
from active_3d_vision_and_touch_tpu_torch.models.vision import sync_batchnorm_
from active_3d_vision_and_touch_tpu_torch.parallel import (
    average_gradients,
    global_mean,
    replicate,
)
from active_3d_vision_and_touch_tpu_torch.train.common import (
    CheckpointManager,
    EarlyStop,
    MetricsWriter,
)
from active_3d_vision_and_touch_tpu_torch.utils.profiler import span


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA on a machine
    without it, rather than running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def host_to_device(arr, device: torch.device) -> torch.Tensor:
    """A float32 copy of the numpy ``arr`` on ``device``.  To the card it is
    copied once into pinned memory and sent from there without waiting, so
    the host's next work overlaps the card's."""
    if device.type != "cuda":
        return torch.tensor(arr, dtype=torch.float32)
    staged = torch.empty(np.shape(arr), dtype=torch.float32, pin_memory=True)
    staged.numpy()[...] = arr
    return staged.to(device, non_blocking=True)


class ReconEngine:
    """Subclasses set ``self.model`` and ``self.optimizer`` before calling
    ``super().__init__`` and define ``_loss`` plus ``loss_tag``.  ``_loss``
    hands ``self.shard`` to the sampler, which then draws the global
    batch's noise and keeps this rank's rows."""

    loss_tag = "loss"

    def __init__(self, config, device="cuda", log: bool = True):
        self.config = config
        self.device = resolve_device(device)
        self.epoch = 0
        # the process group this engine trains over, fixed when it is built
        self.group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
        self.rank = dist.get_rank() if self.group is not None else 0
        self.world = dist.get_world_size() if self.group is not None else 1
        self.shard = (self.rank, self.world) if self.group is not None else None
        self.ckpt = CheckpointManager(config.checkpoint_dir)
        self.early_stop = EarlyStop(config.patience)
        self.writer = (
            MetricsWriter(config.tensorboard_dir, config.exp_id)
            if log and self.rank == 0 else None
        )
        if not config.eval and self.rank == 0:
            save_config(config.checkpoint_dir, config)
        if self.world > 1:
            sync_batchnorm_(self.model, self.group)
        self.built = False

    def _loss(self, batch: dict, generator, draws) -> torch.Tensor:
        """The scalar training loss of ``batch`` (provided by subclasses)."""
        raise NotImplementedError

    def train_step(self, batch: dict, generator=None, draws=None) -> torch.Tensor:
        """One optimizer step on ``batch`` (this rank's rows, across ranks);
        returns the loss (on the device; across ranks the global batch's).
        ``draws`` (see :func:`ops.sample.draw_sample_noise`) replaces the
        sampler's draw from ``generator``."""
        with span("recon.train_step"):
            self.model.train()
            with span("recon.optimizer"):
                self.optimizer.zero_grad(set_to_none=True)
            with span("recon.forward_loss"):
                loss = self._loss(batch, generator, draws)
            with span("recon.backward"):
                loss.backward()
                if self.group is not None:
                    average_gradients(self.model, self.group)
                    loss = global_mean(loss, self.group)
            with span("recon.optimizer"):
                self.optimizer.step()
            return loss.detach()

    def eval_step(self, batch: dict, generator=None, draws=None) -> torch.Tensor:
        with span("recon.eval_step"):
            self.model.eval()
            with torch.no_grad():
                loss = self._loss(batch, generator, draws)
                return loss if self.group is None else global_mean(loss, self.group)

    def barrier(self) -> None:
        """Wait for every rank (a no-op without a process group)."""
        if self.group is not None:
            dist.barrier(self.group)

    def step_generator(self, step: int) -> torch.Generator:
        """The generator of step ``step``: a seed derived from (seed, step)."""
        seed = int(np.random.SeedSequence([self.config.seed, step]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])

    def to_device(self, batch: dict) -> dict:
        """Host or device arrays → float32 tensors on the engine's device;
        metadata (``names``) stays behind."""
        with span("recon.to_device"):
            return {
                k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                for k, v in batch.items()
                if k != "names"
            }

    def build(self) -> None:
        """Resume from the ``recent`` checkpoint if there is one."""
        self.barrier()
        restored = self.ckpt.restore("recent", map_location=self.device)
        if restored is not None:
            self.load_state_dict(restored)
            meta = self.ckpt.meta() or {}
            self.epoch = int(meta.get("epoch", 0))
            if "early_stop" in meta:
                self.early_stop.restore(meta["early_stop"])
        if self.group is not None:
            replicate(self.model, self.group)
        self.built = True

    def _steps(self, loader) -> int | None:
        """Across ranks, the least of the ranks' batch counts, so that every
        rank runs the same steps and each step's collectives meet (ranks'
        shares of a dataset that does not split evenly may differ by a
        batch); ``None`` (every batch) without a process group."""
        if self.group is None:
            return None
        count = torch.tensor([len(loader)], device=self.device)
        dist.all_reduce(count, op=dist.ReduceOp.MIN, group=self.group)
        return int(count)

    def run_epoch(self, loader, train: bool = True) -> float:
        losses = []
        step_base = self.epoch * 100_000
        for i, batch in enumerate(itertools.islice(loader, self._steps(loader))):
            batch = self.to_device(batch)
            gen = self.step_generator(step_base + i)
            step = self.train_step if train else self.eval_step
            # keep the loss on the device: fetching it here would wait for
            # the step every time
            losses.append(step(batch, gen))
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())

    def fit(self, train_loader_fn, valid_loader_fn, epochs: int | None = None):
        """Full training run; loaders are zero-arg callables returning fresh
        batch iterables each epoch.  Returns the best validation loss."""
        if not self.built:
            self.build()
        epochs = epochs if epochs is not None else self.config.epochs
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            t0 = time.time()
            train_loss = self.run_epoch(train_loader_fn(), train=True)
            valid_loss = self.run_epoch(valid_loader_fn(), train=False)
            if self.writer:
                self.writer.scalar(f"train_{self.loss_tag}", train_loss, epoch)
                self.writer.scalar(f"valid_{self.loss_tag}", valid_loss, epoch)
                self.writer.scalar("epoch_seconds", time.time() - t0, epoch)
            # every rank has the same losses, so the same early stop
            improved = self.early_stop.update(valid_loss)
            if self.rank == 0:
                meta = {"epoch": epoch + 1, "early_stop": self.early_stop.state()}
                self.ckpt.save(self.state_dict(), "recent", meta=meta)
                if improved:
                    self.ckpt.save(self.state_dict(), "best")
            self.barrier()
            if self.early_stop.should_stop:
                break
        return self.early_stop.best

    def evaluate(self, loader) -> float:
        if not self.built:
            self.build()
        self.barrier()
        restored = self.ckpt.restore("best", map_location=self.device)
        if restored is not None:
            self.load_state_dict(restored)
        return self.run_epoch(loader, train=False)
