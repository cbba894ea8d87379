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

One CUDA graph a step.  On a CUDA device with no process group,
``train_step`` captures the whole optimizer step (forward and loss,
backward, Adam's step) in a ``torch.cuda.CUDAGraph`` and replays it, so the
host queues one replay a step instead of several hundred launches.  The
rule is :func:`graph_key`: a step replays the graph captured for steps of
its key (the batch's keys, shapes and dtypes and the sampler's draws'
shapes).  The first ``WARMUP_STEPS`` steps of a key run eagerly on a side
stream, as whole-network capture requires (cuDNN and cuBLAS settle their
workspaces there); the next is captured, then replayed, so it trains too.
The first warm-up step runs in torch's sync debug mode: a step that
synchronises the host with the card (a copy from pageable host memory,
which a capture refuses) is never captured and runs eagerly.  A step of
another key, ``load_state_dict`` and a restoring ``build`` drop the graph.
The sampler's draws are the graph's inputs, copied in with the batch: drawn
from the step's generator where none are given, as the sampler draws them,
so a replayed step uses the numbers of the eager step it replaces.  Adam
turns ``capturable`` at the capture, which moves its step counts onto the
card (:func:`capturable_`), and back at ``load_state_dict``: a step that
no graph holds runs the plain Adam.  The CPU and the ranks run every step
eagerly.

The batch copy.  :meth:`ReconEngine.to_device` sends a batch to the card
ahead of the step that reads it.  Each host array (numpy, or a CPU tensor)
is staged once, as float32, into pinned memory (``core/device.py::stage``)
and copied from there without waiting on the engine's copy stream, created
at the first such batch; the current stream waits on the copies by an
event, so the copy of batch n runs on the card's copy engine while step
n-1 computes, and step n still reads batch n whole.  Each call returns new
tensors, the caller's to keep: they are allocated under the copy stream
and recorded on the consuming one, so the caching allocator hands their
blocks out again only after the consumer's work on them.  At most
``IN_FLIGHT`` batches are in flight: before staging another, the host
waits on an event recorded on the consuming stream at the previous call,
which marks the end of the step that read the batch before it.  The route
follows what the call observes: a CUDA engine stages the values that live
on the host; a CUDA tensor is taken as it is on the current stream, and a
CPU engine takes every value as it is, as before.

Spans (``utils/profiler.py``, recorded under a profiler): ``recon.to_device``
(the staging and the copies' queueing, not the in-flight wait),
``recon.train_step`` over ``recon.optimizer`` (``zero_grad``, then
``step``), ``recon.forward_loss`` and ``recon.backward`` (with the
gradients' exchange across ranks) in an eager step, ``recon.replay`` in a
replayed one, and ``recon.eval_step``.  Counters: ``recon.eager_steps``,
``recon.graph_captures`` and ``recon.graph_replays``, one of them a train
step; ``recon.staged_batches``, one a batch that took the staged route, and
``recon.staging_waits``, one each time the host blocked on the in-flight
bound (near the staged batches when the card sets the pace, near 0 when
the host does).  A replay adds the counters its capture counted
(``profiler.recount``); ``CudaKernel.launches`` counts the capture's
launches once, as the first replay runs them, and no later replay's (a
device trace counts those).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from active_3d_vision_and_touch_tpu_torch.core.config import save_config
from active_3d_vision_and_touch_tpu_torch.core.device import host_to_device, on_host, resolve_device
from active_3d_vision_and_touch_tpu_torch.models.vision import sync_batchnorm_
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import REPEAT
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise
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
from active_3d_vision_and_touch_tpu_torch.utils.profiler import count, counted, recount, span

WARMUP_STEPS = 2  # eager steps of a key before its step is captured
IN_FLIGHT = 2  # staged batches whose steps may be unfinished: the one running, the one staged


def capturable_(optimizer: torch.optim.Optimizer, on: bool) -> None:
    """Turn Adam's ``capturable`` on (a CUDA graph can then hold its step:
    step counts and bias corrections on the card) or off (the plain Adam,
    step counts on the host), moving the step counts it has."""
    for group in optimizer.param_groups:
        group["capturable"] = on
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(p.device if on else "cpu")


def graph_key(device: torch.device, group, batch: dict, draws) -> tuple | None:
    """The rule by which a train step runs from a CUDA graph: on a CUDA
    device with no process group, the key of the step, which is the batch's
    keys, shapes and dtypes and the shapes of the sampler's ``draws``; a
    step replays the graph captured for steps of its key.  ``None``
    anywhere else (the CPU, across ranks): the step runs eagerly."""
    if device.type != "cuda" or group is not None:
        return None
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()),
            tuple(tuple(d.shape) for d in draws))


@contextlib.contextmanager
def host_syncs():
    """Yields a list that holds, at the block's end, the warnings of the
    block's operations that synchronised the host with the card (torch's
    sync debug mode: a copy from pageable memory, a read of a value).  The
    block's other warnings are issued again."""
    found: list = []
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    for w in caught:
        if "synchronizing CUDA operation" in str(w.message):
            found.append(w)
        elif "Synchronization debug mode" not in str(w.message):  # the mode's own notice
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


class _StepGraph:
    """The steps of one key: the warm-up steps run, whether the step can be
    captured, and once it is, the graph with its static inputs, its loss
    and what its capture counted."""

    def __init__(self, key: tuple):
        self.key = key
        self.warm = 0
        self.capturable = True
        self.graph = None
        self.batch = self.draws = self.loss = self.counts = None


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
        self._graph: _StepGraph | None = None
        self._stream = None  # the warm-up steps' side stream
        self._copy_stream = None  # the staged batches' copies
        self._consumed = collections.deque()  # events: the steps queued by each staged call

    def _loss(self, batch: dict, generator, draws) -> torch.Tensor:
        """The scalar training loss of ``batch`` (provided by subclasses)."""
        raise NotImplementedError

    def sample_points(self) -> int:
        """Points the loss samples from each mesh in one of its repeats."""
        return self.config.number_points

    def train_step(self, batch: dict, generator=None, draws=None) -> torch.Tensor:
        """One optimizer step on ``batch`` (this rank's rows, across ranks);
        returns the loss (on the device; across ranks the global batch's;
        a copy of a replayed graph's).  ``draws`` (see
        :func:`ops.sample.draw_sample_noise`) replaces the sampler's draw
        from ``generator``."""
        with span("recon.train_step"):
            self.model.train()
            if draws is None and self.device.type == "cuda" and self.group is None:
                # a graph's inputs, drawn as the sampler would draw them
                # (every batch array leads with its rows)
                rows = next(iter(batch.values())).shape[0]
                draws = draw_sample_noise(rows, REPEAT * self.sample_points(), generator, self.device)
            key = graph_key(self.device, self.group, batch, draws)
            if key is None:
                count("recon.eager_steps")
                return self._eager_step(batch, generator, draws)
            if self._graph is None or self._graph.key != key:
                self._graph = _StepGraph(key)  # another key: the old graph goes
            graph = self._graph
            if not graph.capturable:
                count("recon.eager_steps")
                return self._eager_step(batch, None, draws)
            if graph.warm < WARMUP_STEPS:
                count("recon.eager_steps")
                graph.warm += 1
                return self._warm_up(graph, batch, draws)
            if graph.graph is None:
                self._capture(graph, batch, draws)
                count("recon.graph_captures")
            else:
                count("recon.graph_replays")
            with span("recon.replay"):
                for k, v in batch.items():
                    graph.batch[k].copy_(v)
                for static, d in zip(graph.draws, draws):
                    static.copy_(d)
                graph.graph.replay()
                recount(graph.counts)
                return graph.loss.clone()

    def _eager_step(self, batch: dict, generator, draws) -> torch.Tensor:
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

    def _warm_up(self, graph: _StepGraph, batch: dict, draws) -> torch.Tensor:
        """An eager step on the side stream; the key's first marks the key
        uncapturable if it synchronised the host with the card."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            if graph.warm == 1:
                with host_syncs() as syncs:
                    loss = self._eager_step(batch, None, draws)
                graph.capturable = not syncs
            else:
                loss = self._eager_step(batch, None, draws)
        current.wait_stream(self._stream)
        return loss

    def _capture(self, graph: _StepGraph, batch: dict, draws) -> None:
        """Capture the step on static copies of ``batch`` and ``draws``, with
        Adam made capturable.  A capture runs nothing, so its counters are
        taken back, and each replay adds them (the first replay runs this
        step)."""
        graph.batch = {k: v.clone() for k, v in batch.items()}
        graph.draws = tuple(d.clone() for d in draws)
        graph.graph = torch.cuda.CUDAGraph()
        capturable_(self.optimizer, True)
        # the backward writes the gradients afresh in the graph's own memory
        self.optimizer.zero_grad(set_to_none=True)
        with counted() as graph.counts:
            with torch.cuda.graph(graph.graph):
                loss = self._loss(graph.batch, None, graph.draws)
                loss.backward()
                self.optimizer.step()
        graph.loss = loss.detach()
        recount(graph.counts, -1)

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
        """Load ``state``; a captured graph is dropped, so no replay runs
        over the optimizer state it replaces, and Adam is the plain one
        until the next capture."""
        self._graph = None
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        capturable_(self.optimizer, False)

    def to_device(self, batch: dict) -> dict:
        """Host or device arrays → new float32 tensors on the engine's
        device, the caller's to keep; metadata (``names``) stays behind.
        To the card, the host arrays take the staged route (the module's
        docstring): on a copy stream, at most ``IN_FLIGHT`` batches ahead."""
        arrays = {k: v for k, v in batch.items() if k != "names"}
        staged = self.device.type == "cuda" and any(map(on_host, arrays.values()))
        if staged:
            current = torch.cuda.current_stream(self.device)
            self._bound_in_flight(current)
        with span("recon.to_device"):
            if staged:
                count("recon.staged_batches")
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._copy_stream):
                    for k, v in arrays.items():
                        if on_host(v):
                            arrays[k] = host_to_device(v, self.device)
                            arrays[k].record_stream(current)
                current.wait_stream(self._copy_stream)
            return {k: torch.as_tensor(v, dtype=torch.float32, device=self.device) for k, v in arrays.items()}

    def _bound_in_flight(self, current) -> None:
        """Mark on ``current`` the end of the work queued so far (the step
        of the last staged batch); once ``IN_FLIGHT`` such marks wait,
        block the host on the oldest, which ends the step of the batch
        before the last, and count the block in ``recon.staging_waits``."""
        consumed = torch.cuda.Event()
        consumed.record(current)
        self._consumed.append(consumed)
        if len(self._consumed) >= IN_FLIGHT:
            oldest = self._consumed.popleft()
            if not oldest.query():
                count("recon.staging_waits")
                oldest.synchronize()

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
