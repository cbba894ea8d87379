"""Process groups, device meshes and batch sharding over ``torch.distributed``.

Port of the JAX package's ``parallel/mesh.py``.  There, one program spans a
mesh of devices and XLA inserts the collectives; here each rank is a
process that drives one device, and the collectives are written out: the
trainers average their gradients with :func:`average_gradients`, report
:func:`global_mean` losses, start from rank 0's weights (:func:`replicate`)
and normalise over the global batch (``models/vision.py::BatchNorm``).

:func:`maybe_init_distributed` joins the process group that ``torchrun``
describes in its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), NCCL on the card and gloo on the CPU,
and is a no-op in a single-process run, so every entry point can call it.
A mesh is a ``DeviceMesh`` over ranks: ``("dp",)`` for data parallelism,
``("dcn", "dp")`` for hosts x devices a host; a batch splits over every
axis of it, host-major.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXIS = "dp"
DCN_AXIS = "dcn"
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_init_distributed(device="cuda") -> bool:
    """Join the process group that torchrun's environment describes (NCCL
    for a CUDA ``device``, which also becomes this rank's ``LOCAL_RANK``
    card; gloo otherwise).  True when a group is up, False in a
    single-process run without torchrun's variables."""
    if dist.is_initialized():
        return True
    if not all(v in os.environ for v in _TORCHRUN_VARS):
        return False
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    dist.init_process_group(
        backend,
        init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
    )
    return True


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for a CUDA ``device``
    under a process group, else ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_parallel_mesh(num_devices: int | None = None):
    """1-D ``("dp",)`` mesh over every rank of the process group."""
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices in a group of {world} ranks: "
                         "each rank drives one device")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), torch.arange(world), mesh_dim_names=(BATCH_AXIS,))


def hybrid_mesh(dcn: int | None = None, ici: int | None = None):
    """2-D ``("dcn", "dp")`` mesh: the outer axis over hosts, the inner
    over each host's devices.  ``dcn`` defaults to the hosts of a torchrun
    job (``WORLD_SIZE / LOCAL_WORLD_SIZE``), ``ici`` to the rest."""
    world = dist.get_world_size()
    if dcn is None:
        dcn = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if ici is None:
        ici = world // dcn
    if dcn * ici != world:
        raise ValueError(f"a {dcn} x {ici} mesh in a group of {world} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), torch.arange(world).reshape(dcn, ici),
                      mesh_dim_names=(DCN_AXIS, BATCH_AXIS))


def batch_sharding(mesh) -> tuple[int, int]:
    """(index, count): this rank's shard of a batch's leading axis, split
    over every mesh axis host-major, as the JAX package's
    ``P(("dcn", "dp"))``.  It is also the ``Loader``'s ``process_shard``."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def shard_batch(batch: dict, mesh) -> dict:
    """The rows of a global ``batch`` that this rank holds: each numpy
    array or tensor leaf cut to its shard of the leading axis; other leaves
    (names, metadata) pass through."""
    index, count = batch_sharding(mesh)

    def local(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        n = x.shape[0]
        if n % count:
            raise ValueError(f"a batch of {n} rows over {count} shards")
        rows = n // count
        return x[index * rows : (index + 1) * rows]

    return {k: local(v) for k, v in batch.items()}


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Every rank of ``group`` (by default the whole process group; every
    mesh here spans it) takes its first rank's parameters and buffers, in
    place; a no-op without a process group."""
    if not dist.is_initialized():
        return module
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def average_gradients(module: torch.nn.Module, group=None) -> None:
    """The mean of every parameter's gradient over the group's ranks, in
    place: one ``all_reduce`` of one flat bucket.  With equal local
    batches and a loss that is a mean over the batch, it is the gradient
    of the global batch."""
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def global_mean(value: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the group's ranks of a per-rank scalar (a loss that is
    a mean over equal local batches), on every rank."""
    value = value.detach().clone()
    dist.all_reduce(value, group=group)
    return value / dist.get_world_size(group)
