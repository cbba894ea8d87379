"""How a host array reaches the device: the device named, and the copy.

Below every layer that makes such a copy (``data/``, ``active/``,
``train/``), and importing none of them.

A host array bound for the card is staged first (:func:`stage`): written
once, as float32, into page-locked memory, from which the card copies it
without the host waiting.  :func:`host_to_device` sends it on the current
stream, as the env and the dataset generation do.  The trainers'
``ReconEngine.to_device`` sends a batch's arrays from the same staging on
a copy stream of its own, which the consuming stream waits on by an event,
and holds at most two such batches in flight (``train/base.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA on a machine
    without it, rather than running somewhere else."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def on_host(value) -> bool:
    """Whether ``value`` (numpy, a list, a tensor) lives in host memory."""
    return not (isinstance(value, torch.Tensor) and value.device.type != "cpu")


def stage(arr) -> torch.Tensor:
    """A float32 copy of the host array ``arr`` (numpy, or a CPU tensor) in
    page-locked memory, from which a copy to the card need not wait.  The
    pinned blocks come from torch's caching host allocator, which hands a
    block out again only once the copies that read it have run."""
    if isinstance(arr, torch.Tensor):
        staged = torch.empty(arr.shape, dtype=torch.float32, pin_memory=True)
        staged.copy_(arr.detach())
    else:
        staged = torch.empty(np.shape(arr), dtype=torch.float32, pin_memory=True)
        staged.numpy()[...] = arr
    return staged


def host_to_device(arr, device: torch.device) -> torch.Tensor:
    """A float32 copy of the numpy ``arr`` on ``device``.  To the card it is
    staged once into pinned memory and sent from there on the current
    stream without waiting, so the host's next work overlaps the card's."""
    if device.type != "cuda":
        return torch.tensor(arr, dtype=torch.float32)
    return stage(arr).to(device, non_blocking=True)
