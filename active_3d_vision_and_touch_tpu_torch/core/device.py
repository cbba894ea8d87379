"""How a host array reaches the device: the device named, and the copy.

Below every layer that makes such a copy (``data/``, ``active/``,
``train/``), and importing none of them.
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


def host_to_device(arr, device: torch.device) -> torch.Tensor:
    """A float32 copy of the numpy ``arr`` on ``device``.  To the card it is
    copied once into pinned memory and sent from there without waiting, so
    the host's next work overlaps the card's."""
    if device.type != "cuda":
        return torch.tensor(arr, dtype=torch.float32)
    staged = torch.empty(np.shape(arr), dtype=torch.float32, pin_memory=True)
    staged.numpy()[...] = arr
    return staged.to(device, non_blocking=True)
