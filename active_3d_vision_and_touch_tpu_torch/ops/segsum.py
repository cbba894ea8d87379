"""Sorted-stream segment sum: the batched ``zeros((S, 3)).index_add_``.

Port of the JAX package's ``ops/segsum.py``.  :func:`scatter_add_3` keeps
its contract: a stable joint sort of (ids, values) per row, then a sum over
each run of equal ids of the sorted stream.  Ids outside ``[0, S)`` are
dropped.  On a CUDA tensor the sorted sum is the hand-written kernel
``csrc/segsum_sorted.cu`` (:data:`SEGSUM`); on a CPU tensor it is the plain
version beside it.  The callers are the Chamfer backward (``ops/chamfer.py``,
``ops/chamfer_cluster.py``) through :func:`scatter_add_3`, and the sampler's
backward (``ops/sample.py``), whose face ids are already sorted, through
:func:`segment_accumulate_sorted`.
"""

from __future__ import annotations

import ctypes

import torch

from active_3d_vision_and_touch_tpu_torch.ops._cuda import (
    CudaKernel,
    check_cuda_tensor,
    current_stream,
)

SEGSUM = CudaKernel(
    "segsum_sorted.cu",
    "segsum_sorted_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
)


def segment_sum_plain(
    idx_sorted: torch.Tensor, vals_sorted: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain version of :func:`segment_accumulate_sorted`: ``index_add_``
    over the in-range entries, row by row in index order (any id order is
    accepted)."""
    b, m = idx_sorted.shape
    keep = (idx_sorted >= 0) & (idx_sorted < num_segments)
    rows = torch.arange(b, device=idx_sorted.device)[:, None] * num_segments
    flat = (idx_sorted.long() + rows)[keep]
    out = vals_sorted.new_zeros(b * num_segments, 3)
    out.index_add_(0, flat, vals_sorted[keep])
    return out.view(b, num_segments, 3)


def _segment_sum_cuda(
    idx_sorted: torch.Tensor, vals_sorted: torch.Tensor, num_segments: int
) -> torch.Tensor:
    check_cuda_tensor("idx_sorted", idx_sorted, torch.int32, 2)
    check_cuda_tensor("vals_sorted", vals_sorted, torch.float32, 3)
    b, m = idx_sorted.shape
    if vals_sorted.shape != (b, m, 3) or vals_sorted.device != idx_sorted.device:
        raise ValueError(
            f"vals_sorted {tuple(vals_sorted.shape)} on {vals_sorted.device} "
            f"does not match idx_sorted {tuple(idx_sorted.shape)} on {idx_sorted.device}"
        )
    if b > 65535 or num_segments < 0 or b * m * 3 >= 2**31:
        raise ValueError(f"segment sum: unsupported shape B={b}, M={m}, S={num_segments}")
    out = torch.empty(b, num_segments, 3, device=idx_sorted.device, dtype=torch.float32)
    SEGSUM.launch(
        idx_sorted.data_ptr(),
        vals_sorted.data_ptr(),
        out.data_ptr(),
        b,
        m,
        num_segments,
        current_stream(out),
    )
    return out


def segment_accumulate_sorted(
    idx_sorted: torch.Tensor, vals_sorted: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """(B, M) int32 ids sorted ascending per row + (B, M, 3) f32 values →
    (B, num_segments, 3) with out[b, s] = Σ_{i: idx[b,i]=s} vals[b, i].
    A CUDA tensor goes through the kernel, a CPU tensor through the plain
    version."""
    if idx_sorted.device.type == "cpu":
        return segment_sum_plain(idx_sorted, vals_sorted, num_segments)
    return _segment_sum_cuda(idx_sorted, vals_sorted, num_segments)


def scatter_add_3(
    idx: torch.Tensor, vals: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Batched ``zeros((S, 3)).index_add_(0, idx, vals)``: a stable joint
    sort of (idx, vals) per row, then the sorted segment sum."""
    dtype = vals.dtype
    idx_s, perm = torch.sort(idx, dim=1, stable=True)
    v = torch.gather(vals.float(), 1, perm[..., None].expand(-1, -1, 3))
    out = segment_accumulate_sorted(
        idx_s.to(torch.int32).contiguous(), v.contiguous(), num_segments
    )
    return out.to(dtype)
