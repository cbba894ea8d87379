"""Seeded test cases for the hand-written kernels, as numpy arrays.

One source of cases for three readers: the CPU tests that hold the kernels'
plain versions against the JAX package, the ``cuda``-marked tests that hold
the kernels against their plain versions, and ``chip_smoke.py``.  The cases
sit where the kernels' designs are at risk.  The segment sum hands a run of
up to 8 entries to one thread and a longer one to a warp, and cuts a row
into slabs of 1024 entries: runs of 8 and 9 entries and of a warp's width,
runs on and beside one and two slabs, short runs that straddle a slab's end,
a slab packed with 9-entry runs, rows with nothing to sum, and streams whose
length is no multiple of four.  The nearest-neighbour kernel scans 1024-ref
tiles in groups of 8 refs, loaded four at a time: clouds whose sizes fall on
and beside the tiles, and exact ties within four refs, within and across
groups and across tiles.  This module imports numpy only.
"""

from __future__ import annotations

import numpy as np

SEGSUM_CASES = (
    "run_lengths",
    "one_id",
    "all_out_of_range",
    "last_segment_only",
    "m1",
    "m3",
    "s1",
    "ragged_random",
    "slab_straddle",
    "packed_nines",
)
NN_SHAPES = ((1, 1), (5, 3), (255, 1023), (256, 1024), (257, 1025), (513, 4099))
# offset of the second ref that ties with ref j
NN_TIE_CASES = {
    "same_group": 1, "next_group": 4, "next_group_of_eight": 8, "next_tile": 1024,
    "later_equal": 2054,
}

_RUN_LENGTHS = (1, 8, 9, 31, 32, 33, 1023, 1024, 1025, 2047, 2048, 2049, 5000)


def _runs_row(prefix: int) -> np.ndarray:
    """Ascending ids: a first run of ``prefix`` entries, then runs of
    ``_RUN_LENGTHS``, with one or two empty segments between runs."""
    ids, seg = [np.zeros(prefix, np.int32)], 0
    for k, length in enumerate(_RUN_LENGTHS):
        seg += 2 + k % 2
        ids.append(np.full(length, seg, np.int32))
    return np.concatenate(ids)


def segsum_case(name: str, seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """``(idx_sorted (B, M) int32, vals (B, M, 3) float32, num_segments)``."""
    rng = np.random.default_rng(seed)
    if name == "run_lengths":
        # row 0: the runs of 31, 32 and 33 straddle multiples of 32 and the
        # long ones multiples of 1024 and 2048; rows 1 and 2: the short runs
        # straddle entry 2048 and entry 1024
        rows = [_runs_row(17), _runs_row(2040), _runs_row(1018)]
        s = int(rows[0].max()) + 3  # the last two segments stay empty
        m = max(len(r) for r in rows) + 5
        idx = np.stack([np.concatenate([r, np.full(m - len(r), s + 1, np.int32)]) for r in rows])
    elif name == "one_id":
        s = 9
        idx = np.stack([np.full(3000, 5, np.int32), np.zeros(3000, np.int32)])
    elif name == "all_out_of_range":
        s = 7
        idx = np.sort(np.concatenate(
            [rng.integers(-50, 0, (2, 40)), rng.integers(s, s + 90, (2, 60))], axis=1), axis=1)
    elif name == "last_segment_only":
        s = 600
        idx = np.full((1, 50), s - 1)
    elif name == "m1":
        s = 4
        idx = np.array([[2], [s], [-1]])
    elif name == "m3":
        s = 5
        idx = np.array([[0, 0, 4], [1, 3, s + 2]])
    elif name == "s1":
        s = 1
        idx = np.sort(rng.integers(-1, 3, (2, 70)), axis=1)
    elif name == "ragged_random":
        # M % 4 == 3 and more than one slab: the unaligned rows
        s = 700
        idx = rng.integers(0, s + 40, (3, 2051))
        idx[0, :300] = 7
        idx[idx % 9 == 2] = 12
        idx = np.sort(idx, axis=1)
    elif name == "slab_straddle":
        # runs of one entry, but for one run of 3, 8 and 2 entries a row that
        # starts before entry 1024 and ends after it
        s, m = 1500, 1500
        idx = np.stack([
            np.repeat(np.arange(m - length + 1), np.where(
                np.arange(m - length + 1) == start, length, 1))
            for start, length in ((1023, 3), (1020, 8), (1023, 2))
        ])
    elif name == "packed_nines":
        # 120 runs of 9 entries on end: 113 start and end before entry 1024
        # and the 114th crosses it; row 1 the same behind 4 single entries
        s = 130
        nines = np.repeat(np.arange(4, 124), 9)
        idx = np.stack([
            np.concatenate([nines, np.full(24, 125)]),
            np.concatenate([np.arange(4), nines, np.full(20, 125)]),
        ])
    else:
        raise ValueError(f"segsum case {name!r}: expected one of {SEGSUM_CASES}")
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    vals = rng.normal(size=idx.shape + (3,)).astype(np.float32)
    return idx, vals, s


def nn_shape_case(n: int, m: int, seed: int = 0, b: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian clouds ``x (b, n, 3)`` and ``y (b, m, 3)``, float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = rng.normal(size=(b, m, 3)).astype(np.float32)
    return x, y


def nn_tie_case(name: str, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Clouds in which ref ``j + NN_TIE_CASES[name]`` is a copy of ref ``j``
    for a spread of ``j`` (every place in a load of four, both halves of a
    group of eight, both sides of a tile edge), and each query sits on, or within 1e-3 of, one such ``j``.
    Equal refs give equal distances whatever the rounding, so the least
    distance is attained twice and the first index has to win."""
    offset = NN_TIE_CASES[name]
    rng = np.random.default_rng(seed)
    m = 3200
    y = rng.normal(size=(2, m, 3)).astype(np.float32)
    js = np.array([0, 6, 13, 19, 510, 1019, 1022, 1030, 1100])
    y[:, js + offset] = y[:, js]
    on = y[:, js]
    near = on + rng.normal(size=on.shape).astype(np.float32) * np.float32(1e-3)
    x = np.concatenate([on, near], axis=1)
    return np.ascontiguousarray(x), y


def first_argmin(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The reference by numpy: float32 distances ((dx² + dy²) + dz²) with
    dx = x - y, each step rounded on its own, and ``argmin``'s first index."""
    diff = x[:, :, None, :] - y[:, None, :, :]
    sq = diff * diff
    full = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    index = np.argmin(full, axis=-1)
    return np.take_along_axis(full, index[..., None], axis=-1)[..., 0], index.astype(np.int32)
