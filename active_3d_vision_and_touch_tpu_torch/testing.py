"""Seeded test cases for the hand-written kernels, as numpy arrays.

One source of cases for two readers: the CPU tests that hold the kernels'
plain versions against the JAX package, and the ``cuda``-marked tests that
hold the kernels against their plain versions.  The cases
sit where the kernels' designs are at risk.  The segment sum hands a run of
up to 8 entries to one thread and a longer one to a warp, and cuts a row
into slabs of 1024 entries: runs of 8 and 9 entries and of a warp's width,
runs on and beside one and two slabs, short runs that straddle a slab's end,
a slab packed with 9-entry runs, rows with nothing to sum, and streams whose
length is no multiple of four.  The nearest-neighbour kernel scans 1024-ref
tiles in groups of 8 refs, loaded four at a time: clouds whose sizes fall on
and beside the tiles, and exact ties within four refs, within and across
groups and across tiles.  The pruned scan walks a list that a table names,
in rounds of 1024 list positions and groups of 8, four positions a load when
the chunk size allows: chunk sizes that do and do not divide a group, lists
below, on and beyond a round, ties placed 1, 8 and one chunk apart and
across chunks against the id order, a chunk listed twice, ids that name no
chunk, and fewer ref rows than query rows.  The chunk selection ranks with
ties: every chunk a candidate, more chunks asked for than there are, equal
bounds, equal scores, a tile in two distant regions, and queries that are
NaN.  The sampler's backward sums runs of sorted face ids: one face taking
every sample, faces without samples, only the first and the last face, one
sample.  Beside them, :func:`surface_clouds` makes the surface-like clouds
that the clustered search is built for, and :func:`clustered_clouds` and
:func:`clustered_searches` the search's inputs at the train step's and a
shard's shapes, on a device.  This module imports numpy only; those
functions import torch and the port when called.
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


NN_CLUSTER_CASES = (
    "s1", "s3", "s20", "s128", "round_below", "round_exact", "round_beyond",
    "tie_1", "tie_8", "tie_s", "tie_table_order", "same_chunk_twice",
    "invalid_ids", "yd_lt_b",
)
SELECT_CASES = (
    "all_candidates", "t_ge_c", "equal_bounds", "equal_scores", "straddle",
    "yd_lt_b", "nan_query",
)
INTERPOLATE_CASES = ("one_face", "empty_faces", "first_and_last_face", "num1")

_TILE = 256  # queries per tile of the clustered search


def _queries_on_refs(rng, ys: np.ndarray, b: int, n: int) -> np.ndarray:
    """(b, n, 3) queries: each sits on a ref of row ``b % yd``, every other
    one moved by about 1e-3."""
    yd, m, _ = ys.shape
    pick = rng.integers(0, m, (b, n))
    xs = ys[np.arange(b)[:, None] % yd, pick]
    noise = rng.normal(size=xs.shape).astype(np.float32) * np.float32(1e-3)
    noise[:, ::2] = 0
    return np.ascontiguousarray(xs + noise)


def nn_cluster_case(name: str, seed: int = 0) -> dict:
    """Inputs of the table-driven scan: ``xs (B, k*256, 3)``, ``ys (yd, C*S, 3)``
    float32, ``ids (B, k, T)`` int32 and ``chunk`` = S.  The case
    ``invalid_ids`` holds ids -1 and C, which name no chunk; its ``ys_valid``
    and ``ids_valid`` say the same with one more chunk of +inf points, for a
    version that needs every id to name a chunk."""
    rng = np.random.default_rng(seed)
    # b, yd, c, s, t, tiles
    shapes = {
        "s1": (2, 2, 40, 1, 7, 1), "s3": (2, 2, 50, 3, 11, 2), "s20": (2, 2, 30, 20, 13, 1),
        "s128": (3, 3, 30, 128, 24, 2), "round_below": (2, 2, 12, 128, 7, 1),
        "round_exact": (2, 2, 12, 128, 8, 1), "round_beyond": (2, 2, 12, 128, 9, 1),
        "tie_1": (2, 2, 12, 16, 12, 2), "tie_8": (2, 2, 12, 16, 12, 2),
        "tie_s": (2, 2, 12, 16, 12, 2), "tie_table_order": (2, 2, 12, 16, 12, 2),
        "same_chunk_twice": (2, 2, 9, 32, 6, 2), "invalid_ids": (2, 2, 9, 20, 6, 2),
        "yd_lt_b": (4, 2, 20, 64, 5, 1),
    }
    if name not in shapes:
        raise ValueError(f"nn_cluster case {name!r}: expected one of {NN_CLUSTER_CASES}")
    b, yd, c, s, t, tiles = shapes[name]
    ys = rng.normal(size=(yd, c, s, 3)).astype(np.float32)
    ids = np.stack([
        np.stack([rng.permutation(c)[:t] for _ in range(tiles)]) for _ in range(b)
    ]).astype(np.int32)
    if name == "tie_1":  # a copy at the next position of the chunk
        for o in (0, 3, 6, 7, 14):
            ys[:, :, o + 1] = ys[:, :, o]
    elif name == "tie_8":  # a copy 8 positions on: the next group of the list
        for o in (0, 3, 7):
            ys[:, :, o + 8] = ys[:, :, o]
    elif name == "tie_s":
        # chunk 2k+1 copies chunk 2k and stands next to it in the table, the
        # higher id first in tile 0: equal points S list positions apart
        ys[:, 1::2] = ys[:, 0::2]
        ids[:, 0] = np.arange(c).reshape(-1, 2)[:, ::-1].reshape(-1)
        ids[:, 1] = np.arange(c)
    elif name == "tie_table_order":
        # chunk k + C/2 copies chunk k; tile 0 lists the ids downwards, so the
        # copy with the higher id stands first and has to win
        ys[:, c // 2 :] = ys[:, : c // 2]
        ids[:, 0] = np.arange(c)[::-1]
    elif name == "same_chunk_twice":
        ids[:, :, 3] = ids[:, :, 1]
        ids[:, 1, 5] = ids[:, 1, 4]
    ys = ys.reshape(yd, c * s, 3)
    xs = _queries_on_refs(rng, ys, b, tiles * _TILE)
    case = {"xs": xs, "ys": ys, "ids": ids, "chunk": s}
    if name == "invalid_ids":
        valid = ids.copy()
        ids[:, :, 0] = -1
        ids[:, 1, 2] = c
        ids[1, 0, 5] = c + 7
        valid[(ids < 0) | (ids >= c)] = c
        case["ids_valid"] = valid
        case["ys_valid"] = np.concatenate(
            [ys, np.full((yd, s, 3), np.inf, np.float32)], axis=1)
    return case


def cluster_first_argmin(xs, ys, ids, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """The table-driven scan by numpy: per tile the list of its T chunks in
    table order, float32 distances ((dx² + dy²) + dz²), the first list
    position of the least one, (1e30, 0) where none is below 1e30.  An id
    outside [0, C) names a chunk of +inf points."""
    b, n, _ = xs.shape
    yd = ys.shape[0]
    c = ys.shape[1] // chunk
    dist = np.empty((b, n), np.float32)
    index = np.empty((b, n), np.int32)
    padded = np.concatenate([ys, np.full((yd, chunk, 3), np.inf, np.float32)], axis=1)
    for row in range(b):
        for tile in range(n // _TILE):
            row_ids = ids[row, tile].astype(np.int64)
            listed = np.where((row_ids >= 0) & (row_ids < c), row_ids, c)
            at = (listed[:, None] * chunk + np.arange(chunk)).reshape(-1)
            q = slice(tile * _TILE, (tile + 1) * _TILE)
            with np.errstate(invalid="ignore"):
                d, pos = first_argmin(xs[row : row + 1, q], padded[row % yd][None, at])
            found = d[0] < np.float32(1e30)
            dist[row, q] = np.where(found, d[0], np.float32(1e30))
            index[row, q] = np.where(found, at[pos[0]], 0)
    return dist, index


def select_case(name: str, seed: int = 0) -> dict:
    """Inputs of the chunk selection: ``xs (B, k*256, 3)``, ``ys (yd, C*S, 3)``
    float32, ``chunk`` = S and ``chunks_per_tile`` = T."""
    rng = np.random.default_rng(seed)
    # b, yd, c, s, t, tiles
    shapes = {
        "all_candidates": (2, 2, 10, 16, 4, 2), "t_ge_c": (2, 2, 6, 16, 8, 2),
        "equal_bounds": (2, 2, 40, 16, 5, 2), "equal_scores": (2, 2, 30, 16, 4, 2),
        "straddle": (2, 2, 60, 32, 6, 2), "yd_lt_b": (6, 2, 50, 16, 5, 1),
        "nan_query": (2, 2, 40, 16, 5, 3),
    }
    if name not in shapes:
        raise ValueError(f"selection case {name!r}: expected one of {SELECT_CASES}")
    b, yd, c, s, t, tiles = shapes[name]
    # chunks are small clusters around spread centres, as sorted clouds give
    centres = rng.normal(size=(yd, c, 1, 3)).astype(np.float32)
    ys = centres + rng.normal(size=(yd, c, s, 3)).astype(np.float32) * np.float32(0.05)
    if name == "equal_bounds":
        ys[:, 7] = ys[:, 3]  # two chunks of equal points: equal bounds, votes and scores
        ys[:, 31] = ys[:, 12]
    elif name == "equal_scores":
        ys[:] = ys[:, :1]  # every chunk the same
    ys = np.ascontiguousarray(ys.reshape(yd, c * s, 3))
    xs = _queries_on_refs(rng, ys, b, tiles * _TILE)
    if name == "straddle":
        # tile 0: the first half of the queries around chunk 2, the second
        # half around chunk 50, far away on the other side of the cloud
        half = _TILE // 2
        for row in range(b):
            near = ys[row % yd].reshape(c, s, 3)
            xs[row, :half] = near[2, rng.integers(0, s, half)] + np.float32(0.01)
            xs[row, half:_TILE] = near[50, rng.integers(0, s, half)] - np.float32(0.01)
    elif name == "nan_query":
        xs[0, 5] = np.nan  # tile 0: a voter that is no anchor
        xs[1, _TILE + 32, 1] = np.nan  # tile 1 of row 1: an anchor
        xs[1, 2 * _TILE + 77, 0] = np.inf  # tile 2: an infinite coordinate
    return {"xs": xs, "ys": ys, "chunk": s, "chunks_per_tile": t}


def interpolate_case(name: str, seed: int = 0) -> dict:
    """Inputs of the sampler's interpolation and its backward: ``verts
    (B, V, 3)``, ``faces (F, 3)`` int64, per-row sorted ``idx (B, num)`` int64,
    weights ``w (B, num, 3)`` and the cotangent ``g (B, num, 3)``."""
    rng = np.random.default_rng(seed)
    b, v, f = 2, 30, 50
    num = 1 if name == "num1" else 400
    if name == "one_face":
        idx = np.full((b, num), 17)
    elif name == "empty_faces":
        idx = np.sort(rng.choice([3, 4, 20, 41], size=(b, num)), axis=1)
    elif name == "first_and_last_face":
        idx = np.sort(rng.choice([0, f - 1], size=(b, num)), axis=1)
    elif name == "num1":
        idx = np.array([[0], [f - 1]])
    else:
        raise ValueError(f"interpolate case {name!r}: expected one of {INTERPOLATE_CASES}")
    return {
        "verts": rng.normal(size=(b, v, 3)).astype(np.float32),
        "faces": rng.integers(0, v, size=(f, 3)).astype(np.int64),
        "idx": idx.astype(np.int64),
        "w": rng.uniform(size=(b, num, 3)).astype(np.float32),
        "g": rng.normal(size=(b, num, 3)).astype(np.float32),
    }


def interpolate_backward_float64(case: dict) -> np.ndarray:
    """The vertex cotangent of the interpolation as a float64 sum:
    dverts[b, faces[idx_i, k]] += w_i[k] · g_i."""
    verts, faces, idx, w, g = (case[k] for k in ("verts", "faces", "idx", "w", "g"))
    out = np.zeros(verts.shape, np.float64)
    for row in range(verts.shape[0]):
        for k in range(3):
            np.add.at(out[row], faces[idx[row], k],
                      w[row, :, k, None].astype(np.float64) * g[row].astype(np.float64))
    return out


def surface_clouds(b: int, n: int, g, device):
    """(b, n, 3) surface-like clouds made on ``device`` from the
    ``torch.Generator`` ``g``: area-weighted samples of the vision atlas (a
    sphere of radius 0.25), scaled per axis by 0.6-1.4 and bent by a
    low-frequency displacement.  The pruned search is built for surfaces;
    a Gaussian volume is none."""
    import torch

    from active_3d_vision_and_touch_tpu_torch.core import vision_charts
    from active_3d_vision_and_touch_tpu_torch.ops.sample import batch_sample

    atlas = vision_charts()
    verts = torch.as_tensor(atlas.verts, device=device)[None].expand(b, -1, -1)
    verts = verts * (0.6 + 0.8 * torch.rand(b, 1, 3, device=device, generator=g))
    phase = 6.28 * torch.rand(b, 1, 3, device=device, generator=g)
    verts = verts + 0.03 * torch.sin(9.0 * verts.roll(1, dims=-1) + phase)
    faces = torch.as_tensor(atlas.faces, device=device).long()
    return batch_sample(verts, faces, n, generator=g)


# the clustered search's defaults (``chamfer_clustered_tiled_gt``'s
# chunk_size and chunks_per_tile)
CHUNK, CHUNKS_PER_TILE = 128, 24
# Least share of queries whose clustered neighbour is the exact one, at the
# train step's shapes, in either direction.  An H100 showed 0.9765
# (predictions -> gt) and 0.9273 (gt -> predictions) on such clouds, so a
# fall below 0.90 is a change in the code
MIN_AGREEMENT = 0.90


def vtg_mesh(device):
    """The initial v_t_g mesh as the vision step fuses it: the atlas's
    vertices and its touch slots' 500 at 0, (1, V, 3), and its faces."""
    import torch

    from active_3d_vision_and_touch_tpu_torch.core import build_adj_info, vision_charts

    atlas = vision_charts()
    verts = torch.cat([torch.as_tensor(atlas.verts, device=device)[None],
                       torch.zeros(1, 500, 3, device=device)], 1)
    return verts, torch.as_tensor(build_adj_info(atlas).faces, device=device).long()


def folded_samples(verts, faces, n: int, g):
    """3 x ``n`` area-weighted samples of each mesh of ``verts`` (meshes, V,
    3), drawn from ``g``, folded onto the batch as the Chamfer loss folds its
    repeats: (3 x meshes, n, 3)."""
    import torch

    from active_3d_vision_and_touch_tpu_torch.ops.chamfer import REPEAT
    from active_3d_vision_and_touch_tpu_torch.ops.sample import batch_sample

    pts = batch_sample(verts, faces, REPEAT * n, generator=g)
    return torch.cat(torch.split(pts, n, dim=1), 0).contiguous()


def clustered_clouds(g, device, n: int = 30000) -> dict:
    """The clustered search's clouds, drawn from ``g`` on ``device``: at the
    train step, ``preds`` (48 folded sample clouds of 16 initial v_t_g
    meshes) and ``surface`` (16 surface-like gt clouds); for one of 4
    shards, ``shard_x`` (48 surface-like clouds) and ``shard_y`` (a quarter
    of 48 others)."""
    verts, faces = vtg_mesh(device)
    return {
        "preds": folded_samples(verts.expand(16, -1, -1), faces, n, g),
        "surface": surface_clouds(16, n, g, device),
        "shard_x": surface_clouds(48, n, g, device),
        "shard_y": surface_clouds(48, n, g, device)[:, : n // 4].contiguous(),
    }


def sorted_padded(points, pad: int):
    """``points`` in Morton order, edge-padded to a multiple of ``pad``, as
    the clustered loss lays them out."""
    from active_3d_vision_and_touch_tpu_torch.ops import chamfer_cluster as cluster

    return cluster._edge_pad_points(cluster._sort_by_morton(points)[0], pad).contiguous()


def clustered_searches(clouds: dict) -> dict:
    """Both directions of the train step's and a shard's clustered search on
    :func:`clustered_clouds`, sorted and padded as the loss does: name ->
    (queries, refs, the refs tiled to the queries' rows)."""
    from active_3d_vision_and_touch_tpu_torch.ops.chamfer import REPEAT

    xs, ys1 = sorted_padded(clouds["preds"], 256), sorted_padded(clouds["surface"], 256)
    ys = ys1.repeat(REPEAT, 1, 1)
    x_refs, y_refs = (sorted_padded(clouds[k], CHUNK) for k in ("shard_x", "shard_y"))
    return {
        "train step x->y": (xs, ys1, ys),
        "train step y->x": (ys, xs, xs),
        "shard x->y": (sorted_padded(clouds["shard_x"], 256), y_refs, y_refs),
        "shard y->x": (sorted_padded(clouds["shard_y"], 256), x_refs, x_refs),
    }
