"""Clustered (pruned) nearest-neighbour Chamfer distance.

Port of the JAX package's ``ops/chamfer_cluster.py``.  The exact kernel of
:mod:`ops.chamfer` compares every query with every reference point; this
module prunes that sweep with spatial locality:

1. both clouds are sorted along a Morton (Z-order) curve, so contiguous
   chunks of ``S`` reference points are spatially coherent;
2. every tile of 256 sorted queries selects ``T`` reference chunks by a
   per-query vote: each query ranks the candidate chunks by the lower bound
   ||q - chunk_centre|| - chunk_radius and votes for its best 3, and the
   tile scans the most-voted chunks;
3. the kernel ``csrc/nn_cluster.cu`` (:data:`NN_CLUSTER`) scans only those
   ``T`` chunks per tile, in the order the table lists them.  On a CPU
   tensor :func:`nn_cluster_plain` beside it does the same with torch ops;
4. the distance to the found neighbour is re-derived in float32 outside
   the kernel, so pruning can only change *which* neighbour is found, never
   the arithmetic of the value or the gradient.

The sorts, the chunk centres and radii and the tile centroids are torch ops,
as they are XLA ops in the JAX package.  The tile selection of step 2, which
the JAX package leaves to XLA to fuse under ``lax.map``, is the kernel
``csrc/select_chunks.cu`` (:data:`SELECT_CHUNKS`) on a CUDA tensor and
:func:`select_chunks_plain`, the same selection as torch ops, on a CPU
tensor.  The search is not exact in the worst case (a true neighbour
in a chunk the tile did not select is missed): it is the training-loss
accelerator, and :func:`ops.chamfer.chamfer_distance` stays the scorer.
"""

from __future__ import annotations

import ctypes

import torch

from active_3d_vision_and_touch_tpu_torch.ops._cuda import (
    CudaKernel,
    check_cuda_tensor,
    current_stream,
)
from active_3d_vision_and_touch_tpu_torch.ops.segsum import (
    scatter_add_3,
    segment_sum_plain,
)

NN_CLUSTER = CudaKernel(
    "nn_cluster.cu",
    "nn_cluster_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

SELECT_CHUNKS = CudaKernel(
    "select_chunks.cu",
    "select_chunks_launch",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

_TN = 256  # queries per tile

# Tile-selection knobs, the JAX package's values.  ``_CAND_FACTOR * T`` is
# the anchor-ranked candidate pool the per-query vote runs over; voters are
# every ``_VOTE_STRIDE``-th query of the tile.
_VOTE_STRIDE = 1
_CAND_FACTOR = 3

_MAX_TABLE_ROW = 8192  # the scan holds a tile's chunk ids in shared memory
_MAX_SELECT_SHARED = 227 * 1024  # bytes of shared memory a block can use
_SELECT_CHUNK_ELEMS = 1 << 26  # (B, tiles, TN, K) bound block of the selection
_PLAIN_CHUNK_ELEMS = 1 << 25  # (B, tiles, TN, T*S) distance block, plain version


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (int32 Morton helper)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(..., 3) points → int32 Z-order codes on a 1024^3 lattice over
    [lo, hi] (per-cloud bounds, broadcastable)."""
    scale = torch.clamp(hi - lo, min=1e-12)
    q = ((points - lo) / scale * 1023.0).clamp(0, 1023).to(torch.int32)
    return (
        _part1by2(q[..., 0])
        | (_part1by2(q[..., 1]) << 1)
        | (_part1by2(q[..., 2]) << 2)
    )


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row gather: arr (B, M, 3) or (B, M), idx (B, N) → arr[b, idx[b]]."""
    if arr.dim() == 3:
        return torch.gather(arr, 1, idx[..., None].expand(-1, -1, arr.shape[2]))
    return torch.gather(arr, 1, idx)


def _sort_by_morton(pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each cloud's points along the Z-curve; returns (sorted, perm).
    One stable sort on the code, so ties keep their index order."""
    lo = pts.amin(dim=1, keepdim=True)
    hi = pts.amax(dim=1, keepdim=True)
    codes = morton_codes(pts, lo, hi)  # (B, N)
    perm = torch.sort(codes, dim=1, stable=True).indices
    return _take(pts, perm), perm


def _edge_pad_points(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Pad the point axis to a multiple by repeating the last point: a far
    sentinel would poison the tile and chunk centroids, and a duplicate
    cannot change any minimum."""
    pad = (-x.shape[1]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x[:, -1:, :].expand(-1, pad, -1)], dim=1)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b||^2 over the last axis as ((dx² + dy²) + dz²), each step
    rounded on its own: the order of the kernels and their plain versions,
    so a re-derived distance equals the one the exact search computes for
    the same pair."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _bound(points: torch.Tensor, centres: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """Lower bound of the distance from each point to any point of each
    chunk: points (..., P, 3), centres (..., K, 3), radii (..., K) →
    (..., P, K).  Summed per coordinate, so no (..., P, K, 3) block is held."""
    sq = None
    for k in range(3):
        d = points[..., :, None, k] - centres[..., None, :, k]
        sq = d * d if sq is None else sq + d * d
    return torch.sqrt(sq) - radii[..., None, :]


def _selection_stats(
    xs: torch.Tensor, ys: torch.Tensor, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the selection reads beside the queries: the chunk centres
    (yd, C, 3) and radii (yd, C) of the refs and the tile centroids
    (B, n_tiles, 3) of the queries.  Reductions, left to the library on
    every device, in a fixed order: the kernel and the plain version call
    this on the same inputs and so start from the same bits."""
    yd = ys.shape[0]
    y_chunks = ys.reshape(yd, ys.shape[1] // chunk_size, chunk_size, 3)
    chunk_c = y_chunks.mean(dim=2)  # (yd, C, 3)
    chunk_r = torch.sqrt(
        ((y_chunks - chunk_c[:, :, None, :]) ** 2).sum(dim=-1).amax(dim=2)
    )  # (yd, C)
    tile_c = xs.reshape(xs.shape[0], xs.shape[1] // _TN, _TN, 3).mean(dim=2)
    return chunk_c, chunk_r, tile_c


def select_chunks_plain(
    xs: torch.Tensor, ys: torch.Tensor, chunk_size: int, chunks_per_tile: int
) -> torch.Tensor:
    """Plain version of :func:`select_chunks`, as torch ops on any device,
    from the same :func:`_selection_stats`.  Tiles are independent and are
    processed in groups that bound the temporaries."""
    b, np_, _ = xs.shape
    yd = ys.shape[0]
    c = ys.shape[1] // chunk_size
    n_tiles = np_ // _TN
    t_sel = min(chunks_per_tile, c)
    chunk_c, chunk_r, tile_c_all = _selection_stats(xs, ys, chunk_size)
    reps = b // yd
    if reps > 1:
        chunk_c = chunk_c.repeat(reps, 1, 1)
        chunk_r = chunk_r.repeat(reps, 1)
    chunk_c = chunk_c[:, None]  # (B, 1, C, 3): shared by a row's tiles
    chunk_r = chunk_r[:, None]

    k_cand = min(_CAND_FACTOR * t_sel, c)
    k_vote = min(3, k_cand)
    x_tiles = xs.reshape(b, n_tiles, _TN, 3)
    group = max(1, _SELECT_CHUNK_ELEMS // max(1, b * _TN * k_cand))
    out = []
    for t0 in range(0, n_tiles, group):
        x_full = x_tiles[:, t0 : t0 + group]  # (B, g, TN, 3)
        g = x_full.shape[1]
        if k_cand < c:
            anchors = x_full[:, :, :: _TN // 8, :]  # (B, g, 8, 3)
            a_bound = _bound(anchors, chunk_c, chunk_r).amin(dim=2)  # (B, g, C)
            # the k_cand least bounds, the lower chunk id first among equals
            cand = torch.sort(a_bound, dim=-1, stable=True).indices[..., :k_cand]
            flat = cand.reshape(b, g * k_cand)
            cc = _take(chunk_c[:, 0], flat).reshape(b, g, k_cand, 3)
            cr = _take(chunk_r[:, 0], flat).reshape(b, g, k_cand)
        else:
            cand, cc, cr = None, chunk_c, chunk_r
        voters = x_full[:, :, ::_VOTE_STRIDE, :] if _VOTE_STRIDE > 1 else x_full
        q_bound = _bound(voters, cc, cr)  # (B, g, TN, K)
        votes = torch.zeros(b, g, k_cand, dtype=torch.float32, device=xs.device)
        for _ in range(k_vote):
            best = q_bound.argmin(dim=-1)  # first index of the least bound
            votes.scatter_add_(2, best, torch.ones_like(best, dtype=torch.float32))
            q_bound.scatter_(3, best[..., None], float("inf"))
        tile_c = tile_c_all[:, t0 : t0 + g, None]  # (B, g, 1, 3)
        tile_bound = _bound(tile_c, cc, cr)[:, :, 0]  # (B, g, K)
        score = votes + 1.0 / (1.0 + torch.clamp(tile_bound, min=0.0))
        # the t_sel highest scores, the lower position first among equals
        ids = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :t_sel]
        if cand is not None:
            ids = torch.gather(cand, 2, ids)
        out.append(ids)
    return torch.cat(out, dim=1).to(torch.int32)


def _select_chunks_cuda(
    xs: torch.Tensor, chunk_c: torch.Tensor, chunk_r: torch.Tensor,
    tile_c: torch.Tensor, t_sel: int,
) -> torch.Tensor:
    check_cuda_tensor("xs", xs, torch.float32, 3)
    check_cuda_tensor("chunk_c", chunk_c, torch.float32, 3)
    check_cuda_tensor("chunk_r", chunk_r, torch.float32, 2)
    check_cuda_tensor("tile_c", tile_c, torch.float32, 3)
    b, np_, _ = xs.shape
    yd, c, _ = chunk_c.shape
    n_tiles = np_ // _TN
    k_cand = min(_CAND_FACTOR * t_sel, c)
    if (
        xs.shape[2] != 3 or np_ % _TN or chunk_c.shape[2] != 3
        or chunk_r.shape != (yd, c) or tile_c.shape != (b, n_tiles, 3)
        or len({xs.device, chunk_c.device, chunk_r.device, tile_c.device}) != 1
    ):
        raise ValueError(
            f"xs {tuple(xs.shape)}, chunk_c {tuple(chunk_c.shape)}, chunk_r "
            f"{tuple(chunk_r.shape)}, tile_c {tuple(tile_c.shape)}: expected "
            f"(B, k*{_TN}, 3), (yd, C, 3), (yd, C) and (B, k, 3) on one device"
        )
    shared = 24 * k_cand + 4 * max(c, k_cand)
    if (
        yd == 0 or b % yd or not 1 <= t_sel <= c or b > 65535
        or shared > _MAX_SELECT_SHARED or b * np_ * 3 >= 2**31
        or b * n_tiles * t_sel >= 2**31
    ):
        raise ValueError(
            f"chunk selection: unsupported shape B={b}, Np={np_}, yd={yd}, C={c}, T={t_sel}"
        )
    out = torch.empty(b, n_tiles, t_sel, device=xs.device, dtype=torch.int32)
    SELECT_CHUNKS.launch(
        xs.data_ptr(), chunk_c.data_ptr(), chunk_r.data_ptr(), tile_c.data_ptr(),
        out.data_ptr(), b, np_, yd, c, t_sel, k_cand, current_stream(xs),
    )
    return out


def select_chunks(
    xs: torch.Tensor, ys: torch.Tensor, chunk_size: int, chunks_per_tile: int
) -> torch.Tensor:
    """The chunk table: for every tile of ``_TN`` sorted queries the ids of
    the ``T = min(chunks_per_tile, C)`` reference chunks it scans, in
    descending score order → (B, n_tiles, T) int32.

    xs (B, Np, 3) and ys (yd, C*S, 3) are Morton-sorted and padded; row b
    of xs is searched in row ``b % yd`` of ys.  A tile of sorted queries can
    straddle a Z-curve discontinuity, so the tile's centroid alone misses
    the minority side.  Instead 8 anchor queries spread over the tile rank
    all chunks by their least bound and keep the best ``3 T`` as candidates;
    every query then votes for its 3 best candidates (three passes of argmin
    and mask), and the tile takes the ``T`` most-voted, ties going to the
    chunk nearer the tile's centroid and then to the lower position.  A CUDA
    tensor goes through the kernel, which takes the chunk centres and radii
    and the tile centroids from torch ops; a CPU tensor goes through the
    plain version.
    """
    if xs.device.type == "cpu":
        return select_chunks_plain(xs, ys, chunk_size, chunks_per_tile)
    chunk_c, chunk_r, tile_c = _selection_stats(xs, ys, chunk_size)
    t_sel = min(chunks_per_tile, ys.shape[1] // chunk_size)
    return _select_chunks_cuda(
        xs.contiguous(), chunk_c.contiguous(), chunk_r.contiguous(),
        tile_c.contiguous(), t_sel,
    )


def nn_cluster_plain(
    xs: torch.Tensor, ys: torch.Tensor, chunk_ids: torch.Tensor, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: xs (B, Np, 3), ys (yd, C*S, 3),
    chunk_ids (B, Np/256, T) → (B, Np) f32 least squared distance over the
    tile's chunks and (B, Np) int32 index into the sorted refs.

    Each tile's T chunks are gathered in table order into one list of T*S
    points; the distance is ((dx² + dy²) + dz²), each step rounded on its
    own; ``min`` returns the first position of the least distance, which is
    the kernel's rule: first index inside a chunk, and across chunks the
    one that stands earlier in the table.  The best starts at (1e30, 0).
    """
    b, np_, _ = xs.shape
    yd = ys.shape[0]
    n_tiles, t = chunk_ids.shape[1], chunk_ids.shape[2]
    s = chunk_size
    rows = (torch.arange(b, device=xs.device) % yd)[:, None, None]
    offs = torch.arange(s, device=xs.device)
    x_tiles = xs.reshape(b, n_tiles, _TN, 3)
    group = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * _TN * t * s))
    ds, idxs = [], []
    for t0 in range(0, n_tiles, group):
        ids = chunk_ids[:, t0 : t0 + group].long()  # (B, g, T)
        g = ids.shape[1]
        pidx = (ids[..., None] * s + offs).reshape(b, g, t * s)
        refs = ys[rows, pidx]  # (B, g, T*S, 3)
        xq = x_tiles[:, t0 : t0 + g, :, None, :]  # (B, g, TN, 1, 3)
        dx = xq[..., 0] - refs[:, :, None, :, 0]
        dy = xq[..., 1] - refs[:, :, None, :, 1]
        dz = xq[..., 2] - refs[:, :, None, :, 2]
        d = dx * dx + dy * dy + dz * dz  # (B, g, TN, T*S)
        val, pos = d.min(dim=-1)  # (B, g, TN): first position of the minimum
        index = torch.gather(pidx, 2, pos)  # position in the list → sorted-ref index
        better = val < 1e30
        ds.append(torch.where(better, val, torch.full_like(val, 1e30)))
        idxs.append(torch.where(better, index, torch.zeros_like(index)))
    d = torch.cat(ds, dim=1).reshape(b, np_)
    i = torch.cat(idxs, dim=1).reshape(b, np_).to(torch.int32)
    return d, i


def _nn_cluster_cuda(
    xs: torch.Tensor, ys: torch.Tensor, chunk_ids: torch.Tensor, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    check_cuda_tensor("xs", xs, torch.float32, 3)
    check_cuda_tensor("ys", ys, torch.float32, 3)
    check_cuda_tensor("chunk_ids", chunk_ids, torch.int32, 3)
    b, np_, _ = xs.shape
    yd, m, _ = ys.shape
    t = chunk_ids.shape[2]
    if (
        xs.shape[2] != 3 or ys.shape[2] != 3 or np_ % _TN or m % chunk_size
        or chunk_ids.shape[:2] != (b, np_ // _TN)
        or ys.device != xs.device or chunk_ids.device != xs.device
    ):
        raise ValueError(
            f"xs {tuple(xs.shape)} on {xs.device}, ys {tuple(ys.shape)} on {ys.device}, "
            f"chunk_ids {tuple(chunk_ids.shape)} on {chunk_ids.device}: expected "
            f"(B, k*{_TN}, 3), (yd, C*{chunk_size}, 3) and (B, k, T) on one device"
        )
    if (
        yd == 0 or b % yd or m == 0 or b > 65535 or chunk_size < 1
        or not 1 <= t <= _MAX_TABLE_ROW or t * chunk_size >= 2**31
        or max(b * np_, yd * m) * 3 >= 2**31 or chunk_ids.numel() >= 2**31
    ):
        raise ValueError(
            f"clustered nearest neighbour: unsupported shape B={b}, Np={np_}, "
            f"yd={yd}, M={m}, T={t}, S={chunk_size}"
        )
    dist = torch.empty(b, np_, device=xs.device, dtype=torch.float32)
    index = torch.empty(b, np_, device=xs.device, dtype=torch.int32)
    NN_CLUSTER.launch(
        xs.data_ptr(), ys.data_ptr(), chunk_ids.data_ptr(), dist.data_ptr(),
        index.data_ptr(), b, np_, yd, m // chunk_size, t, chunk_size,
        current_stream(xs),
    )
    return dist, index


def nn_cluster(
    xs: torch.Tensor, ys: torch.Tensor, chunk_ids: torch.Tensor, chunk_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The table-driven scan: row b of the sorted, padded queries xs
    (B, Np, 3) against row ``b % yd`` of the sorted, padded refs ys
    (yd, C*S, 3), each tile of 256 queries over the chunks its row of
    chunk_ids (B, Np/256, T) int32 names → (B, Np) f32 distance and (B, Np)
    int32 index into the sorted refs.  A CUDA tensor goes through the
    kernel, which takes any S >= 1 and a table row of 1 <= T <= 8192 ids
    (it holds the row in shared memory), a CPU tensor through the plain
    version."""
    if xs.device.type == "cpu":
        return nn_cluster_plain(xs, ys, chunk_ids, chunk_size)
    return _nn_cluster_cuda(
        xs.contiguous(), ys.contiguous(), chunk_ids.contiguous(), chunk_size
    )


def _nn_clustered_sorted(
    xs: torch.Tensor,  # (B, Np, 3) Morton-sorted, padded queries
    ys: torch.Tensor,  # (B, C*S, 3) Morton-sorted, padded references
    chunk_size: int,
    chunks_per_tile: int,
    y_distinct: int | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Min (approximate distance, argmin into sorted y) for sorted inputs.

    ``y_distinct=k`` declares that ys is a tiling of its first k rows
    (ys[i] == ys[i % k]): the chunk statistics are computed once for the k
    distinct clouds and the search folds the batch index with a modulo."""
    yd = y_distinct if y_distinct is not None else xs.shape[0]
    refs = ys[:yd]
    select = select_chunks_plain if plain else select_chunks
    chunk_ids = select(xs, refs, chunk_size, chunks_per_tile)
    search = nn_cluster_plain if plain else nn_cluster
    return search(xs, refs, chunk_ids, chunk_size)


def _unscramble(i_sorted, xperm, yperm, x, y):
    """Sorted-frame NN indices → original-frame (distance, index)."""
    n, m = x.shape[1], y.shape[1]
    i_sorted = i_sorted[:, :n].long().clamp(0, m - 1)
    i_orig_for_sorted_x = _take(yperm, i_sorted)
    # re-scatter to the original x order
    i_orig = torch.zeros_like(i_orig_for_sorted_x)
    i_orig.scatter_(1, xperm[:, :n], i_orig_for_sorted_x)
    # exact distances in the original frame
    return _sq_dist(x, _take(y, i_orig)), i_orig.to(torch.int32)


def min_dists_clustered(
    x: torch.Tensor,
    y: torch.Tensor,
    chunk_size: int = 128,
    chunks_per_tile: int = 24,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,N,3),(B,M,3) → per-query (B,N) exact squared distance to the
    found neighbour and its int32 index into the ORIGINAL y ordering."""
    xs, xperm = _sort_by_morton(x)
    ys, yperm = _sort_by_morton(y)
    xs = _edge_pad_points(xs, _TN)
    ys = _edge_pad_points(ys, chunk_size)
    _, i_sorted = _nn_clustered_sorted(xs, ys, chunk_size, chunks_per_tile, plain=plain)
    return _unscramble(i_sorted, xperm, yperm, x, y)


def _pair_min_dists_sorted(
    x, y, chunk_size, chunks_per_tile, y_sorted=None, y_distinct=None,
    sort_x=True, plain=False,
):
    """Both sweep directions off ONE Morton sort per cloud, everything in
    the SORTED frame: the CD value is a mean over queries, so it never
    needs the original ordering, and the permutation is applied once, in
    the backward pass.

    ``y_sorted=(ys, yperm)`` skips the y-side sort: the 3-repeat training
    loss tiles the SAME gt cloud across repeats, so its caller sorts the
    distinct clouds once and tiles the sorted result.  ``sort_x=False``
    takes the queries in the order given (mesh samples arrive in face
    order, already coherent per tile)."""
    if _TN % chunk_size != 0:
        raise ValueError(
            f"chunk_size {chunk_size} must divide the query tile {_TN} so one "
            "padding serves both roles"
        )
    n, m = x.shape[1], y.shape[1]
    if sort_x:
        xs, xperm = _sort_by_morton(x)
    else:
        xs = x
        xperm = torch.arange(n, device=x.device).expand(x.shape[0], -1)
    ys, yperm = y_sorted if y_sorted is not None else _sort_by_morton(y)
    xs_p = _edge_pad_points(xs, _TN)
    ys_p = _edge_pad_points(ys, _TN)

    _, ix_s = _nn_clustered_sorted(
        xs_p, ys_p, chunk_size, chunks_per_tile, y_distinct=y_distinct, plain=plain
    )
    _, iy_s = _nn_clustered_sorted(ys_p, xs_p, chunk_size, chunks_per_tile, plain=plain)
    ix_s = ix_s[:, :n].long().clamp(0, m - 1)
    iy_s = iy_s[:, :m].long().clamp(0, n - 1)
    # exact distances re-derived in f32, sorted frame
    dx_s = _sq_dist(xs, _take(ys, ix_s))  # (B, n)
    dy_s = _sq_dist(ys, _take(xs, iy_s))  # (B, m)
    return (xs, ys, ix_s, iy_s, xperm, yperm), dx_s, dy_s


def _clustered_backward(res, g, plain: bool, want_y: bool):
    """The Chamfer VJP as ONE index-addressed accumulation per cloud.

    Each cloud's cotangent is a sum of two streams: its own per-query term
    and the cross term from the other direction's queries.  Both carry
    ORIGINAL-frame ids (the sorted→original permutation is folded into the
    id stream by an integer gather), so no unsort follows; the fused
    (n+m)-entry stream feeds a single :func:`ops.segsum.scatter_add_3`."""
    xs, ys, ix_s, iy_s, xperm, yperm = res
    n, m = xs.shape[1], ys.shape[1]
    gx = (g / n)[:, None, None]
    gy = (g / m)[:, None, None]
    diff1 = gx * 2.0 * (xs - _take(ys, ix_s))  # (B, n, 3) d/dxs of direction 1
    diff2 = gy * 2.0 * (ys - _take(xs, iy_s))  # (B, m, 3) d/dys of direction 2
    # the plain sum takes unsorted ids as they are
    scatter = segment_sum_plain if plain else scatter_add_3
    idx_x = torch.cat([xperm, _take(xperm, iy_s)], dim=1)  # (B, n+m)
    dx = scatter(idx_x, torch.cat([diff1, -diff2], dim=1), n)
    if not want_y:
        return dx, None
    idx_y = torch.cat([yperm, _take(yperm, ix_s)], dim=1)
    return dx, scatter(idx_y, torch.cat([diff2, -diff1], dim=1), m)


class _ChamferClustered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, chunk_size, chunks_per_tile, plain):
        res, dx_s, dy_s = _pair_min_dists_sorted(
            x, y, chunk_size, chunks_per_tile, plain=plain
        )
        ctx.save_for_backward(*res)
        ctx.plain = plain
        return dx_s.mean(dim=1) + dy_s.mean(dim=1)

    @staticmethod
    def backward(ctx, g):
        dx, dy = _clustered_backward(ctx.saved_tensors, g, ctx.plain, want_y=True)
        return dx, dy, None, None, None


def chamfer_distance_clustered(
    x: torch.Tensor,
    y: torch.Tensor,
    chunk_size: int = 128,
    chunks_per_tile: int = 24,
    plain: bool = False,
) -> torch.Tensor:
    """Symmetric Chamfer distance via the pruned NN search: x (B,N,3),
    y (B,M,3) → (B,).  ``plain=True`` runs the plain versions of all
    three kernels (selection, scan, segment sum) on any device."""
    return _ChamferClustered.apply(x, y, chunk_size, chunks_per_tile, plain)


class _ChamferClusteredTiledGt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, repeat, chunk_size, chunks_per_tile, plain):
        ys1, yperm1 = _sort_by_morton(y)
        ys = ys1.repeat(repeat, 1, 1)
        yperm = yperm1.repeat(repeat, 1)
        res, dx_s, dy_s = _pair_min_dists_sorted(
            x, ys, chunk_size, chunks_per_tile, y_sorted=(ys, yperm),
            y_distinct=y.shape[0], plain=plain,
        )
        ctx.save_for_backward(*res)
        ctx.plain = plain
        return dx_s.mean(dim=1) + dy_s.mean(dim=1)

    @staticmethod
    def backward(ctx, g):
        dx, _ = _clustered_backward(ctx.saved_tensors, g, ctx.plain, want_y=False)
        return dx, None, None, None, None, None


def chamfer_clustered_tiled_gt(
    x: torch.Tensor,
    y: torch.Tensor,
    repeat: int,
    chunk_size: int = 128,
    chunks_per_tile: int = 24,
    plain: bool = False,
) -> torch.Tensor:
    """Clustered CD where x is (R·B, N, 3) predictions and y is the (B, M,
    3) ground-truth cloud shared by the R repeats (the 3-repeat training
    loss, :func:`ops.chamfer.mesh_chamfer_distance`) → (R·B,).  Equal to
    ``chamfer_distance_clustered(x, y.repeat(R, 1, 1))``, but the B distinct
    gt clouds are Morton-sorted once and the SORTED result is tiled.  The
    gradient flows to x only: gt is data in every caller."""
    return _ChamferClusteredTiledGt.apply(x, y, repeat, chunk_size, chunks_per_tile, plain)
