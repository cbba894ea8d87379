"""The port's clustered (Morton-pruned) Chamfer against the JAX package's.

JAX runs on the CPU here, its Pallas kernel in interpret mode (which
``ops/chamfer_cluster.py`` selects by itself off the TPU); the port runs the
plain version of its kernel, which the wrapper takes for CPU tensors.  Sizes
are small (n <= 1100, S 32-64, T 8-16): the interpreted kernel is slow.  The
surface clouds are made once with the JAX package's ``random_object`` and
``batch_sample`` and handed to both sides as numpy arrays.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.data import random_object
from active_3d_vision_and_touch_tpu.ops import batch_sample as jax_batch_sample
from active_3d_vision_and_touch_tpu.ops import chamfer_cluster as jc
from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
from active_3d_vision_and_touch_tpu.ops.chamfer import _min_dists_xla
from active_3d_vision_and_touch_tpu.ops.sample import (
    _interpolate as jax_interpolate,
    _inverse_cdf_sorted as jax_inverse_cdf_sorted,
    face_areas as jax_face_areas,
)
from active_3d_vision_and_touch_tpu_torch.core import vision_charts
from active_3d_vision_and_touch_tpu_torch.ops import chamfer_cluster as tc
from active_3d_vision_and_touch_tpu_torch.ops import (
    chamfer_distance,
    mesh_chamfer_distance,
)
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise


@functools.lru_cache(maxsize=None)
def _surface_clouds(n=1024, m=1100):
    """Two samplings of one procedural object's surface (the second scaled
    by 1.01), as in the JAX package's own clustered tests."""
    obj = random_object(2)
    verts = jnp.asarray(obj.verts)[None].repeat(2, 0)
    faces = jnp.asarray(obj.faces)
    x = jax_batch_sample(verts, faces, jax.random.PRNGKey(0), num=n)
    y = jax_batch_sample(verts * 1.01, faces, jax.random.PRNGKey(1), num=m)
    return np.array(x), np.array(y)  # writable copies


def _sorted_padded(pts, mult):
    """The port's sorted, padded frame of a cloud, as numpy."""
    s, _ = tc._sort_by_morton(torch.from_numpy(pts))
    return tc._edge_pad_points(s, mult).numpy()


def test_morton_codes_and_sort_equal_jax():
    """The codes are equal as integers, so the stable sort gives the same
    permutation and the same sorted cloud."""
    x, _ = _surface_clouds()
    lo, hi = x.min(1, keepdims=True), x.max(1, keepdims=True)
    codes_j = np.asarray(jc.morton_codes(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi)))
    codes_t = tc.morton_codes(torch.from_numpy(x), torch.from_numpy(lo), torch.from_numpy(hi))
    assert codes_t.dtype == torch.int32
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    # every point twice, so every code ties: the stable sort keeps index order
    twice = np.concatenate([x[:, :300], x[:, :300][:, ::-1]], axis=1)
    for pts in (x, twice):
        sorted_j, perm_j = jc._sort_by_morton(jnp.asarray(pts))
        sorted_t, perm_t = tc._sort_by_morton(torch.from_numpy(pts))
        np.testing.assert_array_equal(perm_t.numpy(), np.asarray(perm_j))
        np.testing.assert_array_equal(sorted_t.numpy(), np.asarray(sorted_j))
    # degenerate extent: every point equal → scale clamps, all codes 0
    flat = torch.ones(1, 7, 3)
    assert not tc.morton_codes(flat, flat[:, :1], flat[:, :1]).any()


def test_edge_pad_repeats_the_last_point():
    x = torch.arange(30.0).reshape(1, 10, 3)
    p = tc._edge_pad_points(x, 8)
    assert p.shape == (1, 16, 3) and bool((p[:, 10:] == x[:, -1:]).all())
    assert tc._edge_pad_points(x, 5) is x


def test_exhaustive_search_indices_equal_jax():
    """T >= C: the pruned search is an exhaustive scan, and the sorted-frame
    indices equal JAX's index for index (tolerance 0)."""
    x, y = _surface_clouds(512, 512)
    xs, ys = _sorted_padded(x, 256), _sorted_padded(y, 64)
    _, i_j = jc._nn_clustered_sorted(jnp.asarray(xs), jnp.asarray(ys), 64, 12, interpret=True)
    d_t, i_t = tc._nn_clustered_sorted(torch.from_numpy(xs), torch.from_numpy(ys), 64, 12)
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_chamfer_clustered_value_and_grads_match_jax():
    """Exhaustive (T >= C): value to rtol 1e-5 and both gradients to rtol
    1e-4 / atol 1e-7 against the JAX custom-VJP clustered Chamfer, and the
    value to rtol 1e-5 against the port's exact Chamfer."""
    x, y = _surface_clouds(512, 512)
    g = np.array([0.7, 1.9], np.float32)
    cd_j, vjp = jax.vjp(
        lambda a, b: jc.chamfer_distance_clustered(a, b, 64, 12), jnp.asarray(x), jnp.asarray(y)
    )
    gx_j, gy_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    cd_t = tc.chamfer_distance_clustered(xt, yt, 64, 12)
    gx_t, gy_t = torch.autograd.grad(cd_t, (xt, yt), torch.from_numpy(g))
    np.testing.assert_allclose(cd_t.detach().numpy(), np.asarray(cd_j), rtol=1e-5)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), rtol=1e-4, atol=1e-7)
    cd_exact = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(cd_t.detach().numpy(), cd_exact.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="must divide"):
        tc.chamfer_distance_clustered(xt, yt, 96, 12)


@pytest.mark.parametrize(
    "chunk,chunks_per_tile,min_exact",
    # (64, 16): 16 of 18 chunks, all of them candidates.  (32, 8): 8 of 35
    # chunks from a 24-chunk anchor-ranked candidate pool, the path the
    # full-size loss takes; too few chunks to find every neighbour, so
    # only the agreement with JAX is held there.
    [(64, 16, 0.995), (32, 8, None)],
)
def test_pruned_search_on_surfaces(chunk, chunks_per_tile, min_exact):
    """Genuinely pruned (T < C) on surface clouds: the re-derived distance
    is never below the exact one, the neighbour agrees with the exact one
    for > 0.995 of the queries, and with JAX's clustered neighbour for
    >= 0.999 (measured on this machine: 1.0 in both cases; XLA may fuse the
    bounds' multiply-adds where torch rounds each step, which can move a
    near-tied chunk on a tile)."""
    x, y = _surface_clouds()
    d_j, i_j = jc.min_dists_clustered(jnp.asarray(x), jnp.asarray(y), chunk, chunks_per_tile)
    d_t, i_t = tc.min_dists_clustered(torch.from_numpy(x), torch.from_numpy(y), chunk, chunks_per_tile)
    d_t, i_t = d_t.numpy(), i_t.numpy()
    d_ref = np.asarray(_min_dists_xla(jnp.asarray(x), jnp.asarray(y))[0])
    assert (i_t == np.asarray(i_j)).mean() >= 0.999
    assert (d_t >= d_ref - 1e-9).all()
    # the distance is the one to the neighbour found, never a kernel value
    y_at = np.take_along_axis(y, i_t[..., None].astype(np.int64), axis=1)
    np.testing.assert_allclose(d_t, ((x - y_at) ** 2).sum(-1), rtol=1e-6, atol=1e-12)
    if min_exact is not None:
        assert np.isclose(d_t, d_ref, rtol=1e-5, atol=1e-10).mean() > min_exact
        np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-5, atol=1e-10)


def test_pruned_chamfer_matches_jax_and_exact():
    """Pruned (16 of 20 chunks): CD to rtol 1e-4 against JAX's clustered CD
    and to 2e-2 against the exact CD."""
    x, y = _surface_clouds()
    cd_j = np.asarray(jc.chamfer_distance_clustered(jnp.asarray(x), jnp.asarray(y), 64, 16))
    cd_t = tc.chamfer_distance_clustered(torch.from_numpy(x), torch.from_numpy(y), 64, 16).numpy()
    cd_ref = np.asarray(jax_chamfer(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(cd_t, cd_j, rtol=1e-4)
    np.testing.assert_allclose(cd_t, cd_ref, rtol=2e-2)
    assert (cd_t >= cd_ref * (1 - 1e-6)).all()


def test_tiled_gt_matches_tiled_call_and_jax():
    """chamfer_clustered_tiled_gt(x, y, 3) equals the call on the tiled gt
    in value (rtol 1e-6) and x-gradient (atol 1e-9), matches JAX (value rtol
    1e-5, gradient rtol 1e-4 / atol 1e-7), and gives y no gradient."""
    x, y = _surface_clouds(512, 512)
    r = 3
    xr = (np.tile(x, (r, 1, 1)) * (1.0 + 0.01 * np.arange(r * 2)[:, None, None])).astype(np.float32)
    cd_j, vjp = jax.vjp(
        lambda a: jc.chamfer_clustered_tiled_gt(a, jnp.asarray(y), r, 64, 12), jnp.asarray(xr)
    )
    (g_j,) = vjp(jnp.ones(r * 2, jnp.float32))
    xt = torch.from_numpy(xr).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    cd_tiled = tc.chamfer_clustered_tiled_gt(xt, yt, r, 64, 12)
    cd_tiled.sum().backward()
    assert yt.grad is None
    xt2 = torch.from_numpy(xr).requires_grad_()
    cd_full = tc.chamfer_distance_clustered(xt2, torch.from_numpy(y).repeat(r, 1, 1), 64, 12)
    (g_full,) = torch.autograd.grad(cd_full.sum(), xt2)
    np.testing.assert_allclose(cd_tiled.detach().numpy(), cd_full.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), g_full.numpy(), atol=1e-9)
    np.testing.assert_allclose(cd_tiled.detach().numpy(), np.asarray(cd_j), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-7)


def test_duplicate_chunks_resolve_as_in_jax(rng):
    """Ties everywhere: the refs are 5 distinct chunks repeated 8 times, so
    equal bounds, equal votes and equal distances occur on every tile (40
    chunks, T 4, a 12-chunk candidate pool).  The index found, which names
    the chunk, must equal JAX's: the candidate and the final top-k take the
    lower position among equals as ``jax.lax.top_k`` does, and the scan
    keeps the chunk that stands first in the table."""
    s = 32
    base = (rng.normal(size=(2, 5, s, 3)) * 0.02 + rng.normal(size=(2, 5, 1, 3))).astype(np.float32)
    ys = np.tile(base, (1, 8, 1, 1)).reshape(2, 40 * s, 3)
    xs = (ys[:, : 2 * 256] + rng.normal(size=(2, 512, 3)) * 0.01).astype(np.float32)
    _, i_j = jc._nn_clustered_sorted(jnp.asarray(xs), jnp.asarray(ys), s, 4, interpret=True)
    _, i_t = tc._nn_clustered_sorted(torch.from_numpy(xs), torch.from_numpy(ys), s, 4)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert int(i_t.max()) < 5 * s  # the first copy of every chunk won


def test_select_chunks_breaks_ties_toward_the_lower_position():
    """Every chunk identical: all bounds tie, each vote pass lands on the
    next position, and the table is 0..T-1 in order, in both the
    candidate-pool branch (3 T < C) and the all-chunks branch."""
    chunk = torch.linspace(0, 1, 16 * 3).reshape(16, 3)
    xs = torch.rand(2, 512, 3, generator=torch.Generator().manual_seed(0))
    for c, t in ((30, 4), (6, 4)):
        ys = chunk.repeat(c, 1)[None].repeat(2, 1, 1)
        ids = tc.select_chunks(xs, ys, 16, t)
        assert ids.shape == (2, 2, t) and ids.dtype == torch.int32
        assert bool((ids == torch.arange(t, dtype=torch.int32)).all())
    # y_distinct: rows of xs fold onto the distinct refs with a modulo
    ys1 = torch.rand(1, 30 * 16, 3, generator=torch.Generator().manual_seed(1))
    folded = tc.select_chunks(xs, ys1, 16, 4)
    assert torch.equal(folded, tc.select_chunks(xs, ys1.repeat(2, 1, 1), 16, 4))


def test_plain_kernel_follows_table_order_on_ties():
    """K3's plain version: inside a chunk the first index wins; across
    chunks the one that stands EARLIER IN THE TABLE wins, whatever its id;
    the index is chunk_id * S + position; a tile whose chunks hold nothing
    nearer than 1e30 keeps (1e30, 0)."""
    s = 4
    pts = torch.tensor([[1.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]])
    far = torch.full((s, 3), 50.0)
    ys = torch.cat([far, pts, far, pts], dim=0)[None]  # chunks 1 and 3 are equal
    xs = torch.zeros(1, 256, 3)
    xs[0, 1] = torch.tensor([2.0, 0, 0])
    for table, first in (([3, 1], 3), ([1, 3], 1), ([0, 3, 1], 3)):
        ids = torch.tensor([[table]], dtype=torch.int32)
        d, i = tc.nn_cluster_plain(xs, ys, ids, s)
        assert i.dtype == torch.int32
        assert int(i[0, 0]) == first * s + 0 and float(d[0, 0]) == 1.0
        assert int(i[0, 1]) == first * s + 2 and float(d[0, 1]) == 0.0
    d, i = tc.nn_cluster_plain(xs, torch.full_like(ys, 1e20), torch.tensor([[[0, 1]]], dtype=torch.int32), s)
    assert float(d[0, 0]) == float(np.float32(1e30)) and int(i[0, 0]) == 0
    # row b of the queries reads row b % yd of the refs
    xs2 = torch.zeros(2, 256, 3)
    d2, i2 = tc.nn_cluster(xs2, ys, torch.tensor([[[1]], [[3]]], dtype=torch.int32), s)
    assert i2[:, 0].tolist() == [4, 12] and d2[:, 0].tolist() == [1.0, 1.0]


def test_mesh_chamfer_distance_clustered_matches_jax(rng):
    """``mesh_chamfer_distance(nn="clustered")`` with shared draws against
    the JAX composition (sample, fold the repeats, ``chamfer_clustered_tiled_gt``
    on the untiled gt): value to rtol 1e-4, and the gradient with respect to
    the vertices to rtol 1e-3 in norm."""
    atlas = vision_charts()
    b, num, rep = 2, 200, 3
    verts = (atlas.verts[None] * rng.uniform(0.8, 1.2, size=(b, 1, 3))).astype(np.float32)
    gt = np.asarray(_surface_clouds(512, 512)[1][:, :300] * 0.5, np.float32)
    e, u, v = (t.numpy() for t in draw_sample_noise(b, num * rep, torch.Generator().manual_seed(5)))
    faces_j = jnp.asarray(atlas.faces)
    c = np.cumsum(e.astype(np.float64), axis=1).astype(np.float32)
    u_face = jnp.asarray(c[:, :-1] / c[:, -1:])
    su = np.sqrt(u)
    w = jnp.asarray(np.concatenate([1.0 - su, su * (1.0 - v), su * v], axis=-1))

    def jax_loss(vv):
        areas = jax.lax.stop_gradient(jax_face_areas(vv, faces_j))
        cdf = jnp.cumsum(areas / jnp.sum(areas, axis=1, keepdims=True), axis=1)
        idx = jnp.clip(jax_inverse_cdf_sorted(cdf, u_face), 0, faces_j.shape[0] - 1)
        pts = jax_interpolate(vv, idx, w, faces_j)
        preds = jnp.concatenate(jnp.split(pts, rep, axis=1))
        cd = jc.chamfer_clustered_tiled_gt(preds, jnp.asarray(gt), rep)
        return cd.reshape(rep, b).mean(0)

    cd_j, vjp = jax.vjp(jax_loss, jnp.asarray(verts))
    (g_j,) = vjp(jnp.ones(b, jnp.float32))
    vt = torch.from_numpy(verts).requires_grad_()
    cd_t = mesh_chamfer_distance(
        vt, torch.from_numpy(atlas.faces).long(), torch.from_numpy(gt), num=num, repeat=rep,
        nn="clustered", draws=tuple(torch.from_numpy(a) for a in (e, u, v)),
    )
    (g_t,) = torch.autograd.grad(cd_t.sum(), vt)
    np.testing.assert_allclose(cd_t.detach().numpy(), np.asarray(cd_j), rtol=1e-4)
    g_j = np.asarray(g_j)
    assert np.linalg.norm(g_t.numpy() - g_j) <= 1e-3 * np.linalg.norm(g_j)
    with pytest.raises(ValueError, match="expected 'exact', 'clustered' or 'xla'"):
        mesh_chamfer_distance(vt, torch.from_numpy(atlas.faces).long(), torch.from_numpy(gt), nn="fast")
