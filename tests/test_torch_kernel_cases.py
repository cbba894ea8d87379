"""The plain versions of the kernels against the JAX package on the cases
the kernels' designs make risky (``active_3d_vision_and_touch_tpu_torch.testing``).

JAX runs on the CPU here, its Pallas kernels in interpret mode.  The same
cases go through the hand-written kernels on the card in
``test_torch_kernels.py`` (marked ``cuda``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from active_3d_vision_and_touch_tpu.ops import chamfer_cluster as jc
from active_3d_vision_and_touch_tpu.ops.chamfer import _min_dists_pallas
from active_3d_vision_and_touch_tpu.ops.sample import _interpolate as jax_interpolate
from active_3d_vision_and_touch_tpu.ops.segsum import (
    segment_accumulate_sorted as jax_segment_accumulate_sorted,
)
from active_3d_vision_and_touch_tpu_torch.ops import chamfer_cluster as tc
from active_3d_vision_and_touch_tpu_torch.ops import min_dists, segment_accumulate_sorted
from active_3d_vision_and_touch_tpu_torch.ops import sample as torch_sample
from active_3d_vision_and_touch_tpu_torch.testing import (
    INTERPOLATE_CASES,
    NN_CLUSTER_CASES,
    NN_SHAPES,
    NN_TIE_CASES,
    SEGSUM_CASES,
    SELECT_CASES,
    cluster_first_argmin,
    first_argmin,
    interpolate_backward_float64,
    interpolate_case,
    nn_cluster_case,
    nn_shape_case,
    nn_tie_case,
    segsum_case,
    select_case,
)


@pytest.mark.parametrize("name", SEGSUM_CASES)
def test_segment_sum_plain_matches_pallas_on_run_shapes(name):
    """K2's plain version against the Pallas kernel (interpret mode), which
    sums one-hot products in lane order: |err| <= 1e-5 * (1 + Σ|v| of the
    segment).  Segments with no entry read exactly 0."""
    idx, vals, s = segsum_case(name)
    out = segment_accumulate_sorted(torch.from_numpy(idx), torch.from_numpy(vals), s).numpy()
    ref = np.asarray(
        jax_segment_accumulate_sorted(jnp.asarray(idx), jnp.asarray(vals), s, interpret=True)
    )
    assert out.shape == ref.shape == (idx.shape[0], s, 3)
    scale = np.zeros_like(out)
    filled = np.zeros(out.shape[:2], bool)
    for b in range(idx.shape[0]):
        keep = (idx[b] >= 0) & (idx[b] < s)
        np.add.at(scale[b], idx[b][keep], np.abs(vals[b][keep]))
        filled[b, idx[b][keep]] = True
    assert (np.abs(out - ref) <= 1e-5 * (1 + scale)).all()
    assert not out[~filled].any() and not ref[~filled].any()


@pytest.mark.parametrize("n,m", NN_SHAPES, ids=lambda v: str(v))
def test_min_dists_plain_matches_pallas_at_tile_edges(n, m):
    """K1's plain version against the Pallas kernel (interpret mode) at
    sizes on and beside the tiles: the index equal, the distance to rtol
    1e-5 / atol 1e-7."""
    x, y = nn_shape_case(n, m)
    d_t, i_t = min_dists(torch.from_numpy(x), torch.from_numpy(y))
    d_j, i_j = _min_dists_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True)
    assert d_t.shape == i_t.shape == (2, n)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", list(NN_TIE_CASES))
def test_min_dists_first_index_wins_placed_ties(name):
    """Equal minima one ref apart (one load of four), four and eight apart
    (the next load, the same or the next group of eight), 1024 apart
    (neighbouring tiles) and two tiles later: the plain version and the Pallas kernel both return
    ``numpy.argmin``'s first index, and the plain version its distance."""
    x, y = nn_tie_case(name)
    d_ref, i_ref = first_argmin(x, y)
    offset = NN_TIE_CASES[name]
    tied = np.take_along_axis(y, (i_ref + offset)[..., None].astype(np.int64) % y.shape[1], axis=1)
    first = np.take_along_axis(y, i_ref[..., None].astype(np.int64), axis=1)
    assert (tied == first).all(axis=-1).mean() > 0.8  # the ties are there
    d_t, i_t = min_dists(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(i_t.numpy(), i_ref)
    np.testing.assert_array_equal(d_t.numpy(), d_ref)
    _, i_j = _min_dists_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j), i_ref)


def _pallas_scan(xs, ys, ids, chunk):
    """The JAX package's Pallas scan (interpret mode) on a GIVEN table: the
    call of ``_nn_clustered_sorted`` without its selection."""
    b, np_, _ = xs.shape
    yd, c = ys.shape[0], ys.shape[1] // chunk
    n_tiles, t = ids.shape[1:]
    y_chunks = jnp.asarray(ys).reshape(yd, c, chunk, 3)
    y_packed = jnp.pad(jnp.transpose(y_chunks, (0, 1, 3, 2)), ((0, 0), (0, 0), (0, 5), (0, 0)))
    tile = lambda: pl.BlockSpec(  # noqa: E731
        (1, 256, 1), lambda b_, t_, *_: (b_, t_, 0), memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(b, n_tiles),
        in_specs=[
            pl.BlockSpec((1, 256, 3), lambda b_, t_, *_: (b_, t_, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=[tile(), tile()],
        scratch_shapes=[pltpu.VMEM((4, 8, chunk), jnp.float32), pltpu.SemaphoreType.DMA((4,))],
    )
    d, i = pl.pallas_call(
        functools.partial(jc._nn_kernel, n_chunks=t, y_distinct=None if yd == b else yd),
        grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((b, np_, 1), jnp.float32),
                   jax.ShapeDtypeStruct((b, np_, 1), jnp.int32)],
        interpret=True,
    )(jnp.asarray(ids).reshape(-1), jnp.asarray(xs), y_packed.reshape(yd, c * 8, chunk))
    return np.asarray(d[..., 0]), np.asarray(i[..., 0])


@pytest.mark.parametrize("name", NN_CLUSTER_CASES)
def test_nn_cluster_plain_matches_numpy_and_pallas_on_table_cases(name):
    """K3's plain version on chunk sizes 1, 3, 20 and 128, lists below, on and
    beyond one staging round, placed ties, a chunk listed twice and fewer ref
    rows than query rows: distance and index equal to the numpy scan
    (tolerance 0), and the index equal to the Pallas kernel's (interpret
    mode) on the same table, its distance to rtol 1e-5 / atol 1e-7.  Ids that
    name no chunk go to the plain version and to Pallas as one more chunk of
    +inf points; the numpy scan takes them as they are."""
    case = nn_cluster_case(name)
    xs, chunk = case["xs"], case["chunk"]
    ys, ids = case.get("ys_valid", case["ys"]), case.get("ids_valid", case["ids"])
    d_ref, i_ref = cluster_first_argmin(xs, case["ys"], case["ids"], chunk)
    d_t, i_t = tc.nn_cluster(
        torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(ids), chunk)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), i_ref)
    np.testing.assert_array_equal(d_t.numpy(), d_ref)
    assert int(i_ref.max()) < case["ys"].shape[1]  # no +inf point was found
    d_j, i_j = _pallas_scan(xs, ys, ids, chunk)
    np.testing.assert_array_equal(i_j, i_ref)
    np.testing.assert_allclose(d_j, d_ref, rtol=1e-5, atol=1e-7)


def test_nn_cluster_tie_cases_hold_ties():
    """The placed ties are there: in each tie case most queries have their
    least distance at two list positions, the stated number apart."""
    for name, apart in (("tie_1", 1), ("tie_8", 8), ("tie_s", 16)):
        case = nn_cluster_case(name)
        xs, ys, ids, s = case["xs"], case["ys"], case["ids"], case["chunk"]
        at = (ids[0, 0].astype(np.int64)[:, None] * s + np.arange(s)).reshape(-1)
        listed = ys[0, at]
        d = ((xs[0, :256, None, :] - listed[None]) ** 2).sum(-1)
        first = d.argmin(-1)
        tied = d[np.arange(256), np.minimum(first + apart, len(at) - 1)] == d.min(-1)
        assert tied.mean() > (0.15 if name != "tie_s" else 0.9), (name, tied.mean())
    case = nn_cluster_case("tie_table_order")
    _, i_ref = cluster_first_argmin(case["xs"], case["ys"], case["ids"], case["chunk"])
    half = case["ys"].shape[1] // 2
    assert (i_ref[:, :256] >= half).mean() > 0.9  # tile 0: the copy listed first has the higher id
    assert (i_ref[:, 256:] >= half).mean() < 0.6


@pytest.mark.parametrize("name", SELECT_CASES)
def test_select_chunks_plain_matches_jax_selection(name):
    """The selection's plain version on every chunk a candidate, T >= C, equal
    bounds, equal scores, a tile in two regions and folded ref rows: the table
    is in range, and the search it drives finds the JAX package's neighbours
    index for index (``_nn_clustered_sorted``, Pallas in interpret mode, whose
    selection is its own).  With NaN queries only the table's range, its shape
    and the other tiles' rows are held: the two packages' top-k order NaNs
    differently."""
    case = select_case(name)
    xs, ys, s, t = case["xs"], case["ys"], case["chunk"], case["chunks_per_tile"]
    b, yd, c = xs.shape[0], ys.shape[0], ys.shape[1] // s
    xt, yt = torch.from_numpy(xs), torch.from_numpy(ys)
    ids = tc.select_chunks(xt, yt, s, t)
    assert ids.dtype == torch.int32 and ids.shape == (b, xs.shape[1] // 256, min(t, c))
    assert int(ids.min()) >= 0 and int(ids.max()) < c
    assert all(len(set(row)) == len(row) for row in ids.reshape(-1, ids.shape[-1]).tolist())
    assert torch.equal(ids, tc.select_chunks_plain(xt, yt, s, t))
    if name == "nan_query":
        clean = np.nan_to_num(xs, nan=0.0, posinf=0.0)
        ids_clean = tc.select_chunks(torch.from_numpy(clean), yt, s, t)
        touched = torch.zeros(ids.shape[:2], dtype=torch.bool)
        touched[0, 0] = touched[1, 1] = touched[1, 2] = True
        assert torch.equal(ids[~touched], ids_clean[~touched])
        return
    tiled = np.tile(ys, (b // yd, 1, 1))
    _, i_j = jc._nn_clustered_sorted(
        jnp.asarray(xs), jnp.asarray(tiled), s, t, interpret=True,
        y_distinct=None if yd == b else yd)
    _, i_t = tc._nn_clustered_sorted(xt, torch.from_numpy(tiled), s, t, y_distinct=yd)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("name", INTERPOLATE_CASES)
def test_interpolate_backward_matches_float64_sum_and_jax(name):
    """The sampler's backward as a sorted segment sum, where one face takes
    every sample, most faces take none, only the first and the last face
    take any, and there is one sample: the vertex cotangent within 1e-5 * (1 +
    Σ|w g| into the vertex) of a float64 numpy sum, and the points and both
    cotangents to atol 1e-5 of the JAX VJP, which keeps its prefix-sum
    differences."""
    case = interpolate_case(name)
    verts, faces, idx, w, g = (case[k] for k in ("verts", "faces", "idx", "w", "g"))
    vt = torch.from_numpy(verts).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out_t = torch_sample._interpolate(vt, torch.from_numpy(idx), wt, torch.from_numpy(faces))
    dv_t, dw_t = torch.autograd.grad(out_t, (vt, wt), torch.from_numpy(g))
    ref = interpolate_backward_float64(case)
    scale = interpolate_backward_float64(dict(case, w=np.abs(w), g=np.abs(g)))
    assert (np.abs(dv_t.numpy() - ref) <= 1e-5 * (1 + scale)).all()

    fj = jnp.asarray(faces, jnp.int32)
    out_j, vjp = jax.vjp(
        lambda vv, ww: jax_interpolate(vv, jnp.asarray(idx, jnp.int32), ww, fj),
        jnp.asarray(verts), jnp.asarray(w))
    dv_j, dw_j = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), atol=1e-5)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), atol=1e-5)


def test_interpolate_backward_is_one_sorted_segment_sum(monkeypatch):
    """The backward hands the sorted face ids to the segment sum as they
    are: one call, the three corners folded onto the batch, int32 ids, and
    no sort anywhere."""
    case = interpolate_case("empty_faces")
    calls = []

    def recording(ids, vals, num_segments):
        calls.append((ids, vals, num_segments))
        return segment_accumulate_sorted(ids, vals, num_segments)

    def no_sort(*args, **kwargs):
        raise AssertionError("the sampler's backward sorted something")

    monkeypatch.setattr(torch_sample, "segment_accumulate_sorted", recording)
    vt = torch.from_numpy(case["verts"]).requires_grad_()
    out = torch_sample._interpolate(
        vt, torch.from_numpy(case["idx"]), torch.from_numpy(case["w"]),
        torch.from_numpy(case["faces"]))
    monkeypatch.setattr(torch, "sort", no_sort)
    monkeypatch.setattr(torch, "argsort", no_sort)
    out.backward(torch.from_numpy(case["g"]))
    (ids, vals, num_segments), = calls
    b, num = case["idx"].shape
    assert ids.dtype == torch.int32 and ids.shape == (3 * b, num)
    assert vals.shape == (3 * b, num, 3) and vals.is_contiguous()
    assert num_segments == case["faces"].shape[0]
    for k in range(3):  # corner k in rows k*B .. (k+1)*B
        assert torch.equal(ids[k * b : (k + 1) * b].long(), torch.from_numpy(case["idx"]))
        expect = torch.from_numpy(case["w"][:, :, k, None] * case["g"])
        assert torch.equal(vals[k * b : (k + 1) * b], expect)
