"""The hand-written CUDA kernels against their plain PyTorch versions.

The tests marked ``cuda`` need a card and nvcc and skip elsewhere.  This file
imports no JAX, so on a machine without JAX it runs alone:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu_torch.ops import (
    KERNELS,
    NN_CLUSTER,
    NN_EXACT,
    SEGSUM,
    SELECT_CHUNKS,
    min_dists,
    nn_cluster,
    scatter_add_3,
)
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import min_dists_plain
from active_3d_vision_and_touch_tpu_torch.ops.chamfer_cluster import (
    _edge_pad_points,
    _sort_by_morton,
    nn_cluster_plain,
    select_chunks,
    select_chunks_plain,
)
from active_3d_vision_and_touch_tpu_torch.ops.sample import _interpolate
from active_3d_vision_and_touch_tpu_torch.ops.segsum import (
    segment_accumulate_sorted,
    segment_sum_plain,
)
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _clouds(rng, b=2, n=300, m=700):
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    y = rng.normal(size=(b, m, 3)).astype(np.float32)
    return x, y


def _with_ties(rng):
    """Clouds where many queries are equidistant from several refs: y holds
    repeated points and x sits exactly on some of them."""
    base = rng.integers(-3, 4, size=(2, 40, 3)).astype(np.float32)
    y = np.concatenate([base, base[:, ::-1], base], axis=1)  # every point 3x
    x = np.concatenate([base[:, :20], rng.integers(-3, 4, size=(2, 30, 3))], axis=1)
    return x.astype(np.float32), y


def _segment_inputs(rng, b=3, n=700, s=530):
    idx = rng.integers(0, s, (b, n)).astype(np.int32)
    idx[0, :50] = 7  # a duplicate-heavy segment
    idx[1, :40] = s  # out of range: dropped
    idx[2, :30] = s + 100
    idx[idx == 11] = 12  # an empty segment
    val = rng.normal(size=(b, n, 3)).astype(np.float32)
    return idx, val, s


def test_kernel_sources_exist_and_cpu_tensors_launch_nothing():
    """Every kernel's source is in the package; a CPU tensor takes the plain
    version, and no launch is counted."""
    rng = np.random.default_rng(0)
    assert [k.name for k in KERNELS] == [
        "nn_exact", "segsum_sorted", "nn_cluster", "select_chunks"]
    for k in KERNELS:
        assert k.source.exists()
    before = [k.launches for k in KERNELS]
    x, y = _clouds(rng, b=1, n=20, m=30)
    _, i = min_dists(torch.from_numpy(x), torch.from_numpy(y))
    scatter_add_3(i, torch.ones(1, 20, 3), 30)
    nn_cluster(torch.zeros(1, 256, 3), torch.ones(1, 8, 3), torch.zeros(1, 1, 2, dtype=torch.int32), 4)
    select_chunks(torch.zeros(1, 256, 3), torch.ones(1, 8, 3), 4, 2)
    verts = torch.from_numpy(rng.normal(size=(1, 5, 3)).astype(np.float32)).requires_grad_()
    faces = torch.tensor([[0, 1, 2], [2, 3, 4]])
    _interpolate(verts, torch.tensor([[0, 0, 1]]), torch.ones(1, 3, 3), faces).sum().backward()
    assert [k.launches for k in KERNELS] == before


@pytest.mark.cuda
def test_nn_kernel_matches_plain_on_card(cuda_device):
    """Kernel K1 against its plain version on the card: tolerance 0."""
    rng = np.random.default_rng(0)
    launches = NN_EXACT.launches
    for b, n, m in ((2, 300, 700), (3, 1000, 4097)):
        x, y = _clouds(rng, b, n, m)
        xt, yt = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device)
        d, i = min_dists(xt, yt)
        d_p, i_p = min_dists_plain(xt, yt)
        assert torch.equal(d, d_p) and torch.equal(i, i_p)
    x, y = _with_ties(rng)
    d, i = min_dists(torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device))
    full = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.cpu().numpy(), np.argmin(full, axis=-1))
    assert NN_EXACT.launches == launches + 3  # a CUDA tensor went to the kernel
    with pytest.raises(TypeError):
        min_dists(xt.double(), yt.double())


@pytest.mark.cuda
def test_segsum_kernel_matches_plain_on_card(cuda_device):
    """Kernel K2 against the plain version on the card, whose index_add_
    adds with atomics: tolerance 1e-5 * (1 + Σ|v| of the segment)."""
    rng = np.random.default_rng(0)
    idx, val, s = _segment_inputs(rng)
    it, vt = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(val).to(cuda_device)
    out = scatter_add_3(it, vt, s)
    ref = segment_sum_plain(it, vt, s)
    scale = segment_sum_plain(it, vt.abs(), s)
    assert bool(((out - ref).abs() <= 1e-5 * (1 + scale)).all())
    assert SEGSUM.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", NN_SHAPES, ids=lambda v: str(v))
def test_nn_kernel_matches_plain_at_tile_edges_on_card(cuda_device, n, m):
    """K1 at sizes on and beside its tiles (512 queries a block, 1024 refs a
    tile, groups of eight refs): tolerance 0 on distance and index."""
    x, y = (torch.from_numpy(a).to(cuda_device) for a in nn_shape_case(n, m))
    d, i = min_dists(x, y)
    d_p, i_p = min_dists_plain(x, y)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(NN_TIE_CASES))
def test_nn_kernel_first_index_wins_placed_ties_on_card(cuda_device, name):
    """K1 on equal minima in one load of four refs, in the next load, in the
    next group of eight, in neighbouring tiles and two tiles later: ``numpy.argmin``'s first
    index and its distance, bit for bit."""
    x, y = nn_tie_case(name)
    d, i = min_dists(torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(cuda_device))
    d_ref, i_ref = first_argmin(x, y)
    np.testing.assert_array_equal(i.cpu().numpy(), i_ref)
    np.testing.assert_array_equal(d.cpu().numpy(), d_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEGSUM_CASES)
def test_segsum_kernel_matches_plain_on_run_shapes_on_card(cuda_device, name):
    """K2 on run lengths around its one-thread / one-warp threshold (8
    entries) and its slabs (1024 entries), short runs that straddle a slab's
    end, a slab packed with 9-entry runs, rows with nothing to sum and
    unaligned stream lengths:
    within 1e-5 * (1 + Σ|v| of the segment) of the plain version, exactly 0
    where no entry lands, and bit-equal between two runs."""
    idx, vals, s = segsum_case(name)
    it, vt = torch.from_numpy(idx).to(cuda_device), torch.from_numpy(vals).to(cuda_device)
    out = segment_accumulate_sorted(it, vt, s)
    ref = segment_sum_plain(it, vt, s)
    scale = segment_sum_plain(it, vt.abs(), s)
    assert bool(((out - ref).abs() <= 1e-5 * (1 + scale)).all())
    assert not out[scale == 0].any()
    assert torch.equal(out, segment_accumulate_sorted(it, vt, s))


def _sorted_frames(x, y, device, pad_y=256):
    xs, _ = _sort_by_morton(torch.from_numpy(x).to(device))
    ys, _ = _sort_by_morton(torch.from_numpy(y).to(device))
    return _edge_pad_points(xs, 256).contiguous(), _edge_pad_points(ys, pad_y).contiguous()


@pytest.mark.cuda
def test_nn_cluster_kernel_matches_plain_on_card(cuda_device):
    """Kernel K3 against its plain version on the card: tolerance 0 on the
    distance and the index, on a selected table (S 64, T 16), with the refs
    folded by a modulo, and on duplicated chunks listed in an order that is
    not the index order (the table-order tie rule)."""
    rng = np.random.default_rng(0)
    launches = NN_CLUSTER.launches
    x, y = _clouds(rng, 4, 1000, 1100)
    xs, ys = _sorted_frames(x, y[:2], cuda_device)  # rows 2, 3 read refs 0, 1
    ids = select_chunks(xs, ys, 64, 16)
    d, i = nn_cluster(xs, ys, ids, 64)
    d_p, i_p = nn_cluster_plain(xs, ys, ids, 64)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)

    base = torch.from_numpy(rng.integers(-3, 4, size=(1, 5, 32, 3)).astype(np.float32))
    refs = base.repeat(1, 4, 1, 1).reshape(1, 20 * 32, 3).to(cuda_device)
    queries = torch.from_numpy(rng.integers(-3, 4, size=(2, 512, 3)).astype(np.float32)).to(cuda_device)
    table = torch.tensor([17, 2, 12, 7, 9, 4, 0], dtype=torch.int32, device=cuda_device)
    table = table.expand(2, 2, -1).contiguous()
    d, i = nn_cluster(queries, refs, table, 32)
    d_p, i_p = nn_cluster_plain(queries, refs, table, 32)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    assert NN_CLUSTER.launches == launches + 2  # a CUDA tensor went to the kernel
    with pytest.raises(TypeError):
        nn_cluster(xs.double(), ys.double(), ids, 64)
    with pytest.raises(ValueError):
        nn_cluster(xs[:, :100], ys, ids, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NN_CLUSTER_CASES)
def test_nn_cluster_kernel_matches_plain_on_table_cases_on_card(cuda_device, name):
    """K3 on chunk sizes that do and do not divide its groups of eight list
    positions and its loads of four, lists below, on and beyond a staging
    round, placed ties, a chunk listed twice, ids that name no chunk and
    folded ref rows: distance and index equal to the plain version and to
    the numpy scan, tolerance 0.  The plain version takes ids that name no
    chunk as one more chunk of +inf points."""
    case = nn_cluster_case(name)
    on_card = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    d, i = nn_cluster(on_card(case["xs"]), on_card(case["ys"]), on_card(case["ids"]), case["chunk"])
    d_p, i_p = nn_cluster_plain(
        on_card(case["xs"]), on_card(case.get("ys_valid", case["ys"])),
        on_card(case.get("ids_valid", case["ids"])), case["chunk"])
    assert torch.equal(d, d_p) and torch.equal(i, i_p)
    d_ref, i_ref = cluster_first_argmin(case["xs"], case["ys"], case["ids"], case["chunk"])
    np.testing.assert_array_equal(i.cpu().numpy(), i_ref)
    np.testing.assert_array_equal(d.cpu().numpy(), d_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SELECT_CASES)
def test_select_chunks_kernel_matches_plain_on_card(cuda_device, name):
    """The selection kernel against its plain version on the card, which
    start from the same chunk centres, radii and tile centroids: the table equal
    index for index, also where bounds and scores tie, where every chunk is
    a candidate, and where a query is NaN or infinite."""
    case = select_case(name)
    xs = torch.from_numpy(case["xs"]).to(cuda_device)
    ys = torch.from_numpy(case["ys"]).to(cuda_device)
    launches = SELECT_CHUNKS.launches
    ids = select_chunks(xs, ys, case["chunk"], case["chunks_per_tile"])
    assert SELECT_CHUNKS.launches == launches + 1  # a CUDA tensor went to the kernel
    ids_p = select_chunks_plain(xs, ys, case["chunk"], case["chunks_per_tile"])
    assert ids.dtype == torch.int32 and torch.equal(ids, ids_p)
    assert int(ids.min()) >= 0 and int(ids.max()) < ys.shape[1] // case["chunk"]
    with pytest.raises(TypeError):
        select_chunks(xs.double(), ys.double(), case["chunk"], case["chunks_per_tile"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", INTERPOLATE_CASES)
def test_interpolate_backward_on_card_is_one_segsum_launch(cuda_device, name):
    """The sampler's backward on the card: one launch of K2, and the vertex
    cotangent within 1e-5 * (1 + Σ|w g| into the vertex) of a float64 sum."""
    case = interpolate_case(name)
    on_card = lambda k: torch.from_numpy(case[k]).to(cuda_device)  # noqa: E731
    verts = on_card("verts").requires_grad_()
    out = _interpolate(verts, on_card("idx"), on_card("w"), on_card("faces"))
    launches = SEGSUM.launches
    (dv,) = torch.autograd.grad(out, verts, on_card("g"))
    assert SEGSUM.launches == launches + 1
    ref = interpolate_backward_float64(case)
    scale = interpolate_backward_float64(dict(case, w=np.abs(case["w"]), g=np.abs(case["g"])))
    assert (np.abs(dv.cpu().numpy() - ref) <= 1e-5 * (1 + scale)).all()


# (B, N) x M of the autoencoder's loss (48 folded clouds of 30k samples of
# the deformed mesh against the 6400 decoded points, both ways) and of one
# chunk of the environment's candidate scores (3 elements x 10 candidates
# x 3 repeats, 30k points against 30k)
SLICE_NN_SHAPES = ((48, 30000, 6400), (48, 6400, 30000), (90, 30000, 30000))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,m", SLICE_NN_SHAPES, ids=lambda v: str(v))
def test_nn_kernel_matches_plain_at_autoencoder_and_env_shapes_on_card(cuda_device, b, n, m):
    """K1 at the autoencoder's and the environment's shapes: tolerance 0 on
    distance and index."""
    g = torch.Generator(device=cuda_device).manual_seed(b + n + m)
    x = torch.randn(b, n, 3, device=cuda_device, generator=g)
    y = torch.randn(b, m, 3, device=cuda_device, generator=g) * 0.5
    d, i = min_dists(x, y)
    d_p, i_p = min_dists_plain(x, y)
    assert torch.equal(d, d_p) and torch.equal(i, i_p)


@pytest.mark.cuda
def test_segsum_kernel_matches_plain_on_the_autoencoder_stream_on_card(cuda_device):
    """K2 on the autoencoder backward's stream: the argmins of 48 x 30000
    samples into 6400 decoded points, sorted, into S = 6400 segments:
    within 1e-5 * (1 + Σ|v| of the segment) of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(48, 30000, 3, device=cuda_device, generator=g)
    y = torch.randn(48, 6400, 3, device=cuda_device, generator=g) * 0.5
    _, ix = min_dists(x, y)
    idx_s, perm = torch.sort(ix, dim=1, stable=True)
    vals = torch.randn(48, 30000, 3, device=cuda_device, generator=g) * 1e-4
    vals_s = torch.gather(vals, 1, perm[..., None].long().expand(-1, -1, 3)).contiguous()
    out = segment_accumulate_sorted(idx_s.contiguous(), vals_s, 6400)
    ref = segment_sum_plain(idx_s, vals_s, 6400)
    scale = segment_sum_plain(idx_s, vals_s.abs(), 6400)
    assert bool(((out - ref).abs() <= 1e-5 * (1 + scale)).all())
