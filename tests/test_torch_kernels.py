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
)
from active_3d_vision_and_touch_tpu_torch.ops.segsum import segment_sum_plain


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
    assert [k.name for k in KERNELS] == ["nn_exact", "segsum_sorted", "nn_cluster"]
    for k in KERNELS:
        assert k.source.exists()
    before = [k.launches for k in KERNELS]
    x, y = _clouds(rng, b=1, n=20, m=30)
    _, i = min_dists(torch.from_numpy(x), torch.from_numpy(y))
    scatter_add_3(i, torch.ones(1, 20, 3), 30)
    nn_cluster(torch.zeros(1, 256, 3), torch.ones(1, 8, 3), torch.zeros(1, 1, 2, dtype=torch.int32), 4)
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
