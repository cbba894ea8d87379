"""The plain versions of K1 and K2 against the JAX package on the cases the
kernels' designs make risky (``active_3d_vision_and_touch_tpu_torch.testing``).

JAX runs on the CPU here, its Pallas kernels in interpret mode.  The same
cases go through the hand-written kernels on the card in
``test_torch_kernels.py`` (marked ``cuda``) and in ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.ops.chamfer import _min_dists_pallas
from active_3d_vision_and_touch_tpu.ops.segsum import (
    segment_accumulate_sorted as jax_segment_accumulate_sorted,
)
from active_3d_vision_and_touch_tpu_torch.ops import min_dists, segment_accumulate_sorted
from active_3d_vision_and_touch_tpu_torch.testing import (
    NN_SHAPES,
    NN_TIE_CASES,
    SEGSUM_CASES,
    first_argmin,
    nn_shape_case,
    nn_tie_case,
    segsum_case,
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
