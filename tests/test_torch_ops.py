"""The port's ops against the JAX package's, on the same numpy inputs.

JAX runs on the CPU here: its Pallas kernels in interpret mode, the rest as
XLA.  The port's ops run their plain versions, which the wrappers take for
CPU tensors.  ``test_torch_kernels.py`` holds the hand-written kernels
against those plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.core.camera import PinholeCamera as JaxCamera
from active_3d_vision_and_touch_tpu.ops import bilinear_sample as jax_bilinear
from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
from active_3d_vision_and_touch_tpu.ops import nerf_embedding as jax_nerf
from active_3d_vision_and_touch_tpu.ops.chamfer import _min_dists_pallas, _min_dists_xla
from active_3d_vision_and_touch_tpu.ops.sample import (
    _interpolate as jax_interpolate,
    _inverse_cdf_sorted as jax_inverse_cdf_sorted,
)
from active_3d_vision_and_touch_tpu.ops.segsum import scatter_add_3 as jax_scatter_add_3
from active_3d_vision_and_touch_tpu_torch.core import touch_chart, vision_charts
from active_3d_vision_and_touch_tpu_torch.core.camera import PinholeCamera
from active_3d_vision_and_touch_tpu_torch.ops import (
    batch_sample,
    bilinear_sample,
    chamfer_distance,
    mesh_chamfer_distance,
    min_dists,
    nerf_embedding,
    scatter_add_3,
    segment_accumulate_sorted,
)
from active_3d_vision_and_touch_tpu_torch.ops.sample import (
    _interpolate,
    _inverse_cdf_sorted,
    _sorted_uniforms,
    draw_sample_noise,
    face_areas,
)
from test_torch_kernels import _clouds, _segment_inputs, _with_ties


def test_min_dists_plain_matches_pallas_and_xla(rng):
    """K1's plain version against the Pallas kernel (interpret mode) and the
    XLA brute force: distances to rtol 1e-5, and the distance each index
    gives equal to the least one."""
    x, y = _clouds(rng)
    d_t, i_t = min_dists(torch.from_numpy(x), torch.from_numpy(y))
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    d_t, i_t = d_t.numpy(), i_t.numpy()
    for d_j, _ in (
        _min_dists_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True),
        _min_dists_xla(jnp.asarray(x), jnp.asarray(y)),
    ):
        np.testing.assert_allclose(d_t, np.asarray(d_j), rtol=1e-5, atol=1e-7)
    y_at = np.take_along_axis(y, i_t[..., None].astype(np.int64), axis=1)
    np.testing.assert_array_equal(((x - y_at) ** 2).sum(-1), d_t)


def test_min_dists_first_index_wins_ties(rng):
    """Exact ties: the plain version, the Pallas kernel and XLA all return
    the first index of the least distance."""
    x, y = _with_ties(rng)
    d_t, i_t = min_dists(torch.from_numpy(x), torch.from_numpy(y))
    full = ((x[:, :, None, :] - y[:, None, :, :]) ** 2).sum(-1)
    first = np.argmin(full, axis=-1)  # numpy: first occurrence
    np.testing.assert_array_equal(i_t.numpy(), first)
    d_p, i_p = _min_dists_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True)
    _, i_x = _min_dists_xla(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(np.asarray(i_p), first)
    np.testing.assert_array_equal(np.asarray(i_x), first)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_p))


def test_scatter_add_3_matches_jax(rng):
    """K2 through ``scatter_add_3`` against the JAX one (Pallas interpret
    mode): duplicates, empty segments and out-of-range ids, atol 1e-5."""
    idx, val, s = _segment_inputs(rng)
    ref = np.asarray(jax_scatter_add_3(jnp.asarray(idx), jnp.asarray(val), s))
    out = scatter_add_3(torch.from_numpy(idx), torch.from_numpy(val), s).numpy()
    assert out.shape == (3, s, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    assert not out[:, 11].any()  # the empty segment stays zero


def test_segment_accumulate_sorted_is_index_add_in_order(rng):
    """On sorted ids the plain segment sum adds each run in index order: it
    equals a sequential float32 loop bit for bit."""
    idx, val, s = _segment_inputs(rng, n=300, s=90)
    order = np.argsort(idx, axis=1, kind="stable")
    idx_s = np.take_along_axis(idx, order, 1)
    val_s = np.take_along_axis(val, order[..., None], 1)
    out = segment_accumulate_sorted(
        torch.from_numpy(idx_s), torch.from_numpy(val_s), s
    ).numpy()
    ref = np.zeros((3, s, 3), np.float32)
    for b in range(3):
        for i in range(300):
            if idx_s[b, i] < s:
                ref[b, idx_s[b, i]] += val_s[b, i]
    np.testing.assert_array_equal(out, ref)


def test_chamfer_value_and_grads_match_jax(rng):
    """Chamfer value to rtol 1e-5 and both gradients to rtol 1e-5 / atol
    1e-7 against the JAX custom-VJP chamfer."""
    x, y = _clouds(rng, b=2, n=300, m=450)
    g = rng.uniform(0.5, 2.0, size=(2,)).astype(np.float32)
    cd_j, vjp = jax.vjp(jax_chamfer, jnp.asarray(x), jnp.asarray(y))
    gx_j, gy_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    cd_t = chamfer_distance(xt, yt)
    gx_t, gy_t = torch.autograd.grad(cd_t, (xt, yt), torch.from_numpy(g))
    np.testing.assert_allclose(cd_t.detach().numpy(), np.asarray(cd_j), rtol=1e-5)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), rtol=1e-5, atol=1e-7)
    # the plain baseline is the same function
    cd_p = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y), plain=True)
    np.testing.assert_allclose(cd_p.numpy(), cd_t.detach().numpy(), rtol=1e-6)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("data", ["x", "y"])
def test_chamfer_backward_skips_the_scatter_of_a_data_cloud(rng, monkeypatch, plain, data):
    """With one cloud as data (no gradient), the backward makes one scatter,
    not two, and the other cloud's gradient is bit for bit the one it gets
    when both clouds need theirs."""
    import active_3d_vision_and_touch_tpu_torch.ops.chamfer as chamfer_module

    x, y = _clouds(rng, b=2, n=300, m=450)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, size=(2,)).astype(np.float32))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    both = dict(zip("xy", torch.autograd.grad(chamfer_distance(xt, yt, plain=plain), (xt, yt), g)))
    calls = []
    name = "segment_sum_plain" if plain else "scatter_add_3"
    scatter = getattr(chamfer_module, name)
    monkeypatch.setattr(chamfer_module, name, lambda *a: calls.append(1) or scatter(*a))
    clouds = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    learned = "y" if data == "x" else "x"
    clouds[learned].requires_grad_()
    (grad,) = torch.autograd.grad(chamfer_distance(clouds["x"], clouds["y"], plain=plain),
                                  clouds[learned], g)
    assert len(calls) == 1
    assert torch.equal(grad, both[learned])


def test_interpolate_forward_and_backward_match_jax(rng):
    """The sorted-prefix custom backward against JAX's on the same idx/w:
    points and both cotangents to atol 1e-5."""
    b, v, f, n = 2, 40, 60, 500
    verts = rng.normal(size=(b, v, 3)).astype(np.float32)
    faces = rng.integers(0, v, size=(f, 3)).astype(np.int32)
    idx = np.sort(rng.integers(0, f, size=(b, n)), axis=1).astype(np.int64)
    w = rng.uniform(size=(b, n, 3)).astype(np.float32)
    g = rng.normal(size=(b, n, 3)).astype(np.float32)

    fj = jnp.asarray(faces)
    out_j, vjp = jax.vjp(
        lambda vv, ww: jax_interpolate(vv, jnp.asarray(idx, jnp.int32), ww, fj),
        jnp.asarray(verts), jnp.asarray(w),
    )
    dv_j, dw_j = vjp(jnp.asarray(g))

    vt = torch.from_numpy(verts).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out_t = _interpolate(vt, torch.from_numpy(idx), wt, torch.from_numpy(faces).long())
    dv_t, dw_t = torch.autograd.grad(out_t, (vt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(dv_t.numpy(), np.asarray(dv_j), atol=1e-5)
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), atol=1e-5)


def test_inverse_cdf_sorted_matches_jax_exactly(rng):
    b, f, n = 3, 60, 2000
    probs = rng.uniform(0.1, 1.0, size=(b, f)).astype(np.float32)
    cdf = np.cumsum(probs / probs.sum(1, keepdims=True), axis=1).astype(np.float32)
    u = np.sort(rng.uniform(size=(b, n)), axis=1).astype(np.float32)
    u[:, 5] = cdf[:, 3]  # a query exactly on a boundary counts the face
    u = np.sort(u, axis=1)
    ref = np.asarray(jax_inverse_cdf_sorted(jnp.asarray(cdf), jnp.asarray(u)))
    out = _inverse_cdf_sorted(torch.from_numpy(cdf), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, (u[:, :, None] >= cdf[:, None, :]).sum(-1))


def test_sorted_uniforms_are_sorted_order_statistics(rng):
    e = -np.log1p(-rng.uniform(size=(2, 4001))).astype(np.float32)
    u = _sorted_uniforms(torch.from_numpy(e)).numpy()
    assert u.shape == (2, 4000)
    assert (np.diff(u, axis=1) >= 0).all() and 0 < u.min() and u.max() < 1
    c = np.cumsum(e.astype(np.float64), axis=1)
    np.testing.assert_allclose(u, c[:, :-1] / c[:, -1:], rtol=1e-6)
    # uniform order statistics: the empirical CDF hugs the diagonal
    ks = np.abs(u - (np.arange(1, 4001) / 4001.0)).max()
    assert ks < 0.03


def test_batch_sample_area_weighting():
    """Two triangles, one 100x larger: ~99% of the samples land on it."""
    verts = torch.tensor(
        [[[0, 0, 0], [1, 0, 0], [0, 1, 0], [10, 10, 0], [20, 10, 0], [10, 20, 0]]],
        dtype=torch.float32,
    )
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]])
    pts = batch_sample(verts, faces, 4000, generator=torch.Generator().manual_seed(1))
    frac_big = float((pts[0, :, 0] > 5).float().mean())
    assert 0.97 < frac_big < 1.0


def test_batch_sample_face_histogram_follows_areas():
    """On the atlas, per-face sample counts agree with the face areas within
    5 standard deviations of the multinomial, and every point lies on the
    convex hull of its sphere (radius <= 0.25)."""
    atlas = vision_charts()
    verts = torch.from_numpy(atlas.verts)[None]
    faces = torch.from_numpy(atlas.faces).long()
    num = 60000
    e, u, v = draw_sample_noise(1, num, torch.Generator().manual_seed(3))
    from active_3d_vision_and_touch_tpu_torch.ops.sample import sample_faces

    idx = sample_faces(verts, faces, e)[0]
    counts = torch.bincount(idx, minlength=faces.shape[0]).double()
    p = face_areas(verts, faces)[0].double()
    p = p / p.sum()
    z = (counts - num * p) / torch.sqrt(num * p * (1 - p))
    assert float(z.abs().max()) < 5.0
    pts = batch_sample(verts, faces, 2000, generator=torch.Generator().manual_seed(4))
    assert float(pts.norm(dim=-1).max()) <= 0.25 + 1e-6


def test_batch_sample_degenerate_mesh_falls_back_to_uniform():
    verts = torch.zeros(1, 4, 3)
    faces = torch.tensor([[0, 1, 2], [1, 2, 3]])
    pts = batch_sample(verts, faces, 100, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(pts).all() and float(pts.abs().max()) == 0.0


def test_mesh_chamfer_distance_runs_and_is_seeded(rng):
    chart = touch_chart()
    verts = torch.from_numpy(chart.verts)[None]
    faces = torch.from_numpy(chart.faces).long()
    gt = torch.from_numpy(rng.normal(size=(1, 100, 3)).astype(np.float32)) * 0.01
    a = mesh_chamfer_distance(verts, faces, gt, torch.Generator().manual_seed(42), num=200)
    b = mesh_chamfer_distance(verts, faces, gt, torch.Generator().manual_seed(42), num=200)
    c = mesh_chamfer_distance(verts, faces, gt, torch.Generator().manual_seed(43), num=200)
    assert a.shape == (1,) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the clustered search is exhaustive at this size: the exact value
    d = mesh_chamfer_distance(
        verts, faces, gt, torch.Generator().manual_seed(42), num=200, nn="clustered"
    )
    np.testing.assert_allclose(d.numpy(), a.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="clustered"):
        mesh_chamfer_distance(verts, faces, gt, num=10, nn="pruned")


def test_mesh_chamfer_folds_repeats_like_jax(rng):
    """With the same draws, the repeat fold (split on the point axis, then
    concatenate on the batch axis) gives JAX's value."""
    from active_3d_vision_and_touch_tpu.ops.sample import (
        _interpolate as ji,
        face_areas as jfa,
    )

    atlas = vision_charts()
    b, num, rep = 2, 64, 3
    verts = (atlas.verts[None] * rng.uniform(0.8, 1.2, size=(b, 1, 3))).astype(np.float32)
    gt = (rng.normal(size=(b, 90, 3)) * 0.1).astype(np.float32)
    e, u, v = (t.numpy() for t in draw_sample_noise(b, num * rep, torch.Generator().manual_seed(5)))
    faces = torch.from_numpy(atlas.faces).long()
    cd_t = mesh_chamfer_distance(
        torch.from_numpy(verts), faces, torch.from_numpy(gt), num=num, repeat=rep,
        draws=tuple(torch.from_numpy(a) for a in (e, u, v)),
    ).numpy()

    areas = np.asarray(jfa(jnp.asarray(verts), jnp.asarray(atlas.faces)))
    cdf = np.cumsum((areas / areas.sum(1, keepdims=True)).astype(np.float64), 1).astype(np.float32)
    c = np.cumsum(e.astype(np.float64), axis=1).astype(np.float32)
    idx = jax_inverse_cdf_sorted(jnp.asarray(cdf), jnp.asarray(c[:, :-1] / c[:, -1:]))
    su = np.sqrt(u)
    w = np.concatenate([1.0 - su, su * (1.0 - v), su * v], axis=-1)
    pts = ji(jnp.asarray(verts), idx, jnp.asarray(w), jnp.asarray(atlas.faces))
    preds = jnp.concatenate(jnp.split(pts, rep, axis=1))
    cd_j = jax_chamfer(preds, jnp.tile(jnp.asarray(gt), (rep, 1, 1))).reshape(rep, b).mean(0)
    np.testing.assert_allclose(cd_t, np.asarray(cd_j), rtol=1e-4)


def test_nerf_embedding_matches_jax(rng):
    pts = rng.uniform(-0.3, 0.3, size=(2, 17, 3)).astype(np.float32)
    out = nerf_embedding(torch.from_numpy(pts)).numpy()
    assert out.shape == (2, 17, 63)
    np.testing.assert_allclose(out, np.asarray(jax_nerf(jnp.asarray(pts))), atol=2e-6)
    np.testing.assert_array_equal(out[..., -3:], pts)


def test_bilinear_sample_matches_jax(rng):
    feat = rng.normal(size=(2, 7, 9, 5)).astype(np.float32)  # NHWC
    grid = rng.uniform(-1.3, 1.3, size=(2, 11, 2)).astype(np.float32)
    out = bilinear_sample(torch.from_numpy(feat), torch.from_numpy(grid)).numpy()
    ref = np.asarray(jax_bilinear(jnp.asarray(feat), jnp.asarray(grid)))
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_camera_matches_jax(rng):
    pts = rng.uniform(-0.25, 0.25, size=(3, 50, 3)).astype(np.float32)
    pts[0, 0] = JaxCamera().position  # z == 0 guard
    cam, jcam = PinholeCamera(), JaxCamera()
    np.testing.assert_array_equal(cam.matrix, jcam.matrix)
    grid = cam.normalized_grid(torch.from_numpy(pts)).numpy()
    ref = np.asarray(jcam.normalized_grid(jnp.asarray(pts), xp=jnp))
    np.testing.assert_allclose(grid, ref, rtol=1e-5, atol=1e-4)
