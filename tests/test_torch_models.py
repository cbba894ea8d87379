"""The port's Deformation against the JAX package's on converted weights.

Small sizes: 3 GCN layers of width 32, 3 CNN blocks, 64x64 images, B = 2.
JAX and the port both run float32 on the CPU here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_3d_vision_and_touch_tpu.core import build_adj_info as jax_build_adj_info
from active_3d_vision_and_touch_tpu.core import vision_charts as jax_vision_charts
from active_3d_vision_and_touch_tpu.models import Deformation as JaxDeformation
from active_3d_vision_and_touch_tpu.models import TouchChartEncoder as JaxTouchChartEncoder
from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
from active_3d_vision_and_touch_tpu.models.vision import (
    chart_plane_features as jax_chart_plane_features,
)
from active_3d_vision_and_touch_tpu.models.vision import encoder_plan as jax_encoder_plan
from active_3d_vision_and_touch_tpu_torch.convert import (
    deformation_from_flax,
    touch_encoder_from_flax,
)
from active_3d_vision_and_touch_tpu_torch.core import build_adj_info, touch_chart, vision_charts
from active_3d_vision_and_touch_tpu_torch.models import (
    Deformation,
    GCNLayer,
    TouchChartEncoder,
    chart_plane_features,
    encoder_plan,
    prepare_charts,
)

SMALL = dict(num_gcn_layers=3, hidden_gcn_size=32, num_cnn_blocks=3)


def test_core_geometry_matches_jax():
    """The port's copies of the atlas and adjacency are bit-identical, at
    the flagship sizes V = 2036, Vv = 1536, F = 2368."""
    atlas, jatlas = vision_charts(), jax_vision_charts()
    np.testing.assert_array_equal(atlas.verts, jatlas.verts)
    np.testing.assert_array_equal(atlas.faces, jatlas.faces)
    info, jinfo = build_adj_info(atlas), jax_build_adj_info(jatlas)
    for name in ("original", "adj", "faces", "centers"):
        np.testing.assert_array_equal(getattr(info, name), getattr(jinfo, name))
    assert info.adj.shape == (2036, 2036) and info.original.shape == (1536, 1536)
    assert info.faces.shape == (2368, 3)
    dev = info.to("cpu")
    assert dev.adj.dtype == torch.float32 and dev.faces.dtype == torch.int64


@pytest.mark.parametrize("blocks,size", [(6, 256), (3, 64), (6, 64)])
def test_encoder_plan_matches_jax(blocks, size):
    assert encoder_plan(blocks, 3, 5, size) == jax_encoder_plan(blocks, 3, 5, size)


def _inputs(rng, b=2, use_touch=True):
    img = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    touch = (rng.normal(size=(b, 5, 4, 25, 4)) * 0.1).astype(np.float32)
    touch[..., 3] = rng.integers(0, 3, size=touch.shape[:-1])  # mask codes
    return img, touch


def _pair(rng, use_img=True, use_touch=True, touch=None, **flags):
    """A flax Deformation with random weights and the port's module holding
    the same weights, plus inputs for both.  ``flags`` are the
    ``touch_global``/``touch_plane`` switches; ``touch`` replaces the random
    touch charts."""
    atlas = vision_charts()
    info = build_adj_info(atlas, use_touch=use_touch)
    jmodel = JaxDeformation(use_img=use_img, use_touch=use_touch, **flags, **SMALL)
    img, random_touch = _inputs(rng)
    touch = random_touch if touch is None else touch
    b = img.shape[0]
    jcharts = jax_prepare_charts(
        jnp.asarray(touch), jnp.asarray(atlas.verts), b, use_touch=use_touch
    )
    jargs = (
        jnp.asarray(img) if use_img else None, jcharts,
        jnp.asarray(info.adj), jnp.asarray(info.original),
    )
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0), *jargs))
    model = Deformation(use_img=use_img, use_touch=use_touch, **flags, **SMALL)
    model.load_state_dict(
        deformation_from_flax(variables["params"], variables.get("batch_stats"))
    )
    charts = prepare_charts(
        torch.from_numpy(touch), torch.from_numpy(atlas.verts), b, use_touch=use_touch
    )
    dev = info.to("cpu")
    targs = (torch.from_numpy(img) if use_img else None, charts, dev.adj, dev.original)
    return jmodel, variables, jargs, model, targs


@pytest.mark.parametrize("use_img", [True, False])
def test_deformation_forward_matches_jax(rng, use_img):
    """Eval-mode verts to atol 1e-4 and the mask exactly, on converted
    weights (with and without the image pathway)."""
    jmodel, variables, jargs, model, targs = _pair(rng, use_img=use_img)
    verts_j, mask_j = jax.jit(jmodel.apply)(variables, *jargs)
    model.eval()
    with torch.no_grad():
        verts_t, mask_t = model(*targs)
    assert verts_t.shape == (2, 2036, 3)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts_j), atol=1e-4)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


def test_deformation_train_mode_batch_stats_match_flax(rng):
    """Train mode: verts to atol 1e-4 / rtol 1e-3, and the running
    statistics after one forward to 1e-5, with flax's update (momentum 0.99
    on the old value, biased batch variance).  The rtol is there because
    normalizing by batch statistics over as few as 2 x 8 x 8 values per
    channel scales the float32 rounding differences by 1/std."""
    jmodel, variables, jargs, model, targs = _pair(rng)
    (verts_j, _), updates = jax.jit(
        lambda v, *a: jmodel.apply(v, *a, train=True, mutable=["batch_stats"])
    )(variables, *jargs)
    model.train()
    with torch.no_grad():
        verts_t, _ = model(*targs)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts_j), atol=1e-4, rtol=1e-3)
    expected = deformation_from_flax({}, jax.device_get(updates["batch_stats"]))
    state = model.state_dict()
    assert expected and all("running_" in k for k in expected)
    for key, value in expected.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-5, err_msg=key)


def test_converter_consumes_every_leaf_once(rng):
    """Every flax leaf maps onto exactly one torch key and the state dict
    covers the whole module (strict load); unknown names raise."""
    _, variables, _, model, _ = _pair(rng)
    state = deformation_from_flax(variables["params"], variables["batch_stats"])
    n_leaves = len(jax.tree_util.tree_leaves(variables["params"])) + len(
        jax.tree_util.tree_leaves(variables["batch_stats"])
    )
    assert len(state) == n_leaves == len(model.state_dict())
    assert state["gcn_1.layers.0.weight"].shape == (115, 32)  # (in, out) kept
    assert state["positional.layers.0.weight"].shape == (28, 63)  # Dense → (out, in)
    assert state["global_encoder.convs.1.weight"].shape == (16, 3, 5, 5)  # OIHW
    with pytest.raises(KeyError):
        deformation_from_flax({"Mystery_0": {"kernel": np.zeros((2, 2))}})
    bad = jax.tree_util.tree_map(lambda x: x, variables["params"])
    bad["GCN_0"]["GCNLayer_0"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError):
        deformation_from_flax(bad)


def test_gcn_layer_cut_semantics_golden():
    """Only the first round(out*cut) features aggregate over the graph and
    receive the bias (the reference quirk)."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(1, 3, 4)).astype(np.float32))
    layer = GCNLayer(4, 6, cut=0.33, do_cut=True)
    w = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
    layer.load_state_dict({"weight": w, "bias": b})
    adj = torch.tensor([[0.5, 0.5, 0.0], [0.0, 1.0, 0.0], [0.2, 0.3, 0.5]])
    out = layer(feats, adj)
    f = feats @ w
    np.testing.assert_allclose(out[..., :2].detach(), (adj @ f[..., :2] + b[:2]).detach(), atol=1e-6)
    np.testing.assert_allclose(out[..., 2:].detach(), f[..., 2:].detach(), atol=1e-6)


def test_flag_gated_pathways_raise():
    """The ``touch_global``/``touch_plane`` pathways are ported: neither flag
    raises any longer, each adds exactly its own heads, and without touch
    input both are inert (as in the JAX model, which then builds no head)."""
    heads = {"touch_context", "plane_context", "plane_vertex"}
    for flags, expected in (
        ({}, set()),
        ({"touch_global": True}, {"touch_context"}),
        ({"touch_plane": True}, {"plane_context", "plane_vertex"}),
        ({"touch_global": True, "touch_plane": True}, heads),
        ({"touch_global": True, "touch_plane": True, "use_touch": False}, set()),
    ):
        model = Deformation(**flags, **SMALL)
        assert {n for n, _ in model.named_children()} & heads == expected


def _chart_cases(rng):
    """(B=2, 4 charts of 25 slots): contact charts, a contact chart whose
    slots are all zero (padding), a contact chart collapsed onto the x axis
    (degenerate: its tangents' cross product is exactly zero), and
    charts without contact."""
    t_pos = (rng.normal(size=(2, 100, 3)) * 0.1).astype(np.float32)
    t_pos[0, 25:50] = 0.0
    line = np.linspace(0, 1, 25, dtype=np.float32)[:, None] * np.array([[0.3, 0.0, 0.0]], np.float32)
    t_pos[1, :25] = line
    contact = np.zeros((2, 100, 1), np.float32)
    contact[0, :50] = 1.0
    contact[1, :25] = 1.0
    contact[1, 60] = 1.0  # one slot marks its whole chart
    return t_pos, contact


def test_chart_plane_features_match_jax(rng):
    """Features to atol 1e-5 and the contact indicator exactly, on contact,
    empty, zero-padded and degenerate charts; the gradient with respect to
    the chart vertices is finite everywhere (the double-where guard) and
    equals JAX's to atol 1e-4."""
    t_pos, contact = _chart_cases(rng)
    feats_j, has_j = jax_chart_plane_features(jnp.asarray(t_pos), jnp.asarray(contact))
    tp = torch.from_numpy(t_pos).requires_grad_()
    feats_t, has_t = chart_plane_features(tp, torch.from_numpy(contact))
    assert feats_t.shape == (2, 4, 8) and has_t.shape == (2, 4, 1)
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    np.testing.assert_allclose(feats_t.detach().numpy(), np.asarray(feats_j), atol=1e-5)
    assert has_t[:, :, 0].tolist() == [[1, 1, 0, 0], [1, 0, 1, 0]]
    assert not feats_t[0, 2:].any() and not feats_t[1, 1].any()  # no contact: zeroed
    # degenerate charts take the e3 normal: n n^T = diag(0, 0, 1)
    for chart in (feats_t[0, 1], feats_t[1, 0]):
        np.testing.assert_allclose(chart[:6].detach().numpy(), [0, 0, 0, 0, 0, 1], atol=1e-7)
    weights = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    (grad_t,) = torch.autograd.grad((feats_t * weights).sum(), tp)
    grad_j = jax.grad(
        lambda p: (jax_chart_plane_features(p, jnp.asarray(contact))[0] * weights.numpy()).sum()
    )(jnp.asarray(t_pos))
    assert bool(torch.isfinite(grad_t).all())
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), atol=1e-4)


@pytest.mark.parametrize(
    "touch_global,touch_plane,use_img",
    [(True, False, True), (False, True, True), (True, True, True), (True, True, False)],
)
def test_deformation_touch_pathways_match_jax(rng, touch_global, touch_plane, use_img):
    """Eval-mode verts to atol 1e-4 with the global touch context, the plane
    pathway, and both, on converted weights; without the image pathway the
    touch charts are fused from stage 1, so the per-vertex plane tail is
    added there too."""
    jmodel, variables, jargs, model, targs = _pair(
        rng, use_img=use_img, touch_global=touch_global, touch_plane=touch_plane
    )
    verts_j, mask_j = jax.jit(jmodel.apply)(variables, *jargs)
    model.eval()
    with torch.no_grad():
        verts_t, mask_t = model(*targs)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts_j), atol=1e-4)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    # the context reaches the output: without the heads' weights it differs
    with torch.no_grad():
        for name in ("touch_context", "plane_context", "plane_vertex"):
            if hasattr(model, name):
                getattr(model, name).weight.zero_()
                getattr(model, name).bias.zero_()
        verts_0, _ = model(*targs)
    assert float((verts_0 - verts_t).abs().max()) > 1e-4


def test_touch_pathways_all_empty_charts_are_finite(rng):
    """No slot in contact anywhere: the context is finite, equals JAX's, and
    every parameter's gradient is finite (the ``has`` guards keep the
    -1e9 / +1e9 fills out of the result)."""
    touch = (rng.normal(size=(2, 5, 4, 25, 4)) * 0.1).astype(np.float32)
    touch[..., 3] = rng.integers(0, 2, size=touch.shape[:-1])  # codes 0 and 1: no contact
    touch[1] = 0.0  # and one object with zero-padded charts only
    jmodel, variables, jargs, model, targs = _pair(
        rng, touch=touch, touch_global=True, touch_plane=True
    )
    verts_j, _ = jax.jit(jmodel.apply)(variables, *jargs)
    model.eval()
    verts_t, _ = model(*targs)
    np.testing.assert_allclose(verts_t.detach().numpy(), np.asarray(verts_j), atol=1e-4)
    verts_t.square().sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is None or bool(torch.isfinite(p.grad).all()), name
    assert bool(torch.isfinite(model.touch_context.weight.grad).all())


def test_converter_consumes_the_new_trees(rng):
    """Every flax leaf of a Deformation with both touch pathways, and of a
    TouchChartEncoder, maps onto exactly one torch key (strict load), with
    the layouts stated in ``convert.py``; unknown names raise."""
    _, variables, _, model, _ = _pair(rng, touch_global=True, touch_plane=True)
    state = deformation_from_flax(variables["params"], variables["batch_stats"])
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves == len(model.state_dict())
    fsize = model.feature_size
    assert state["touch_context.weight"].shape == (fsize, 2 * fsize + 13)
    assert state["plane_context.weight"].shape == (fsize, 16)
    assert state["plane_vertex.weight"].shape == (fsize, 8)
    with pytest.raises(KeyError):
        deformation_from_flax({"touch_context": {"scale": np.zeros(3)}})

    jmodel, tvars, _ = _touch_encoder_pair(rng)[:3]
    tstate = touch_encoder_from_flax(tvars["params"], tvars["batch_stats"])
    encoder = TouchChartEncoder()
    assert len(tstate) == len(jax.tree_util.tree_leaves(tvars)) == len(encoder.state_dict())
    encoder.load_state_dict(tstate)  # strict
    assert tstate["blocks.0.convs.0.weight"].shape == (16, 3, 5, 5)  # OIHW
    assert tstate["dense.0.weight"].shape == (256, 512)
    assert "blocks.5.norms.2.weight" not in tstate  # the last block ends on its conv
    bad = jax.tree_util.tree_map(lambda x: x, tvars["params"])
    bad["DoubleConv_0"]["Conv_0"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError):
        touch_encoder_from_flax(bad)
    with pytest.raises(KeyError):
        touch_encoder_from_flax({"Mystery_0": {"kernel": np.zeros((2, 2))}})


def _touch_encoder_pair(rng, b=3):
    """A flax TouchChartEncoder with random weights and non-trivial running
    statistics, the port's module holding the same, and inputs for both."""
    jmodel = JaxTouchChartEncoder()
    touch = rng.uniform(size=(b, 121, 121, 3)).astype(np.float32)
    pos = rng.normal(size=(b, 3)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(b, 3, 3)))[0].astype(np.float32)
    chart = touch_chart().verts
    jargs = tuple(jnp.asarray(a) for a in (touch, pos, rot, chart))
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(1), *jargs))
    stats = variables["batch_stats"]
    for block in stats.values():
        for norm in block.values():
            norm["mean"] = rng.normal(size=norm["mean"].shape).astype(np.float32) * 0.1
            norm["var"] = rng.uniform(0.5, 1.5, size=norm["var"].shape).astype(np.float32)
    model = TouchChartEncoder()
    model.load_state_dict(touch_encoder_from_flax(variables["params"], stats))
    targs = tuple(torch.from_numpy(a) for a in (touch, pos, rot, chart))
    return jmodel, variables, jargs, model, targs


def test_touch_chart_encoder_matches_flax(rng):
    """Eval mode: chart vertices to atol 1e-5 (121 → 61 → 31 → 16 → 8 → 4 →
    2, flattened in flax's (h, w, c) order).  Train mode: vertices to atol
    1e-4 / rtol 1e-3 (batch statistics over as few as 3 x 2 x 2 values
    scale the rounding differences by 1/std) and the running statistics
    after one forward to 1e-5."""
    jmodel, variables, jargs, model, targs = _touch_encoder_pair(rng)
    verts_j = jax.jit(jmodel.apply)(variables, *jargs)
    model.eval()
    with torch.no_grad():
        verts_t = model(*targs)
    assert verts_t.shape == (3, 25, 3)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts_j), atol=1e-5)

    verts_j, updates = jax.jit(
        lambda v, *a: jmodel.apply(v, *a, train=True, mutable=["batch_stats"])
    )(variables, *jargs)
    model.train()
    with torch.no_grad():
        verts_t = model(*targs)
    np.testing.assert_allclose(verts_t.numpy(), np.asarray(verts_j), atol=1e-4, rtol=1e-3)
    expected = touch_encoder_from_flax({}, jax.device_get(updates["batch_stats"]))
    state = model.state_dict()
    assert len(expected) == 2 * 17  # 6 blocks x 3 norms, less the last one
    for key, value in expected.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(), atol=1e-5, err_msg=key)
