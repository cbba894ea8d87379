"""Operation and byte counts against sums worked by hand from the v_t_g
shapes, and the bounds PERF.md's kernel table quotes for the same
launches."""

import json

import pytest

from benchmark.flops import vision
from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.harness import ROOT
from benchmark.reference.vision import encoder_plan, param_specs

CFG = json.loads((ROOT / "benchmark/configs/vtg.json").read_text())
MODEL = {**CFG["config"], "repeat": CFG["repeat"], **CFG["assumed"]}


def test_pyramid_plan_and_feature_width():
    specs, selected, channels = encoder_plan(6, 3, 5)
    assert len(specs) == 17 and selected == [9, 12, 15, 16]
    assert channels == [64, 128, 256, 512]
    assert vision.shapes(MODEL) == {"charts": 20, "verts": 2036, "faces": 2368, "features": 960}


def test_gcn_flops_by_hand():
    # layer 0: 960 -> 300, 18 hidden 300 -> 300 (99 aggregated columns), last 300 -> 3
    weight = 960 * 300 + 18 * 300 * 300 + 300 * 3
    for v in (1536, 2036):
        adjacency = v * v * (19 * 99 + 3)
        assert vision.gcn_flops(MODEL, v, 960) == 2.0 * (v * weight + adjacency)


def test_conv_flops_by_hand():
    # (out size, out channels, in channels) of the 17 layers of one pyramid
    layers = [(256, 3, 3), (128, 16, 3), (128, 16, 16), (128, 16, 16)]
    cin = 16
    for size, feats in ((64, 32), (32, 64), (16, 128), (8, 256)):
        layers += [(size, feats, cin), (size, feats, feats), (size, feats, feats)]
        cin = feats
    layers.append((4, 512, 256))
    assert vision.conv_flops(MODEL) == sum(2.0 * s * s * o * i * 25 for s, o, i in layers)


def test_search_bounds_match_the_quoted_ones():
    bounds = vision.kernel_bounds(MODEL, train=True)
    launches, k3 = bounds["nn_cluster"]
    # 48 x 30208 queries x 24 chunks x 128 points x 9 over 67 TFLOP/s: 0.598 ms a launch
    assert launches == 2 and k3 / 2 == pytest.approx(48 * 30208 * 3072 * 9 / 67e12)
    assert k3 / 2 * 1e3 == pytest.approx(0.598, abs=5e-4)
    # the selection: 5664 tiles x (10 x (8 x 236 + 257 x 72) + 3 x 256 x 72) operations, 0.0219 ms
    assert bounds["select_chunks"][1] / 2 * 1e3 == pytest.approx(0.0219, abs=2e-4)
    # K2: (48, 60000) -> 30000 and (48, 90000) -> 2368, 0.0189 + 0.0210 ms
    assert bounds["segsum_sorted"] == (2, pytest.approx((0.0189e-3 + 0.0210e-3), abs=2e-7))
    assert "segsum_sorted" not in vision.kernel_bounds(MODEL, train=False)


def test_least_step_time_parts():
    train, evaluation = vision.step_least_seconds(MODEL, True), vision.step_least_seconds(MODEL, False)
    assert train["gcn"] == pytest.approx(3 * 16 * sum(
        vision.gcn_flops(MODEL, v, 960) for v in (1536, 2036, 2036)) / PEAK_OPS["bf16"])
    assert train["conv"] == pytest.approx(3 * evaluation["conv"])
    assert evaluation["search"] == train["search"]
    assert evaluation["sampler"] == pytest.approx(16 * 90000 * 24 / PEAK_HBM_BYTES)
    assert train["total"] == pytest.approx(sum(v for k, v in train.items() if k != "total"))
    assert 5e-3 < train["total"] < 15e-3 and evaluation["total"] < train["total"]


def test_parameter_shapes():
    specs = {name: shape for name, shape, _, _ in param_specs(MODEL)}
    assert specs["gcn_1.layers.0.weight"] == (960, 300)
    assert specs["gcn_2.layers.19.weight"] == (300, 3)
    assert specs["positional.layers.0.weight"] == (240, 63)
    assert specs["global_encoder.convs.16.weight"] == (512, 256, 5, 5)
    assert specs["local_encoder.norms.15.running_var"] == (256,)
