"""The port's viz and profiler utilities, ``VisionEngine.evaluate_detailed``,
the benchmark and the command line, against the JAX package's.

Images are decoded with PIL (the tests' reader; the port does not use it)
and compared pixel for pixel; the action histogram, drawn in numpy by
the port and by matplotlib in the JAX package, is compared with
``np.bincount``.  ``evaluate_detailed`` runs both engines on a 2-layer,
16-wide ``Deformation`` with the same weights and the same sampler draws,
JAX's fed through its own ``mesh_chamfer_distance``'s place.  The command
lines run in this process on a 2-object dataset that both packages'
``generate-data`` write.
"""

from __future__ import annotations

import argparse
import filecmp
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from active_3d_vision_and_touch_tpu_torch import bench, cli
from active_3d_vision_and_touch_tpu_torch.convert import deformation_from_flax
from active_3d_vision_and_touch_tpu_torch.core import touch_chart, vision_charts
from active_3d_vision_and_touch_tpu_torch.core.config import VisionConfig
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine
from active_3d_vision_and_touch_tpu_torch.utils import profiler, viz


def _png(path) -> np.ndarray:
    with Image.open(path) as img:
        assert img.format == "PNG"
        return np.asarray(img.convert("RGB"))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small torch ops beside other test processes: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- viz --------------------------------------------------------------------------

@pytest.mark.parametrize("use_img", [False, True])
def test_visualize_actions_matches_jax(tmp_path, use_img):
    """The sphere-coverage map equals the JAX package's pixel for pixel,
    with and without the camera-visible hemisphere; the histogram is a PNG
    of one bar per action."""
    from active_3d_vision_and_touch_tpu.utils import viz as jax_viz

    actions = np.random.default_rng(0).integers(0, 50, size=60)
    viz.visualize_actions(str(tmp_path / "ours"), actions, 50, use_img=use_img)
    jax_viz.visualize_actions(str(tmp_path / "theirs"), actions, 50, use_img=use_img)
    np.testing.assert_array_equal(_png(tmp_path / "ours" / "sphere_projection.png"),
                                  _png(tmp_path / "theirs" / "sphere_projection.png"))
    hist = _png(tmp_path / "ours" / "histogram.png")
    assert hist.shape == (viz._HIST_PLOT_H + 2 * viz._HIST_MARGIN,
                          50 * viz._HIST_BAR + 2 * viz._HIST_MARGIN, 3)
    np.testing.assert_array_equal(viz.camera_visible_actions(50),
                                  jax_viz.camera_visible_actions(50))


@pytest.mark.parametrize("num_actions", [8, 50])
def test_histogram_bars_are_bincount(tmp_path, num_actions):
    """Each bar's height in pixels is its ``np.bincount`` count scaled so
    the tallest bar is the plot's height, rounded; an action never taken
    has no bar."""
    actions = np.random.default_rng(num_actions).integers(0, num_actions, size=40)
    viz.visualize_actions(str(tmp_path), actions, num_actions)
    img = _png(tmp_path / "histogram.png")
    counts = np.bincount(actions, minlength=num_actions)
    m, bar = viz._HIST_MARGIN, viz._HIST_BAR
    for a, count in enumerate(counts):
        column = img[:, m + a * bar + bar // 2]
        height = int(np.all(column == viz._HIST_COLOUR, axis=-1).sum())
        assert height == round(count * viz._HIST_PLOT_H / counts.max()), a


def test_renders_match_jax(tmp_path):
    """``render_mesh_image``, ``render_points_image`` (framed and fitted),
    ``debug_projection_overlay`` (array and file) and ``visualize_depth``
    equal the JAX package's."""
    from active_3d_vision_and_touch_tpu.utils import viz as jax_viz

    atlas = vision_charts()
    verts = atlas.verts * np.array([1.0, 1.3, 0.8], np.float32)
    np.testing.assert_array_equal(viz.render_mesh_image(verts, atlas.faces),
                                  jax_viz.render_mesh_image(verts, atlas.faces))
    np.testing.assert_array_equal(viz.render_mesh_image(verts * 3, atlas.faces, fit=True),
                                  jax_viz.render_mesh_image(verts * 3, atlas.faces, fit=True))
    points = (np.random.default_rng(1).normal(size=(2000, 3)) * 0.2).astype(np.float32)
    for fit in (False, True):
        np.testing.assert_array_equal(viz.render_points_image(points, fit=fit),
                                      jax_viz.render_points_image(points, fit=fit))
    img = viz.render_mesh_image(atlas.verts, atlas.faces)
    ours = viz.debug_projection_overlay(img, atlas.verts, str(tmp_path / "ours.png"))
    theirs = jax_viz.debug_projection_overlay(img, atlas.verts, str(tmp_path / "theirs.png"))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(_png(tmp_path / "ours.png"), _png(tmp_path / "theirs.png"))
    floats = img.astype(np.float32) / 255.0
    np.testing.assert_array_equal(viz.debug_projection_overlay(floats, atlas.verts),
                                  jax_viz.debug_projection_overlay(floats, atlas.verts))
    depth = np.random.default_rng(2).uniform(0, 0.04, size=(9, 11))
    np.testing.assert_array_equal(viz.visualize_depth(depth), jax_viz.visualize_depth(depth))


def test_visualize_prediction_matches_jax(tmp_path):
    """Each object's ``prediction.png`` and ``ground_truth_points.png``
    equal the JAX package's pixel for pixel, in directories named alike."""
    from active_3d_vision_and_touch_tpu.utils import viz as jax_viz

    atlas, chart = vision_charts(), touch_chart()
    rng = np.random.default_rng(3)
    meshes = np.stack([atlas.verts * 1.2, atlas.verts * 2.5]).astype(np.float32)
    gt = (rng.normal(size=(2, 3000, 3)) * 0.15).astype(np.float32)
    names = ["objects/000001", "objects/000002/"]
    ours = viz.visualize_prediction(str(tmp_path / "ours"), meshes, atlas.faces, names, gt)
    theirs = jax_viz.visualize_prediction(str(tmp_path / "theirs"), meshes, atlas.faces, names, gt)
    assert [os.path.basename(d) for d in ours] == [os.path.basename(d) for d in theirs]
    for a, b in zip(ours, theirs):
        for name in ("prediction.png", "ground_truth_points.png"):
            np.testing.assert_array_equal(_png(os.path.join(a, name)), _png(os.path.join(b, name)))
    only = viz.visualize_prediction(str(tmp_path / "mesh"), chart.verts[None] * 10,
                                    chart.faces, ["x"])
    assert sorted(os.listdir(only[0])) == ["prediction.png"]


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 13, 3), (256, 256, 3)])
def test_png_encoder_round_trips_through_pil(tmp_path, shape):
    """``write_png`` gives an 8-bit RGB PNG that PIL decodes to the same
    pixels; floats are cast as ``astype(np.uint8)``; other shapes raise."""
    img = np.random.default_rng(4).integers(0, 256, size=shape).astype(np.uint8)
    viz.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(_png(tmp_path / "a.png"), img)
    data = viz.encode_png(img.astype(np.float64) + 0.7)
    assert data.startswith(viz.PNG_SIGNATURE)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    with pytest.raises(ValueError, match="expected an"):
        viz.encode_png(img[..., 0])


# -- profiler -----------------------------------------------------------------------

def test_step_timer_matches_jax(monkeypatch):
    """On the same clock readings both timers skip the warm-up steps and
    give the same statistics."""
    from active_3d_vision_and_touch_tpu.utils import profiler as jax_profiler

    stats = []
    for module in (profiler, jax_profiler):
        clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.125, 3.0, 3.5, 4.0, 4.0625])
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        timer = module.StepTimer(warmup=1)
        assert timer.stats() == {"steps": 0}
        for _ in range(5):
            with timer:
                pass
        stats.append(timer.stats())
    assert stats[0] == stats[1] and stats[0]["steps"] == 4


def test_trace_is_a_noop_without_a_directory_and_writes_one_with(tmp_path, monkeypatch):
    """Without a directory or ``A3VT_PROFILE_DIR`` nothing is traced or
    written, and the program's spans record nothing; with either, a Chrome
    trace of the block, its program spans included, lands in
    ``<dir>/<name>/trace.json``, and the recorder's snapshot, spans and
    counters, beside it in ``snapshot.json``."""
    monkeypatch.delenv(profiler.PROFILE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    profiler.reset()
    with profiler.trace("off") as prof, profiler.span("test.off"):
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []
    assert profiler.records() == []
    with profiler.trace("by_arg", str(tmp_path / "traces")) as prof, profiler.span("test.block"):
        torch.ones(64, 64) @ torch.ones(64, 64)
        profiler.count("test.counter", 3)
    assert prof is not None
    with open(tmp_path / "traces" / "by_arg" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert [e["ph"] for e in events if e.get("name") == "test.block"] == ["X"]
    assert [r.name for r in profiler.records()] == ["test.block"]
    with open(tmp_path / "traces" / "by_arg" / "snapshot.json") as f:
        written = json.load(f)
    assert written["spans"]["test.block"]["count"] == 1
    assert written["counters"] == {"test.counter": 3}
    assert set(written["launches"]) == {"nn_exact", "segsum_sorted", "nn_cluster", "select_chunks"}
    profiler.reset()
    monkeypatch.setenv(profiler.PROFILE_ENV, str(tmp_path / "env"))
    with profiler.trace("by_env"):
        torch.ones(3).sum()
    assert os.path.exists(tmp_path / "env" / "by_env" / "trace.json")


# -- evaluate_detailed ----------------------------------------------------------------

SMALL = dict(
    use_img=True, use_touch=True, finger=False, num_grasps=2, batch_size=2,
    number_points=64, num_gcn_layers=2, hidden_gcn_size=16, num_cnn_blocks=3,
    layers_per_block=1, eval=True,
)


def _detail_batches(rng, n=2):
    out = []
    for i in range(n):
        touch = (rng.normal(size=(2, 2, 4, 25, 4)) * 0.1).astype(np.float32)
        touch[..., 3] = rng.integers(0, 3, size=touch.shape[:-1])
        out.append({
            "names": [(f"objects/{2 * i:06d}", (1, 4)), (f"objects/{2 * i + 1:06d}", ())],
            "img": rng.uniform(size=(2, 64, 64, 3)).astype(np.float32),
            "gt_points": (rng.normal(size=(2, 64, 3)) * 0.1).astype(np.float32),
            "touch_charts": touch,
        })
    return out


def test_evaluate_detailed_matches_jax(tmp_path, monkeypatch):
    """Per-object Chamfer distances equal JAX's ``evaluate_detailed`` to
    rtol 1e-4 (eval mode, the exact search, batch i drawn as
    ``step_generator(i)`` draws it), with the same names and mean; with
    ``visualize_dir`` the first 3 objects are rendered (the gt clouds'
    images equal JAX's)."""
    import jax
    import jax.numpy as jnp
    from test_torch_autoencoder import _jax_sample, _sampler_inputs, random_variables

    import active_3d_vision_and_touch_tpu.ops as jax_ops
    from active_3d_vision_and_touch_tpu.core.config import VisionConfig as JaxVisionConfig
    from active_3d_vision_and_touch_tpu.models import prepare_charts as jax_prepare_charts
    from active_3d_vision_and_touch_tpu.ops import chamfer_distance as jax_chamfer
    from active_3d_vision_and_touch_tpu.train.vision import VisionEngine as JaxVisionEngine

    rng = np.random.default_rng(5)
    batches = _detail_batches(rng)
    cfg = dict(SMALL, experiments_root=str(tmp_path / "exp"))
    jengine = JaxVisionEngine(JaxVisionConfig(**cfg), log=False)
    charts = jax_prepare_charts(jnp.asarray(batches[0]["touch_charts"]), jengine.initial_mesh, 2)
    variables = random_variables(jengine.model, rng, jnp.asarray(batches[0]["img"]), charts,
                                 jengine.adj, jengine.original_adj)
    jengine.state = {"params": variables["params"], "batch_stats": variables["batch_stats"]}

    engine = VisionEngine(VisionConfig(**cfg), device="cpu", log=False)
    engine.model.load_state_dict(deformation_from_flax(variables["params"],
                                                       variables["batch_stats"]))
    num = SMALL["number_points"]
    draws = [draw_sample_noise(2, 3 * num, engine.step_generator(i)) for i in range(2)]
    u_face, w = (np.stack(a) for a in zip(*(_sampler_inputs(d) for d in draws)))

    # JAX's engine draws from a key; here its step key is the batch index,
    # and its mesh_chamfer_distance samples that batch's port draws
    monkeypatch.setattr(jengine, "_step_key", lambda i: jnp.asarray(i, jnp.int32))

    def mesh_cd(verts, faces, gt_points, key, num):
        preds = _jax_sample(verts, faces, jnp.asarray(u_face)[key], jnp.asarray(w)[key])
        cd = jax_chamfer(preds, jnp.tile(gt_points, (3, 1, 1)))
        return jnp.mean(cd.reshape(3, -1), axis=0)

    monkeypatch.setattr(jax_ops, "mesh_chamfer_distance", mesh_cd)
    mean_j, per_j = jengine.evaluate_detailed(batches, str(tmp_path / "jax_viz"), 3)
    mean_t, per_t = engine.evaluate_detailed(batches, str(tmp_path / "viz"), 3)

    assert [p["name"] for p in per_t] == [p["name"] for p in per_j] == [
        f"objects/{i:06d}" for i in range(4)]
    np.testing.assert_allclose([p["cd"] for p in per_t], [p["cd"] for p in per_j], rtol=1e-4)
    np.testing.assert_allclose(mean_t, mean_j, rtol=1e-4)
    assert sorted(os.listdir(tmp_path / "viz")) == sorted(os.listdir(tmp_path / "jax_viz")) == [
        f"{i:06d}" for i in range(3)]
    for name in sorted(os.listdir(tmp_path / "viz")):
        assert _png(tmp_path / "viz" / name / "prediction.png").shape == (256, 256, 3)
        np.testing.assert_array_equal(
            _png(tmp_path / "viz" / name / "ground_truth_points.png"),
            _png(tmp_path / "jax_viz" / name / "ground_truth_points.png"))
    assert jax.devices()  # JAX ran on the CPU devices of this process


# -- bench --------------------------------------------------------------------------

def test_bench_reports_the_root_benchmarks_keys(monkeypatch, capsys):
    """The port's benchmark runs the root benchmark's workload (v_t_g,
    batch 16, 30k points, eval config) at the default ``loss_nn`` against
    ``"xla"``, with its step and window counts, and prints one JSON line
    with the root benchmark's keys and metric name beside the card."""
    calls = []
    monkeypatch.setattr(bench, "measure_steps_per_sec",
                        lambda loss_nn, steps, windows: calls.append((loss_nn, steps, windows))
                        or (4.0 if loss_nn == "clustered" else 0.5))
    monkeypatch.setattr(bench, "card", lambda: "a card, 700.00 W")
    bench.main()
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [("clustered", 40, 5), ("xla", 6, 3)]
    assert payload["metric"] == "vision_touch_train_steps_per_sec_bs16"
    assert payload["value"] == 4.0 and payload["vs_baseline"] == 8.0
    assert set(payload) >= {"metric", "value", "unit", "vs_baseline", "baseline",
                            "xla_baseline_steps_per_sec", "loss_nn", "card"}
    cfg = bench.bench_config("clustered")
    assert (cfg.use_img, cfg.use_touch, cfg.finger, cfg.batch_size, cfg.number_points,
            cfg.eval) == (True, True, False, 16, 30000, True)
    batch = bench.bench_batch(cfg)
    assert {k: v.shape for k, v in batch.items()} == {
        "img": (16, 256, 256, 3), "gt_points": (16, 30000, 3), "touch_charts": (16, 5, 4, 25, 4)}


# -- the command line -------------------------------------------------------------------

def _jax_parser():
    """The JAX CLI's parser, as its ``main`` builds it."""
    from active_3d_vision_and_touch_tpu import cli as jax_cli

    class Built(Exception):
        pass

    built = {}

    def grab(self, *args, **kwargs):
        built["parser"] = self
        raise Built

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        jax_cli.main([])
    except Built:
        pass
    finally:
        argparse.ArgumentParser.parse_args = original
    return built["parser"]


def _options(parser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {(a.dest, tuple(a.option_strings), a.default, type(a).__name__)
               for a in p._actions if a.dest != "help"}
        for name, p in sub.choices.items()
    }


def test_cli_subcommands_and_options_match_jax():
    """The same seven subcommands; each has the JAX parser's options with
    their defaults, plus ``--device`` (default ``cuda``) on those that
    build an engine; ``policy`` lacks ``--result-tag``, which the port's
    ``PolicyConfig`` does not have, and ``train-auto``'s ``--loss-nn``
    defaults to ``exact`` (the clustered loss trains no autoencoder)."""
    ours, theirs = _options(cli.build_parser()), _options(_jax_parser())
    assert sorted(ours) == sorted(theirs) == sorted([
        "generate-data", "train-touch", "train-vision", "make-touch-charts", "train-auto",
        "policy", "bench"])
    device = ("device", ("--device",), "cuda", "_StoreAction")
    for name in theirs:
        expected = set(theirs[name])
        if name == "policy":
            expected.remove(("result_tag", ("--result-tag",), "eval", "_StoreAction"))
        if name == "train-auto":
            expected.remove(("loss_nn", ("--loss-nn",), "clustered", "_StoreAction"))
            expected.add(("loss_nn", ("--loss-nn",), "exact", "_StoreAction"))
        if name not in ("generate-data", "bench"):
            expected.add(device)
        assert ours[name] == expected, name


def test_cli_generate_data_writes_the_jax_cli_files(tmp_path, capsys):
    """``generate-data`` of 2 objects and 2 actions through both command
    lines: the same split summary and byte-equal files."""
    from active_3d_vision_and_touch_tpu import cli as jax_cli

    argv = ["generate-data", "--objects", "2", "--actions", "2"]
    assert jax_cli.main(argv + ["--root", str(tmp_path / "theirs")]) == 0
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli.main(argv + ["--root", str(tmp_path / "ours")]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == theirs
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "theirs")
                   for d, _, fs in os.walk(tmp_path / "theirs") for f in fs)
    ours = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ours")
                  for d, _, fs in os.walk(tmp_path / "ours") for f in fs)
    assert ours == files and len(files) > 10
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "ours", tmp_path / "theirs", files,
                                           shallow=False)
    assert mismatch == [] and errors == []


def test_cli_trains_touch_on_the_cpu_and_makes_charts(tmp_path, capsys):
    """``train-touch --device cpu --epochs 1`` on a generated 2-object
    dataset writes its config, checkpoints and metrics; ``make-touch-charts``
    from that checkpoint writes each object's chart cache; an engine
    subcommand without ``--device`` asks for the card."""
    root, exp = str(tmp_path / "data"), str(tmp_path / "exp")
    assert cli.main(["generate-data", "--root", root, "--objects", "2", "--actions", "2"]) == 0
    assert cli.main(["train-touch", "--root", root, "--device", "cpu", "--epochs", "1",
                     "--batch-size", "2", "--num-samples", "100", "--experiments-root", exp,
                     "--exp-id", "cli"]) == 0
    assert "best loss:" in capsys.readouterr().out
    ckpt = os.path.join(exp, "checkpoint", "test", "cli")
    for name in ("config.json", "best.pt", "recent.pt", "state.json"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    with open(os.path.join(exp, "tensorboard", "test", "cli.metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"]: json.loads(line)["value"] for line in f}
    assert np.isfinite(tags["train_touch_cd"]) and tags["train_touch_cd"] > 0
    assert cli.main(["make-touch-charts", "--root", root, "--touch-location", ckpt,
                     "--num-actions", "2", "--device", "cpu"]) == 0
    for name in ("000000", "000001"):
        charts = np.load(os.path.join(root, "touch_charts", name, "touch_charts.npy"))
        assert charts.shape[0] == 2 and np.isfinite(charts).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train-vision", "--root", root, "--experiments-root", exp])
