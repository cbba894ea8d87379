"""Runner of the mesh-autoencoder trainer's steps: ``AutoencoderEngine.train_step``
over a frozen ``VisionEngine``, on batches of the port's ``VisionDataset``
and ``Loader`` through ``ReconEngine.to_device``, as ``ReconEngine.run_epoch``
runs them (no host sync a step; the loss stays on the device).

The traffic mix gives the ``split`` read (``auto_train``, as ``train-auto``
reads), the objects written to it (``world``), the gt cloud's points
(``cloud_points``), the images' size (``image_size``), ``shuffle``, the
batches assembled in the set-up and then cycled (``preloaded_batches``),
the steps run before the window (``warmup_steps``), the first of them
checked (``checked_steps``: each leaf's first gradient norm, the decoder's
output layer's first gradient and each leaf's change after them are
compared), the first of those whose losses are compared
(``checked_losses``) and the steps of each profiled stretch under
``--trace 1`` (``profiled_steps``).

The frozen model and the autoencoder are held apart.  The frozen vertices
of each checked step's batch, as the program's ``AutoencoderEngine.deform``
gives them, are compared with the reference's frozen model
(``deform_gap``); the reference's autoencoder then trains on the
program's own frozen vertices and masks, so that its numbers see the
autoencoder alone.  The sampler's random numbers are the benchmark's,
drawn from the seed and handed to both sides.  Under ``--trace 1`` the
program's recorder is cleared before the profiled stretches, so its
``snapshot()`` (written as ``snapshot.json`` under
``$A3VT_PROFILE_DIR/<cell>/`` where that names a directory) holds theirs
alone.
"""

from __future__ import annotations

import gc
import json
import math
import time

import numpy as np
import torch

from benchmark import spans
from benchmark.flops.autoencoder import kernel_bounds, step_least_seconds
from benchmark.harness import Outcome, Run
from benchmark.reference.autoencoder import (AutoencoderReference, FrozenVision, decoder_widths, first_gradients,
                                              param_specs)
from benchmark.reference.compare import training_numbers
from benchmark.reference.vision import cast, train_steps
from benchmark.reference.vision import param_specs as vision_specs
from benchmark.runners.common import Phases, Preloaded, no_span, precision, sync
from benchmark.runners.recon import SPANS, Noise, Timer, change_norms, device_batch
from benchmark.runners.touch import save_snapshot
from benchmark.trace import profile
from benchmark.weights import seeded_weights
from benchmark.world.vision import write_vision_world

COUNTERS = ("auto.clouds", "recon.eager_steps", "recon.graph_replays", "recon.staged_batches",
            "recon.staging_waits")
PROGRAM_SPANS = ("recon.train_step", "recon.forward_loss", "recon.backward", "auto.deform", "auto.encode",
                 "auto.decode", "auto.chamfer")
AUTO_SEED = 0xA0  # the autoencoder's weights are drawn from seed ^ AUTO_SEED, the frozen model's from seed


def model_dict(run: Run) -> dict:
    """The autoencoder's configuration as the reference and the counts
    read it."""
    return {**run.config["config"], "repeat": run.config["repeat"], "feature_size": run.config["feature_size"]}


def build(run: Run, phases: Phases):
    """The world, the frozen engine and the autoencoder's engine with the
    seeded weights ({"vision", "auto"}), the feed, the noise."""
    from active_3d_vision_and_touch_tpu_torch.core.config import AutoencoderConfig, VisionConfig
    from active_3d_vision_and_touch_tpu_torch.data.datasets import Loader, VisionDataset
    from active_3d_vision_and_touch_tpu_torch.train.autoencoder import AutoencoderEngine
    from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

    if run.traffic["mode"] != "train":
        raise ValueError(f"the autoencoder runner trains; mode {run.traffic['mode']!r}")
    precision(run.config)
    t, dev = run.traffic, run.device
    phases.mark("imports")
    root = run.workdir / "world"
    write_vision_world(root, run.seed, dev, t["world"], t["cloud_points"], run.config["vision"]["num_actions"],
                       t["image_size"])
    phases.mark("world")
    common = dict(seed=run.seed, experiments_root=str(run.workdir / "experiments"), eval=True)
    vision = VisionEngine(VisionConfig(**run.config["vision"], **common), device=dev, log=False)
    weights = {"vision": seeded_weights(vision_specs(run.config["vision"]), run.seed, dev),
               "auto": seeded_weights(param_specs(model_dict(run)), run.seed ^ AUTO_SEED, dev)}
    cfg = AutoencoderConfig(**run.config["config"], **common)
    engine = AutoencoderEngine(cfg, vision_engine=vision, vision_state=weights["vision"], device=dev, log=False)
    engine.model.load_state_dict(weights["auto"])
    dataset = VisionDataset(str(root), t["split"], use_img=cfg.use_img, use_touch=cfg.use_touch,
                            finger=cfg.finger, num_grasps=cfg.num_grasps, number_points=cfg.number_points,
                            num_actions=cfg.num_actions, seed=run.seed)
    feed = Preloaded(Loader(dataset, cfg.batch_size, shuffle=t["shuffle"], seed=run.seed), t["preloaded_batches"])
    noise = Noise(run.seed, cfg.batch_size, cfg.number_points * run.config["repeat"], dev)
    phases.mark("engine")
    return engine, weights, feed, noise


class Prepared:
    """The program after set-up: the engines, the feed, the seeded weights,
    the set-up's checked steps with the frozen vertices and masks of their
    batches, and the first gradient and change Adam holds after them."""

    def __init__(self, run: Run):
        self.phases = Phases(run.t_start)
        self.engine, self.weights, self.feed, self.noise = build(run, self.phases)
        self.checked, self.grad1 = [], None
        for i in range(run.traffic["warmup_steps"]):
            raw, batch, draws, loss = self.step()
            if i < run.traffic["checked_steps"]:
                verts, mask = self.engine.deform(batch)
                self.checked.append((raw, draws, loss, verts, mask))
            if i == 0:
                self.grad1 = adam_first_gradients(self.engine)
        self.change = change_norms(self.engine, self.weights["auto"])
        sync(run.device)
        self.phases.mark("warm-up")

    def step(self, spans: bool = False):
        ctx = torch.profiler.record_function if spans else no_span
        with ctx(SPANS[0]):
            raw = self.feed.next()
        with ctx(SPANS[1]):
            batch = self.engine.to_device(raw)
        draws = self.noise.next()
        with ctx(SPANS[2]):
            loss = self.engine.train_step(batch, draws=draws)
        return raw, batch, draws, loss

    def readings(self) -> dict:
        return {"losses": [float(c[2]) for c in self.checked], "grads": self.grad1,
                "grad_norms": {k: float(torch.linalg.vector_norm(g)) for k, g in self.grad1.items()},
                "change_norms": self.change, "verts": [c[3] for c in self.checked]}

    def release(self) -> list:
        """Free the program's state (the reference runs after it); returns
        the checked steps' inputs [(raw, draws, verts, mask)]."""
        inputs = [(raw, draws, verts, mask) for raw, draws, _, verts, mask in self.checked]
        self.feed.close()
        del self.engine, self.feed, self.checked
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return inputs


def adam_first_gradients(engine) -> dict:
    """Each parameter's gradient as Adam got it at step 1, from its state:
    exp_avg / (1 - beta1), a new tensor (zeros where Adam holds none)."""
    beta1 = engine.optimizer.param_groups[0]["betas"][0]
    state = engine.optimizer.state
    return {name: state[p]["exp_avg"] / (1 - beta1) if state.get(p) else torch.zeros_like(p)
            for name, p in engine.model.named_parameters()}


def reference_readings(run: Run, weights: dict, inputs: list, dtype=torch.float32,
                       fault: str | None = None, tf32_decoder: bool = False) -> dict:
    """The reference's readings over the same inputs and weights: the
    frozen vertices of each batch, and the autoencoder's training on the
    program's frozen vertices and masks, with its first gradient; in the
    configuration's precision, or in ``dtype``, with the decoder's products
    in TF32 or with a ``fault`` planted in the autoencoder's loss (the
    controls and the faults, in the program's place)."""
    frozen = FrozenVision(run.config["vision"], run.device, dtype)
    p = cast(weights["vision"], dtype, run.device)
    verts = [frozen.deform_eval(p, device_batch(raw, run.device)).float() for raw, _, _, _ in inputs]
    del p, frozen
    ref = AutoencoderReference(model_dict(run), run.device, dtype, tf32_decoder=tf32_decoder)
    batches = [{"verts": v, "mask": m} for _, _, v, m in inputs]
    draws = [d for _, d, _, _ in inputs]
    out = train_steps(ref, weights["auto"], batches, draws, run.config["config"]["lr"], fault=fault)
    grads = first_gradients(ref, weights["auto"], batches[0], draws[0], fault=fault)
    return {**out, "grads": grads, "verts": verts}


def deform_gap(prog: list, ref: list) -> float:
    """The worst row's ‖v_program - v_reference‖ / ‖v_reference‖ over the
    checked batches' frozen vertices."""
    worst = 0.0
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            return math.inf
        gap = torch.linalg.vector_norm((p.float() - r).flatten(1), dim=1) / torch.linalg.vector_norm(r.flatten(1), dim=1)
        if not bool(torch.isfinite(gap).all()):
            return math.inf
        worst = max(worst, float(gap.max()))
    return worst


def out_grad_gap(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, str]:
    """The worst of ``leaves``' ‖g_program - g_reference‖ / ‖g_reference‖
    of the first gradients, and its leaf."""
    worst, at = 0.0, ""
    for k in leaves:
        if prog[k].shape != ref[k].shape:
            return math.inf, k
        gap = float(torch.linalg.vector_norm(prog[k].float() - ref[k]) / torch.linalg.vector_norm(ref[k]))
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def compare(run: Run, prog: dict, ref: dict) -> dict:
    """``deform_gap``, then ``training_numbers`` over the first
    ``checked_losses`` losses, then ``out_grad_gap`` over the decoder's
    output layer: its weight's and bias's first gradients sum each row's
    Chamfer pull on its own decoded points, from float32 products alone,
    so they see which rows the loss took, where the batch's rows are so
    alike that every norm and loss keeps its value without half of them;
    the encoder's leaves carry its bf16 rounding and the max-pool's
    switches, as large as that (PERF.md §2)."""
    n = run.traffic["checked_losses"]
    out = {"deform_gap": deform_gap(prog["verts"], ref["verts"]),
           **training_numbers({**prog, "losses": prog["losses"][:n]}, {**ref, "losses": ref["losses"][:n]})}
    last = f"decoder.dense.{len(decoder_widths(run.config['config']['encoding_size'])) - 1}"
    out["out_grad_gap"], out["_leaves"]["out_grad_gap"] = out_grad_gap(prog["grads"], ref["grads"],
                                                                       [f"{last}.weight", f"{last}.bias"])
    return out


def run(run: Run) -> Outcome:
    prep = Prepared(run)
    b = prep.engine.config.batch_size
    sync(run.device)
    setup_s = time.perf_counter() - run.t_start

    # the window
    timer, losses = Timer(run.device), []
    timer.mark()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        losses.append(prep.step()[3])
        timer.mark()
    sync(run.device)
    window_s = time.perf_counter() - t0
    steps = len(losses)
    intervals = timer.intervals_ms()

    reading, snap = None, None
    if run.trace and run.device.type == "cuda":
        from active_3d_vision_and_touch_tpu_torch.utils import profiler

        n = run.traffic["profiled_steps"]
        profiler.reset()
        reading = profile(lambda: [prep.step(spans=True) for _ in range(n)], SPANS)
        reading["idle_gaps"] = profile(lambda: [prep.step(spans=True) for _ in range(n)], SPANS,
                                       host=True)["idle_gaps"]
        reading["units"] = n
        reading["kernel_bounds"] = {k: (launches * n, seconds * n)
                                    for k, (launches, seconds) in kernel_bounds(model_dict(run)).items()}
        snap = spans.snapshot()
        save_snapshot(run, snap)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    prog = prep.readings()
    del losses
    inputs = prep.release()

    t1 = time.perf_counter()
    ref = reference_readings(run, prep.weights, inputs)
    numbers = compare(run, prog, ref)
    checks = [(name, float(numbers[name]), float(limit)) for name, limit in run.limits.items()]
    least = step_least_seconds(model_dict(run), run.config["vision"])
    record = {"window_s": window_s, "window_units": steps, "least_s": steps * least["total"], "trace": reading}
    notes = [
        prep.phases.note(),
        f"window: {steps} steps in {window_s:.3f} s; least time a step {least['total'] * 1e3:.3f} ms ("
        + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in least.items() if k != "total") + ")",
        "intervals ms (quartiles, max): " + " ".join(f"{q:.3f}" for q in np.percentile(intervals, [25, 50, 75, 100])),
        f"reference: {time.perf_counter() - t1:.3f} s; losses program {prog['losses']} "
        f"reference {ref['losses']}; {numbers['_leaves']}",
        "numbers: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items() if k != "_leaves"),
    ]
    if snap:
        notes.append("recorder: " + json.dumps({
            "counters": {k: snap["counters"].get(k) for k in COUNTERS},
            "median_ms": {k: snap["spans"].get(k, {}).get("median_ms") for k in PROGRAM_SPANS},
            "count": {k: snap["spans"].get(k, {}).get("count") for k in PROGRAM_SPANS},
            "launches": snap.get("launches")}))
    return Outcome(
        end_to_end={
            "samples_per_s": steps * b / window_s,
            "step_p95_ms": float(np.percentile(intervals, 95)) if intervals else math.inf,
            "setup_s": setup_s,
        },
        record=record, checks=checks, attempted=steps, failed=failed, memory_peak_bytes=int(peak),
        trace=reading, notes=notes,
    )


VARIANTS = {"bf16": dict(dtype=torch.bfloat16), "tf32_decoder": dict(tf32_decoder=True), "half": dict(fault="half"),
            "row0x2": dict(fault="row0x2")}


def control(run: Run, variants: dict = VARIANTS) -> list[dict]:
    """Readings that set the limits: the program set up as a run sets it
    up, its first steps through the window's call, then the reference in
    the program's place in each of ``variants`` ({name: keyword arguments
    of :func:`reference_readings`}), and ``unchanged``, the program's own
    readings with the change norms of a state that never moved."""
    prep = Prepared(run)
    prog = prep.readings()
    inputs = prep.release()
    weights = prep.weights
    t0 = time.perf_counter()
    ref = reference_readings(run, weights, inputs)
    out = [{"variant": "program", "seconds": time.perf_counter() - t0, **compare(run, prog, ref)}]
    for name, kwargs in variants.items():
        t0 = time.perf_counter()
        got = reference_readings(run, weights, inputs, **kwargs)
        out.append({"variant": name, "seconds": time.perf_counter() - t0, **compare(run, got, ref)})
    still = {**prog, "change_norms": dict.fromkeys(prog["change_norms"], 0.0)}
    out.append({"variant": "unchanged", "seconds": 0.0, **compare(run, still, ref)})
    return out
