"""Runner of the touch-chart trainer's steps: ``TouchEngine.train_step`` on
batches of the port's ``TouchDataset`` and ``Loader`` through
``ReconEngine.to_device``, as ``ReconEngine.run_epoch`` runs them (no host
sync a step; the loss stays on the device).

The traffic mix gives the ``split`` read, its objects (``world``: names
and distinct objects), the ``grasps`` and ``fingers`` touched an object,
the points of each touch cloud (``cloud_points``, above the
configuration's sample count, so every read draws a subset), ``shuffle``,
the batches assembled in the set-up and then cycled
(``preloaded_batches``), the steps run before the window
(``warmup_steps``), the first of them trained on by both sides
(``checked_steps``: each leaf's first gradient and its change after them
are compared), the first of those whose losses are compared
(``checked_losses``) and the steps of each profiled stretch under
``--trace 1`` (``profiled_steps``).  The losses are compared before Adam
amplifies the convolutions' TF32 rounding: its first steps move every
element by about ``lr`` whatever its gradient's size, and the losses of
two sound trainings part by up to 1% within 3 steps, as far as a row
counted twice moves them.  The sampler's random numbers are the
benchmark's, drawn from the seed and handed to both sides.  Under
``--trace 1`` the program's recorder is cleared before the profiled
stretches, so its ``snapshot()`` (written as ``snapshot.json`` under
``$A3VT_PROFILE_DIR/<cell>/`` where that names a directory) holds theirs
alone.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time

import numpy as np
import torch

from benchmark import spans
from benchmark.flops.touch import kernel_bounds, step_least_seconds
from benchmark.harness import Outcome, Run
from benchmark.reference.compare import training_numbers
from benchmark.reference.touch import TouchReference, param_specs
from benchmark.reference.vision import train_steps
from benchmark.runners.common import Phases, Preloaded, no_span, precision, sync
from benchmark.runners.recon import SPANS, Noise, Timer, change_norms, device_batch, first_gradient_norms
from benchmark.trace import profile
from benchmark.weights import seeded_weights
from benchmark.world.touch import write_touch_world

COUNTERS = ("touch.charts",)
PROGRAM_SPANS = ("recon.train_step", "recon.forward_loss", "recon.backward", "touch.encode", "touch.chamfer")


def model_dict(run: Run) -> dict:
    """The configuration as the reference and the counts read it."""
    return {**run.config["config"], "repeat": run.config["repeat"]}


def build(run: Run, phases: Phases):
    """The world, the engine with the seeded weights, the feed."""
    from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig
    from active_3d_vision_and_touch_tpu_torch.data.datasets import Loader, TouchDataset
    from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine

    if run.traffic["mode"] != "train":
        raise ValueError(f"the touch runner trains; mode {run.traffic['mode']!r}")
    precision(run.config)
    t = run.traffic
    phases.mark("imports")
    write_touch_world(run.workdir / "world", run.seed, run.device, t["world"], t["grasps"], t["fingers"],
                      t["cloud_points"])
    phases.mark("world")
    cfg = TouchConfig(**run.config["config"], seed=run.seed,
                      experiments_root=str(run.workdir / "experiments"), eval=True)
    engine = TouchEngine(cfg, device=run.device, log=False)
    weights = seeded_weights(param_specs(model_dict(run)), run.seed, run.device)
    engine.model.load_state_dict(weights)
    dataset = TouchDataset(str(run.workdir / "world"), t["split"], num_samples=cfg.num_samples)
    feed = Preloaded(Loader(dataset, cfg.batch_size, shuffle=t["shuffle"], seed=run.seed),
                     t["preloaded_batches"])
    noise = Noise(run.seed, cfg.batch_size, cfg.num_samples * run.config["repeat"], run.device)
    phases.mark("engine")
    return engine, weights, feed, noise


class Prepared:
    """The program after set-up: the engine, its feed, the seeded weights,
    the set-up's steps and the first gradient and change Adam holds after
    them."""

    def __init__(self, run: Run):
        self.phases = Phases(run.t_start)
        self.engine, self.weights, self.feed, self.noise = build(run, self.phases)
        self.checked, self.grad1 = [], None
        for i in range(run.traffic["warmup_steps"]):
            raw, draws, loss = self.step()
            if i < run.traffic["checked_steps"]:
                self.checked.append((raw, draws, loss))
            if i == 0:
                self.grad1 = first_gradient_norms(self.engine)
        self.change = change_norms(self.engine, self.weights)
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
        return raw, draws, loss

    def readings(self) -> dict:
        return {"losses": [float(x) for _, _, x in self.checked], "grad_norms": self.grad1,
                "change_norms": self.change}

    def release(self) -> list:
        """Free the program's state (the reference runs after it); returns
        the checked steps' inputs [(raw, draws)]."""
        inputs = [(raw, draws) for raw, draws, _ in self.checked]
        self.feed.close()
        del self.engine, self.feed, self.checked
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return inputs


def reference_readings(run: Run, weights: dict, inputs: list, dtype=torch.float32,
                       fault: str | None = None) -> dict:
    """The reference's readings over the same inputs and weights: in the
    configuration's precision, or in ``dtype`` and with a ``fault`` planted
    (the control and the faults, in the program's place)."""
    ref = TouchReference(model_dict(run), run.device, dtype=dtype)
    batches = [device_batch(raw, run.device) for raw, _ in inputs]
    return train_steps(ref, weights, batches, [d for _, d in inputs], run.config["config"]["lr"], fault=fault)


def compare(run: Run, prog: dict, ref: dict) -> dict:
    """``training_numbers`` over the first ``checked_losses`` losses."""
    n = run.traffic["checked_losses"]
    return training_numbers({**prog, "losses": prog["losses"][:n]}, {**ref, "losses": ref["losses"][:n]})


def save_snapshot(run: Run, snap: dict) -> None:
    """The recorder's snapshot as ``$A3VT_PROFILE_DIR/<cell>/snapshot.json``,
    where that names a directory (as the port's ``profiler.trace`` writes
    it)."""
    out_dir = os.environ.get("A3VT_PROFILE_DIR")
    if out_dir:
        path = os.path.join(out_dir, run.cell)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "snapshot.json"), "w") as f:
            json.dump(snap, f, indent=1)


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
        losses.append(prep.step()[2])
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
    least = step_least_seconds(model_dict(run))
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


VARIANTS = {"bf16": dict(dtype=torch.bfloat16), "half": dict(fault="half"), "row0x2": dict(fault="row0x2")}


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
