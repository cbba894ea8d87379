"""Runner of the reconstruction trainers' steps: ``ReconEngine.train_step``
or ``eval_step`` on batches from the port's ``Loader``, epochs chained, as
``ReconEngine.run_epoch`` runs them (no host sync a step; the loss stays on
the device).

The traffic mix gives ``mode`` ("train" or "eval"), the ``split`` read,
the objects written to each split (``world``), the gt cloud's points
(``cloud_points``, above the configuration's sample count, so every read
draws another subset), ``shuffle``, the steps run before the window
(``warmup_steps``), the steps held against the reference
(``checked_steps``) and the steps profiled under ``--trace 1``
(``profiled_steps``).  Training checks its first ``checked_steps`` steps,
the set-up's; evaluation a sample of the window's steps drawn from the
seed.  The sampler's random numbers are the benchmark's, drawn from the
seed and handed to both sides.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.runners.common import Feed, Phases, Preloaded, no_span, precision, sync
from benchmark.flops.vision import kernel_bounds, step_least_seconds
from benchmark.harness import Outcome, Run
from benchmark.reference.compare import loss_gap, training_numbers
from benchmark.reference.vision import (
    Reference,
    draw_noise,
    eval_losses,
    param_specs,
    train_steps,
)
from benchmark.trace import profile
from benchmark.weights import seeded_weights
from benchmark.world.vision import write_vision_world

SPANS = ("bench.loader_next", "bench.to_device", "bench.step")


class Noise:
    """The sampler's random numbers of each step, from the seed."""

    def __init__(self, seed: int, rows: int, samples: int, dev: torch.device):
        self.gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
        self.shape, self.dev = (rows, samples), dev

    def next(self) -> tuple:
        return draw_noise(self.gen, *self.shape, self.dev)


class Timer:
    """Step-to-step intervals: CUDA events recorded after each step on the
    card (no host sync), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def engine_config(run: Run):
    from active_3d_vision_and_touch_tpu_torch.core.config import VisionConfig

    return VisionConfig(**run.config["config"], seed=run.seed,
                        experiments_root=str(run.workdir / "experiments"), eval=True)


def build(run: Run, phases: Phases):
    """The world, the engine with the seeded weights, the feed."""
    from active_3d_vision_and_touch_tpu_torch.data.datasets import Loader, VisionDataset
    from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

    precision(run.config)
    t, c = run.traffic, run.config["config"]
    phases.mark("imports")
    write_vision_world(run.workdir / "world", run.seed, run.device, t["world"], t["cloud_points"],
                       c["num_actions"], t["image_size"])
    phases.mark("world")
    cfg = engine_config(run)
    engine = VisionEngine(cfg, device=run.device, log=False)
    weights = seeded_weights(param_specs(model_dict(run)), run.seed, run.device)
    engine.model.load_state_dict(weights)
    dataset = VisionDataset(str(run.workdir / "world"), t["split"], use_img=cfg.use_img,
                            use_touch=cfg.use_touch, finger=cfg.finger, num_grasps=cfg.num_grasps,
                            number_points=cfg.number_points, num_actions=cfg.num_actions,
                            seed=run.seed)
    loader = Loader(dataset, cfg.batch_size, shuffle=t["shuffle"], seed=run.seed)
    feed = Preloaded(loader, t["preloaded_batches"]) if t.get("preloaded_batches") else Feed(loader)
    noise = Noise(run.seed, cfg.batch_size, cfg.number_points * run.config["repeat"], run.device)
    phases.mark("engine")
    return engine, weights, feed, noise


def model_dict(run: Run) -> dict:
    """The configuration as the reference and the counts read it."""
    return {**run.config["config"], "repeat": run.config["repeat"],
            **run.config["assumed"]}


class Prepared:
    """The program after set-up: the engine, its feed, the seeded weights,
    the step as the window calls it, and (training) the set-up's steps
    with what the optimizer holds after them."""

    def __init__(self, run: Run):
        self.train = run.traffic["mode"] == "train"
        self.phases = Phases(run.t_start)
        self.engine, self.weights, self.feed, self.noise = build(run, self.phases)
        self.step_fn = self.engine.train_step if self.train else self.engine.eval_step
        self.checked, self.grad1, self.change = [], None, None
        for i in range(run.traffic["warmup_steps"]):
            raw, draws, loss = self.step()
            if self.train and i < run.traffic["checked_steps"]:
                self.checked.append((raw, draws, loss))
            if self.train and i == 0:
                self.grad1 = first_gradient_norms(self.engine)
        if self.train:
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
            loss = self.step_fn(batch, draws=draws)
        return raw, draws, loss

    def readings(self, steps: list) -> dict:
        """The program's readings of ``steps`` [(raw, draws, loss)]."""
        out = {"losses": [float(x) for _, _, x in steps]}
        if self.train:
            out.update(grad_norms=self.grad1, change_norms=self.change)
        return out

    def release(self) -> None:
        """Free the program's state: the reference runs after it."""
        self.feed.close()
        del self.engine, self.step_fn, self.feed, self.checked
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def run(run: Run) -> Outcome:
    prep = Prepared(run)
    train, b = prep.train, prep.engine.config.batch_size
    sync(run.device)
    setup_s = time.perf_counter() - run.t_start

    # the window
    prep.feed.waits.clear()
    timer, losses = Timer(run.device), []
    sample, rng, seen = [], np.random.default_rng(run.seed), 0
    timer.mark()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        raw, draws, loss = prep.step()
        timer.mark()
        losses.append(loss)
        if not train:  # a uniform sample of the window's steps (reservoir)
            seen += 1
            if len(sample) < run.traffic["checked_steps"]:
                sample.append((raw, draws, loss))
            elif (j := rng.integers(seen)) < len(sample):
                sample[j] = (raw, draws, loss)
    sync(run.device)
    window_s = time.perf_counter() - t0
    steps = len(losses)
    intervals = timer.intervals_ms()
    waits = list(prep.feed.waits)

    reading = None
    if run.trace and run.device.type == "cuda":
        n = run.traffic["profiled_steps"]
        reading = profile(lambda: [prep.step(spans=True) for _ in range(n)], SPANS)
        reading["idle_gaps"] = profile(lambda: [prep.step(spans=True) for _ in range(n)], SPANS,
                                       host=True)["idle_gaps"]
        reading["units"] = n
        reading["kernel_bounds"] = {k: (launches * n, seconds * n)
                                    for k, (launches, seconds) in kernel_bounds(model_dict(run), train).items()}
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    checked = prep.checked if train else sample
    prog = prep.readings(checked)
    inputs = [(raw, draws) for raw, draws, _ in checked]
    del losses, sample, checked
    prep.release()

    t1 = time.perf_counter()
    ref = reference_readings(run, prep.weights, inputs, train)
    numbers = compare_numbers(prog, ref, train)
    checks = [(name, float(numbers[name]), float(limit)) for name, limit in run.limits.items()]
    cfg = model_dict(run)
    least = step_least_seconds(cfg, train)
    record = {
        "window_s": window_s,
        "window_units": steps,
        "least_s": steps * least["total"],
        "loader_waits_s": waits,
        "trace": reading,
    }
    notes = [
        prep.phases.note(),
        f"window: {steps} steps in {window_s:.3f} s; least time a step {least['total'] * 1e3:.3f} ms ("
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in least.items() if k != "total") + ")",
        "intervals ms (quartiles, max): " + " ".join(f"{q:.2f}" for q in np.percentile(intervals, [25, 50, 75, 100]))
        + "; loader waits ms: " + " ".join(f"{1e3 * q:.2f}" for q in np.percentile(waits, [25, 50, 75, 100])),
        f"reference: {time.perf_counter() - t1:.3f} s; losses program {prog['losses']} "
        f"reference {ref['losses']}; {numbers.get('_leaves', '')}",
        "numbers: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items() if k != "_leaves"),
    ]
    return Outcome(
        end_to_end={
            "samples_per_s": steps * b / window_s,
            "step_p95_ms": float(np.percentile(intervals, 95)) if intervals else math.inf,
            "setup_s": setup_s,
        },
        record=record, checks=checks, attempted=steps, failed=failed, memory_peak_bytes=int(peak),
        trace=reading, notes=notes,
    )


def first_gradient_norms(engine) -> dict:
    """Each parameter's gradient as Adam got it at step 1, from its state:
    exp_avg / (1 - beta1)."""
    beta1 = engine.optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in engine.model.named_parameters():
        state = engine.optimizer.state.get(p)
        g = state["exp_avg"] / (1 - beta1) if state else torch.zeros_like(p)
        out[name] = float(torch.linalg.vector_norm(g))
    return out


def change_norms(engine, weights: dict) -> dict:
    return {name: float(torch.linalg.vector_norm(p.detach() - weights[name]))
            for name, p in engine.model.named_parameters()}


def device_batch(raw: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
            for k, v in raw.items() if k != "names"}


def reference_readings(run: Run, weights: dict, inputs: list, train: bool,
                       dtype=torch.float32, fault: str | None = None) -> dict:
    """The reference's readings over the same inputs and weights: in the
    configuration's precision, or in ``dtype`` and with a ``fault`` planted
    (the control and the faults, in the program's place)."""
    ref = Reference(model_dict(run), run.device, dtype=dtype)
    batches = [device_batch(raw, run.device) for raw, _ in inputs]
    draws = [d for _, d in inputs]
    if train:
        return train_steps(ref, weights, batches, draws, run.config["config"]["lr"], fault=fault)
    return {"losses": eval_losses(ref, weights, batches, draws, fault=fault)}


def compare_numbers(prog: dict, ref: dict, train: bool) -> dict:
    if train:
        return training_numbers(prog, ref)
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"])}


def control(run: Run, variants: dict) -> list[dict]:
    """Readings that set the limits: the program set up as a run sets it
    up (training: its first steps through the window's call; evaluation:
    as many window steps as a run compares), then the reference in the
    program's place in each of ``variants`` ({name: keyword arguments of
    ``reference_readings``})."""
    prep = Prepared(run)
    steps = prep.checked if prep.train else [prep.step() for _ in range(run.traffic["checked_steps"])]
    prog = prep.readings(steps)
    inputs = [(raw, draws) for raw, draws, _ in steps]
    weights = prep.weights
    del steps
    prep.release()
    t0 = time.perf_counter()
    ref = reference_readings(run, weights, inputs, prep.train)
    out = [{"variant": "program", "seconds": time.perf_counter() - t0,
            **compare_numbers(prog, ref, prep.train)}]
    for name, kwargs in variants.items():
        t0 = time.perf_counter()
        got = reference_readings(run, weights, inputs, prep.train, **kwargs)
        out.append({"variant": name, "seconds": time.perf_counter() - t0,
                    **compare_numbers(got, ref, prep.train)})
    return out
