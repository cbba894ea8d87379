"""Runner of the greedy (myopic-oracle) policy's episodes, as
``GreedyEngine.evaluate`` runs them: an env batch from the port's
``Loader`` over the split, ``ActiveTouchEnv.reset``, then
``ActiveTouchEnv.best_step`` up to the budget, episodes chained.

The traffic mix gives the ``split`` read, the objects written to each split
(``world``), the gt cloud's points (``cloud_points``), the steps run before
the window (``warmup_steps``, from one reset), the window's steps held
against the reference (``checked_steps``, drawn from the seed) and the
episodes profiled under ``--trace 1`` (``profiled_episodes``).

The env draws the sampler's random numbers from its generator, seeded
with the run's seed; the benchmark reads the generator's state before each
step, and the reference draws the same numbers from that state.  Each
step's candidate scores are read where ``score_candidates`` returns them.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchmark.runners.common import Feed, Phases, no_span, precision, sync
from benchmark.flops.active import greedy_step_seconds, k1_launches, observation_seconds
from benchmark.harness import Outcome, Run
from benchmark.reference.active import GreedyReference
from benchmark.reference.compare import greedy_numbers
from benchmark.reference.vision import param_specs
from benchmark.trace import profile
from benchmark.weights import module_specs, seeded_weights
from benchmark.world.vision import write_vision_world

SPANS = ("bench.loader_next", "bench.reset", "bench.best_step")


def model_dict(run: Run) -> dict:
    """The configuration as the reference and the counts read it."""
    c = run.config
    return {**c["config"], "repeat": c["repeat"], "autoencoder": c["autoencoder"],
            "candidate_chunk": c["assumed"]["candidate_chunk"]}


def build_env(run: Run, phases: Phases, **settings) -> tuple:
    """The world, the frozen deformation model and autoencoder with their
    seeded weights, and the env over them: (world root, config, vision
    weights, autoencoder weights, env).  ``settings`` go to the
    ``PolicyConfig``."""
    from active_3d_vision_and_touch_tpu_torch.active.env import ActiveTouchEnv
    from active_3d_vision_and_touch_tpu_torch.core.config import AutoencoderConfig, PolicyConfig
    from active_3d_vision_and_touch_tpu_torch.train.autoencoder import build_autoencoder
    from active_3d_vision_and_touch_tpu_torch.train.vision import build_deformation

    precision(run.config)
    t, c, dev = run.traffic, run.config, run.device
    phases.mark("imports")
    root = run.workdir / "world"
    write_vision_world(root, run.seed, dev, t["world"], t["cloud_points"], c["config"]["num_actions"],
                       t["image_size"])
    phases.mark("world")
    cfg = PolicyConfig(**c["config"], seed=run.seed, experiments_root=str(run.workdir / "experiments"),
                       **settings)
    deform = build_deformation(cfg, dev)
    weights = seeded_weights(param_specs(model_dict(run)), run.seed, dev)
    deform.load_state_dict(weights)
    a = c["autoencoder"]
    auto = build_autoencoder(AutoencoderConfig(**{k: v for k, v in a.items() if k != "feature_size"}), dev)
    auto_weights = seeded_weights(module_specs(auto), run.seed ^ 0xA0, dev)
    auto.load_state_dict(auto_weights)
    env = ActiveTouchEnv(cfg, vision_model=deform, auto_model=auto, chart_cache_root=str(root), device=dev)
    return root, cfg, weights, auto_weights, env


class Env:
    """The program after set-up: the env over its world, its feed, the
    seeded weights, and what each step returned."""

    def __init__(self, run: Run):
        from active_3d_vision_and_touch_tpu_torch.data.datasets import ActiveDataset, Loader

        self.phases = Phases(run.t_start)
        self.root, self.cfg, self.weights, _, self.env = build_env(run, self.phases, eval=True)
        cfg, t = self.cfg, run.traffic
        dataset = ActiveDataset(str(self.root), t["split"], use_img=cfg.use_img,
                                number_points=cfg.number_points, env_batch_size=cfg.env_batch_size)
        self.feed = Feed(Loader(dataset, cfg.env_batch_size, shuffle=False, drop_last=True))
        self.scored = None
        score_candidates = self.env.score_candidates

        def recorded(candidates, *args, **kwargs):
            self.scored = score_candidates(candidates, *args, **kwargs)
            return self.scored

        self.env.score_candidates = recorded
        self.episode, self.taken, self.resets, self.reset_s = None, [], 0, []
        self.phases.mark("engine")

    def reset(self, spans: bool = False) -> None:
        ctx = torch.profiler.record_function if spans else no_span
        with ctx(SPANS[0]):
            batch = self.feed.next()
        t0 = time.perf_counter()
        with ctx(SPANS[1]):
            self.env.reset(batch)
        self.reset_s.append(time.perf_counter() - t0)
        self.episode, self.taken = batch, []
        self.resets += 1

    def step(self, spans: bool = False) -> dict:
        """One greedy step, a new episode first where the last one ended:
        what the reference needs to follow it, and what it returned."""
        if self.episode is None or len(self.taken) == self.cfg.budget:
            self.reset(spans)
        state = self.env.generator.get_state()
        ctx = torch.profiler.record_function if spans else no_span
        with ctx(SPANS[2]):
            best, obs, _, _ = self.env.best_step(greedy_checks=self.cfg.greedy_checks)
        record = {"batch": self.episode, "taken": list(self.taken), "state": state,
                  "scores": self.scored, "chosen": np.asarray(best), "obs": obs["score"]}
        self.taken.append(np.asarray(best))
        return record

    def release(self) -> None:
        self.feed.close()
        self.env.sampler.disconnect()
        del self.env
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def chart_caches(root, names) -> list:
    return [np.load(root / "touch_charts" / str(n).rsplit("/", 1)[-1] / "touch_charts.npy") for n in names]


def reference_steps(run: Run, weights: dict, root, records: list, dtype=torch.float32,
                    fault: str | None = None) -> list:
    """The reference's scores of the ``records``' steps: per step every
    action's (b, A), the observation's after the program's choice (b,) and
    the actions taken before (b, A)."""
    ref = GreedyReference(model_dict(run), weights, run.device, dtype=dtype)
    out = []
    for r in records:
        batch = r["batch"]
        scores, obs = ref.step(batch["img"], batch["gt_points"], chart_caches(root, batch["names"]),
                               r["taken"], r["chosen"], r["state"], fault=fault)
        seen = np.zeros(scores.shape, bool)
        for actions in r["taken"]:
            seen[np.arange(len(actions)), actions] = True
        out.append({"scores": scores, "obs": obs, "seen": seen})
    return out


def compare(records: list, ref: list) -> dict:
    return greedy_numbers([{**r, "ref_scores": x["scores"], "ref_obs": x["obs"], "seen": x["seen"]}
                           for r, x in zip(records, ref)])


def control(run: Run, variants: dict) -> list[dict]:
    """Readings that set the limits: the program's steps as a run checks
    them (``checked_steps`` steps after the warm-up), then the reference in
    the program's place in each of ``variants`` ({name: keyword arguments
    of ``reference_steps``}), choosing its own best action."""
    env = Env(run)
    for _ in range(run.traffic["warmup_steps"]):
        env.step()
    env.episode = None
    records = [env.step() for _ in range(run.traffic["checked_steps"])]
    root, weights = env.root, env.weights
    env.release()
    t0 = time.perf_counter()
    ref = reference_steps(run, weights, root, records)
    out = [{"variant": "program", "seconds": time.perf_counter() - t0, **compare(records, ref)}]
    for name, kwargs in variants.items():
        t0 = time.perf_counter()
        got = reference_steps(run, weights, root, records, **kwargs)
        mine = [{**r, "scores": g["scores"], "obs": g["obs"],
                 "chosen": np.where(g["seen"], np.inf, g["scores"]).argmin(axis=1)}
                for r, g in zip(records, got)]
        out.append({"variant": name, "seconds": time.perf_counter() - t0, **compare(mine, ref)})
    return out


def run(run: Run) -> Outcome:
    env = Env(run)
    for _ in range(run.traffic["warmup_steps"]):
        env.step()
    env.episode = None  # the window starts an episode
    sync(run.device)
    env.phases.mark("warm-up")
    setup_s = time.perf_counter() - run.t_start

    env.reset_s.clear()
    resets0, records = env.resets, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        records.append(env.step())
    sync(run.device)
    window_s = time.perf_counter() - t0
    steps, resets = len(records), env.resets - resets0
    reset_s = list(env.reset_s)
    cfg = model_dict(run)
    b, actions = cfg["env_batch_size"], cfg["num_actions"]

    reading = None
    if run.trace and run.device.type == "cuda":
        n = run.traffic["profiled_episodes"]
        env.episode = None
        reading = profile(lambda: [env.step(spans=True) for _ in range(n * cfg["budget"])], SPANS)
        reading["kernel_bounds"] = {"nn_exact": k1_launches(cfg, n, n * cfg["budget"])}
        reading["units"] = n * cfg["budget"]
        env.episode = None
        reading["idle_gaps"] = profile(lambda: [env.step(spans=True) for _ in range(n * cfg["budget"])], SPANS,
                                       host=True)["idle_gaps"]
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    failed = sum(int((~np.isfinite(r["scores"])).sum()) for r in records)
    rng = np.random.default_rng(run.seed)
    picked = sorted(rng.choice(steps, size=min(steps, run.traffic["checked_steps"]), replace=False))
    checked = [records[i] for i in picked]
    root, weights = env.root, env.weights
    del records
    env.release()

    t1 = time.perf_counter()
    numbers = compare(checked, reference_steps(run, weights, root, checked))
    checks = [(name, float(numbers[name]), float(limit)) for name, limit in run.limits.items()]
    step_least, obs_least = greedy_step_seconds(cfg), observation_seconds(cfg)
    record = {
        "window_s": window_s,
        "window_units": steps,
        "least_s": steps * step_least["total"] + resets * obs_least["total"],
        "reset_s": reset_s,
        "trace": reading,
    }
    notes = [
        env.phases.note(),
        f"window: {steps} greedy steps and {resets} resets in {window_s:.3f} s; least time a step "
        f"{step_least['total'] * 1e3:.3f} ms ("
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in step_least.items() if k != "total")
        + f"), a reset {obs_least['total'] * 1e3:.3f} ms",
        "resets ms (quartiles, max): " + " ".join(
            f"{1e3 * q:.2f}" for q in np.percentile(reset_s or [math.nan], [25, 50, 75, 100])),
        f"reference: {time.perf_counter() - t1:.3f} s over steps {[int(i) for i in picked]}",
    ]
    return Outcome(
        end_to_end={"candidates_per_s": steps * b * actions / window_s, "setup_s": setup_s},
        record=record, checks=checks, attempted=steps * b * actions, failed=failed,
        memory_peak_bytes=int(peak), trace=reading, notes=notes,
    )
