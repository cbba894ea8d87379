"""Runner of the latent DDQN policy's training, as the policy's trainer runs
it: ``DDQNEngine.train_epoch`` repeated over the split, each epoch its
episodes (``reset``, then the budget's env steps, each with an ε-greedy
action, a push to the replay and an update), target syncs and the
epoch's ``save``.

The traffic mix gives the ``split`` read, the objects written to each split
(``world``), the gt cloud's points (``cloud_points``), the env batches run
before the window (``warmup_batches``: the replay's burn-in), the
window's env steps held against the reference (``checked_steps``, drawn
from all of the window's), the run's first updates held against the
reference (``checked_update_span``: the set-up's and then the window's,
each loss, and the parameters after ``checked_updates`` of them drawn from
the seed and after the last) and the env batches profiled under ``--trace
1`` (``profiled_batches``).

The benchmark reads, without changing them, what the program computes:
each observation where ``compute_obs`` returns it (with the env
generator's state before it, and the actions committed in its episode),
each reward where ``step`` returns it, each update's replay batch and
loss, each target sync, and the online net's parameters at the compared
points.  The reference works the observations out again from the world's
files and the actions taken, and runs its own training from the seeded
weights through the run's first ``checked_update_span`` updates, on the
program's replay batches, with the syncs where the program made them.
Two trainings whose Adam arithmetic differs by rounding alone jump apart
after some tens to hundreds of updates (on the CPU, with an Adam in
another order, the earliest of 12 seeds after 63), so the span stays
short of that: a later change to the optimizer's rounding is no fault.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.runners.common import Phases, sync
from benchmark.runners.greedy import build_env, chart_caches, model_dict
from benchmark.flops.active import k1_launches, observation_seconds
from benchmark.harness import Outcome, Run
from benchmark.reference.compare import ddqn_numbers
from benchmark.reference.policy import ObservationReference, ddqn_training
from benchmark.trace import profile
from benchmark.weights import module_specs, seeded_weights


class Learner:
    """The program after set-up: the DDQN engine over its env and world,
    the seeded weights, and what the benchmark read from each call."""

    def __init__(self, run: Run):
        from active_3d_vision_and_touch_tpu_torch.active.policies.ddqn import DDQNEngine

        self.phases = Phases(run.t_start)
        self.root, cfg, self.weights, self.auto_weights, self.env = build_env(
            run, self.phases, exp_type="ddqn")
        env, dev = self.env, run.device
        self.engine = engine = DDQNEngine(cfg, data_root=str(self.root), env=env, device=dev)
        self.nets = seeded_weights(module_specs(engine.model), run.seed ^ 0xD0, dev)
        engine.model.load_state_dict(self.nets)
        engine.target_model.load_state_dict(self.nets)

        self.observations, self.episode, self.taken = [], None, []
        # every update's replay batch and loss, the update counts at which
        # the target net was synced, the parameters after ``kept`` updates
        self.batches, self.losses, self.syncs, self.kept, self.after = [], [], [], set(), {}
        self.span = 0
        compute_obs, step, update_on = env.compute_obs, env.step, engine.update_on
        sync_target = engine.target_model.load_state_dict

        def observed(actions=None):
            if actions is None:
                self.episode, self.taken = env.current["batch"], []
            else:
                self.taken = self.taken + [np.array(actions).reshape(-1)]
            record = {"batch": self.episode, "taken": self.taken, "state": env.generator.get_state()}
            obs = compute_obs(actions)
            record.update(score=obs["score"], latent=obs["latent"])
            self.observations.append(record)
            return obs

        def stepped(actions):
            obs, reward, done = step(actions)
            self.observations[-1]["reward"] = reward
            return obs, reward, done

        def updated(batch):
            self.batches.append({n: np.array(v) for n, v in batch.items()})
            loss = update_on(batch)
            self.losses.append(loss)
            if len(self.batches) in self.kept:
                self.keep()
            return loss

        def synced(state, *args, **kwargs):
            self.syncs.append(len(self.batches))
            return sync_target(state, *args, **kwargs)

        env.compute_obs, env.step, engine.update_on = observed, stepped, updated
        engine.target_model.load_state_dict = synced
        self.phases.mark("engine")

    def keep(self) -> None:
        """The online net's parameters after the updates so far."""
        self.after[len(self.batches)] = {n: p.detach().clone() for n, p in self.engine.model.named_parameters()}

    def steps(self) -> int:
        return sum(1 for r in self.observations if "reward" in r)

    def release(self) -> None:
        self.env.sampler.disconnect()
        del self.env, self.engine
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def program_readings(learner: Learner, steps: list) -> dict:
    """What the program gave at the sampled env steps ((previous, this)
    observation records), at every update and at the kept points."""
    return {
        "obs": [{"scores": (prev["score"], this["score"]), "latents": (prev["latent"], this["latent"]),
                 "reward": this["reward"]} for prev, this in steps],
        "losses": [float(x) for x in learner.losses[:learner.span]],
        "after": learner.after,
    }


def reference_readings(run: Run, learner: Learner, steps: list,
                       dtype=torch.float32, fault: str | None = None) -> dict:
    """The reference's readings of the same env steps, worked out again from
    the world's files, the actions taken and the generator's states, and its
    own training from the seeded weights over the program's replay batches;
    in ``dtype``, with ``fault`` ("row0x2": the first row's score doubled
    where it is produced; "half": each update on half of its batch)."""
    cfg, obs = model_dict(run), []
    for prev, this in steps:
        batch = this["batch"]
        ref = ObservationReference(cfg, learner.weights, learner.auto_weights,
                                   chart_caches(learner.root, batch["names"]), run.device, dtype=dtype)
        got = []
        for r in (prev, this):
            gen = torch.Generator(device=run.device)
            gen.set_state(r["state"])
            score, latent = ref.observe(batch["img"], batch["gt_points"], r["taken"], gen)
            if fault == "row0x2":
                score = np.concatenate([2 * score[:1], score[1:]])
            got.append((score, latent))
        obs.append({"scores": (got[0][0], got[1][0]), "latents": (got[0][1], got[1][1]),
                    "reward": got[0][0] - got[1][0]})
    trained = ddqn_training(cfg, learner.nets, learner.batches[:learner.span], learner.syncs, set(learner.after),
                            run.device, dtype=dtype, fault=fault if fault == "half" else None)
    return {"obs": obs, **trained}


def compare(prog: dict, ref: dict, learner: Learner) -> dict:
    return ddqn_numbers(prog, ref, learner.nets)


def sample_checks(run: Run, learner: Learner, first: int, last: int) -> list:
    """(previous, this) observation records of ``checked_steps`` env steps
    drawn from the seed among the window's, records ``first`` to ``last``."""
    rng = np.random.default_rng(run.seed)
    at = [i for i in range(max(first, 1), last) if "reward" in learner.observations[i]]
    picked = sorted(rng.choice(at, size=min(len(at), run.traffic["checked_steps"]), replace=False))
    return [(learner.observations[i - 1], learner.observations[i]) for i in picked]


def prepare(run: Run) -> Learner:
    learner = Learner(run)
    rng = np.random.default_rng(run.seed ^ 0x5A)
    learner.span = span = run.traffic["checked_update_span"]
    learner.kept = {span} | {1 + int(k) for k in
                             rng.choice(span, size=min(span, run.traffic["checked_updates"]), replace=False)}
    learner.engine.train_epoch(max_batches=run.traffic["warmup_batches"])
    sync(run.device)
    learner.phases.mark("warm-up")
    return learner


def finish(learner: Learner) -> None:
    """Compare the kept points the run reached, and a run shorter than the
    span at its end."""
    learner.span = min(learner.span, len(learner.batches))
    if learner.span not in learner.after:
        learner.keep()
    learner.after = {k: v for k, v in learner.after.items() if k <= learner.span}


def run(run: Run) -> Outcome:
    learner = prepare(run)
    setup_s = time.perf_counter() - run.t_start

    first, steps0 = len(learner.observations), learner.steps()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        learner.engine.train_epoch()
    sync(run.device)
    window_s = time.perf_counter() - t0
    last = len(learner.observations)
    steps = learner.steps() - steps0
    resets = last - first - steps
    cfg = model_dict(run)
    b = cfg["env_batch_size"]

    reading = None
    if run.trace and run.device.type == "cuda":
        n0, s0 = len(learner.observations), learner.steps()
        stretch = lambda: learner.engine.train_epoch(max_batches=run.traffic["profiled_batches"])  # noqa: E731
        reading = profile(stretch)
        obs, env_steps = len(learner.observations) - n0, learner.steps() - s0
        reading["transitions"] = reading["units"] = b * env_steps
        reading["kernel_bounds"] = {"nn_exact": k1_launches(cfg, obs, 0)}
        reading["idle_gaps"] = profile(stretch, host=True)["idle_gaps"]
    finish(learner)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    failed = sum(int((~np.isfinite(r["score"])).sum()) for r in learner.observations[first:last])
    checked = sample_checks(run, learner, first, last)
    prog = program_readings(learner, checked)
    learner.release()

    t1 = time.perf_counter()
    numbers = compare(prog, reference_readings(run, learner, checked), learner)
    checks = [(name, float(numbers[name]), float(limit)) for name, limit in run.limits.items()]
    obs_least = observation_seconds(cfg)["total"]
    record = {"window_s": window_s, "window_units": b * steps, "least_s": (steps + resets) * obs_least,
              "trace": reading}
    notes = [
        learner.phases.note(),
        f"window: {steps} env steps, {resets} resets in {window_s:.3f} s; {len(learner.batches)} updates "
        f"and {len(learner.syncs)} target syncs in the run; "
        f"least time an observation {obs_least * 1e3:.3f} ms",
        f"reference: {time.perf_counter() - t1:.3f} s over {len(checked)} env steps and the first {learner.span} "
        f"updates; parameters compared after {sorted(learner.after)} updates",
        "numbers: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()),
    ]
    return Outcome(
        end_to_end={"transitions_per_s": b * steps / window_s, "setup_s": setup_s},
        record=record, checks=checks, attempted=b * steps, failed=failed,
        memory_peak_bytes=int(peak), trace=reading, notes=notes,
    )


def control(run: Run, variants: dict) -> list[dict]:
    """Readings that set the limits: the program's training from its
    set-up through ``run.seconds`` of train epochs (untimed), its sampled
    env steps and its training against the reference, then the reference
    in the program's place in each of ``variants`` ({name: keyword
    arguments of ``reference_readings``})."""
    learner = prepare(run)
    first = len(learner.observations)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        learner.engine.train_epoch()
    finish(learner)
    checked = sample_checks(run, learner, first, len(learner.observations))
    prog = program_readings(learner, checked)
    learner.release()
    t0 = time.perf_counter()
    ref = reference_readings(run, learner, checked)
    out = [{"variant": "program", "seconds": time.perf_counter() - t0, "updates": learner.span,
            **compare(prog, ref, learner)}]
    for name, kwargs in variants.items():
        t0 = time.perf_counter()
        got = reference_readings(run, learner, checked, **kwargs)
        out.append({"variant": name, "seconds": time.perf_counter() - t0, **compare(got, ref, learner)})
    return out
