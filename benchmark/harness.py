"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
hands the run to the runner its traffic mix names, and prints the
result's line.  Nothing here knows a cell, a configuration or a metric by
name."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# compared by whole top-level name: the port's name begins with the JAX
# package's
BANNED = ("jax", "jaxlib", "flax", "optax", "active_3d_vision_and_touch_tpu")


@dataclass
class Run:
    cell: str
    entry: dict  # the cell's entry in BENCHMARK.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    limits: dict  # limits/<cell>.json: {number: limit}
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at the process's start
    workdir: Path  # the run's scratch world, a new directory under TMPDIR


@dataclass
class Outcome:
    end_to_end: dict  # {metric: value}
    record: dict  # what the per-layer readers read
    checks: list  # [(number, value, limit)]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: dict | None = None
    notes: list = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def make_run(spec: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Run:
    entry = next(w for w in spec["workloads"] if w["name"] == cell)
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Run(
        cell=cell, entry=entry,
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{cell}.json"),
        seed=seed, seconds=seconds, trace=trace, device=torch.device(device), t_start=t_start,
        workdir=Path(tempfile.mkdtemp(prefix=f"benchmark_{cell}_")),
    )


def execute(run: Run) -> Outcome:
    runner = importlib.import_module(f"benchmark.runners.{run.traffic['runner']}")
    try:
        return runner.run(run)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded by path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str, spec: dict) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list, else
    every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in spec["end_to_end"] if m["name"] == metric["moves"])
        return reports(moved, cell, spec)
    return True


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unreadable ({e})"


def _finite(x: float):
    return x if math.isfinite(x) else str(x)


def result_line(spec: dict, run: Run, out: Outcome) -> dict:
    metrics = {}
    if run.trace:
        for m in spec["per_layer"]:
            if reports(m, run.cell, spec):
                value = metric_reader(m["name"]).read(out.record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if reports(m, run.cell, spec):
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    device = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu",
        "count": run.entry["chips"],
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"], "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {n: {"value": _finite(v), "limit": lim} for n, v, lim in out.checks}
    return line


def main(argv: list[str], t_start: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    run = make_run(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    out = execute(run)
    banned = banned_modules()
    if banned:
        print(f"modules of JAX or the JAX package were loaded: {banned}", file=sys.stderr)
        return 3
    line = result_line(spec, run, out)
    print(f"card: {card()}", file=sys.stderr)
    for note in out.notes:
        print(note, file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
