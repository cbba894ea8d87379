"""Readings that set a cell's limits, for several seeds in one process:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--variants bf16 ...] [--seconds 20]

For each seed the program is set up as a run sets it up (and, where its
runner reads a training over time, trains for ``--seconds``) and read
against the reference; then the reference is put in the program's place as the
control (``bf16``: every part computed in bfloat16) and as the faults its
runner can plant there (``half``: half of each batch left out, the mean
taken over the rest; ``row0x2``: the first row's answer altered where it
is produced).  One JSON line a seed and variant on standard output.  The
benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

VARIANTS = {
    "recon": {"bf16": dict(dtype=torch.bfloat16), "half": dict(fault="half"), "row0x2": dict(fault="row0x2")},
    "greedy": {"bf16": dict(dtype=torch.bfloat16), "row0x2": dict(fault="row0x2")},
    "ddqn": {"bf16": dict(dtype=torch.bfloat16), "half": dict(fault="half"), "row0x2": dict(fault="row0x2")},
}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--variants", nargs="*", help="the variants read (all by default; none: the program alone)")
    parser.add_argument("--seconds", type=float, default=0.0, help="the training's length, untimed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for seed in args.seeds:
        run = harness.make_run(spec, args.workload, seed, args.seconds, False, "cuda", time.perf_counter())
        name = run.traffic["runner"]
        runner = importlib.import_module(f"benchmark.runners.{name}")
        try:
            chosen = {k: v for k, v in VARIANTS[name].items() if args.variants is None or k in args.variants}
            for line in runner.control(run, chosen):
                print(json.dumps({"workload": args.workload, "seed": seed, **line}, default=str), flush=True)
        finally:
            harness.shutil.rmtree(run.workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
