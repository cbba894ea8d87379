"""Headline benchmark of the port: full-size vision+touch training steps a
second on one card.

The port's counterpart of the repository's root ``bench.py`` (the JAX
benchmark, which stays as it is).  It measures train steps a second of the
flagship v_t_g ``Deformation`` model (two image-encoder pyramids, three
20-layer GCN stages over the fused chart atlas, the 30k-point 3-repeat
Chamfer loss) at batch 16, at the default ``loss_nn`` ("clustered": the
chunk selection, K3 and K2).  ``vs_baseline`` is measured in the same run
on the same card: the same step with the Chamfer search forced to the
port's plain brute force (``loss_nn="xla"``).

    python -m active_3d_vision_and_touch_tpu_torch.bench

prints one JSON line with the root benchmark's keys, and the card's name
and power limit as ``nvidia-smi`` gives them.  Unlike the root benchmark it
quotes no clustered-search agreement: the agreement files in the
repository were measured by the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.core.config import VisionConfig
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

METRIC = "vision_touch_train_steps_per_sec_bs16"


def bench_config(loss_nn: str) -> VisionConfig:
    return VisionConfig(
        use_img=True,
        use_touch=True,
        finger=False,
        batch_size=16,
        number_points=30000,
        loss_nn=loss_nn,
        eval=True,
    )


def bench_batch(config: VisionConfig, seed: int = 0) -> dict:
    """The root benchmark's seeded batch."""
    rng = np.random.default_rng(seed)
    b = config.batch_size
    return {
        "img": rng.uniform(size=(b, 256, 256, 3)).astype(np.float32),
        "gt_points": rng.normal(size=(b, config.number_points, 3)).astype(np.float32) * 0.1,
        "touch_charts": rng.normal(size=(b, config.num_grasps, 4, 25, 4)).astype(np.float32)
        * 0.1,
    }


def measure_steps_per_sec(loss_nn: str, steps: int, windows: int = 1) -> float:
    """Median over ``windows`` of the train steps a second of ``steps``
    steps, after one warm-up step; ``torch.cuda.synchronize()`` fences
    each window."""
    config = bench_config(loss_nn)
    engine = VisionEngine(config, log=False)
    engine.build()
    batch = engine.to_device(bench_batch(config))
    # every step's generator made before the timed windows, as the root
    # benchmark derives its keys ahead of time
    gens = [engine.step_generator(j) for j in range(windows * steps + 1)]
    engine.train_step(batch, gens[-1])
    torch.cuda.synchronize(engine.device)
    rates = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(steps):
            engine.train_step(batch, gens[w * steps + i])
        torch.cuda.synchronize(engine.device)
        rates.append(steps / (time.perf_counter() - t0))
    return float(np.median(rates))


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> dict:
    loss_nn = VisionConfig().loss_nn  # the shipped training default
    value = measure_steps_per_sec(loss_nn, 40, 5)
    xla = measure_steps_per_sec("xla", 6, 3)
    payload = {
        "metric": METRIC,
        "value": round(value, 4),
        "unit": "steps/s",
        "vs_baseline": round(value / xla, 4),
        "baseline": "same step, Chamfer search forced to the plain brute force (loss_nn='xla')",
        "xla_baseline_steps_per_sec": round(xla, 4),
        "loss_nn": loss_nn,
        "card": card(),
    }
    print(json.dumps(payload))
    return payload


if __name__ == "__main__":
    main()
