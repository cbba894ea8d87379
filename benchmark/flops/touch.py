"""The work a touch-chart step requires, from the configuration's shapes
alone, and the least time it could take at the published peaks.

- Convolutions, TF32: H_out·W_out·C_out·C_in·k²·2 for each of the 18
  layers, a row.
- The MLP 512 -> 256 -> 128 -> 75, float32: 2·(512·256 + 256·128 +
  128·75) a row.
- The exact search (K1), float32: 9 operations a pair, (B·repeat, n)
  queries against n points each way.
- The sampler (24 bytes a sample each way) and the sorted segment sums
  (K2) of the Chamfer backward ((B·repeat, n) -> n) and of the sampler
  backward (3 corners x B rows of repeat·n samples -> the chart's faces):
  16 bytes an entry read, 12 a segment written, at HBM speed.
A training step counts the convolutions and the MLP three times (forward
and backward); the search runs in the forward alone.
"""

from __future__ import annotations

import math

from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.reference.touch import FEATURES, KERNEL, MLP

IMAGE_SIZE = 121
CHART_FACES = 32


def conv_layers(size: int = IMAGE_SIZE) -> list[tuple[int, int, int]]:
    """(output size, output features, input features) of the 18
    convolutions."""
    out, cin = [], 3
    for feats in FEATURES:
        size = (size - 1) // 2 + 1  # 5x5 at stride 2, padding 2
        out += [(size, feats, cin), (size, feats, feats), (size, feats, feats)]
        cin = feats
    return out


def conv_flops(size: int = IMAGE_SIZE) -> float:
    """The encoder's convolutions, one row's forward."""
    return sum(2.0 * s * s * o * i * KERNEL * KERNEL for s, o, i in conv_layers(size))


def mlp_flops() -> float:
    return sum(2.0 * a * b for a, b in zip(MLP, MLP[1:]))


def kernel_bounds(cfg: dict) -> dict:
    """{kernel name: (launches a train step, least seconds of those
    launches)}: K1 both ways, K2's two launches."""
    b, r, n = cfg["batch_size"], cfg["repeat"], cfg["num_samples"]
    loss_stream = b * r * n * 16 + b * r * n * 12  # (B·R, n) -> the n points of each prediction
    sampler_stream = 3 * b * r * n * 16 + 3 * b * CHART_FACES * 12  # (3B, R·n) -> the faces
    return {"nn_exact": (2, 2 * b * r * n * n * 9.0 / PEAK_OPS["fp32"]),
            "segsum_sorted": (2, (loss_stream + sampler_stream) / PEAK_HBM_BYTES)}


def step_least_seconds(cfg: dict) -> dict:
    """Least seconds of one train step's required work, by part, and
    ``total``."""
    b = cfg["batch_size"]
    bounds = kernel_bounds(cfg)
    parts = {
        "conv": 3 * b * conv_flops() / PEAK_OPS["tf32"],
        "mlp": 3 * b * mlp_flops() / PEAK_OPS["fp32"],
        "search": bounds["nn_exact"][1],
        "sampler": 2 * b * cfg["repeat"] * cfg["num_samples"] * 24 / PEAK_HBM_BYTES,
        "segsum": bounds["segsum_sorted"][1],
    }
    parts["total"] = math.fsum(parts.values())
    return parts
