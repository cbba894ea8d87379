"""The work an autoencoder train step requires, from the configuration's
shapes alone, and the least time it could take at the published peaks.

- The frozen deformation, forward only (``flops/vision.py``): both CNN
  pyramids at TF32, the three GCN stages at bf16, the positional MLP at
  float32.
- The encoder: the positional MLP (63 -> f/4 -> f/2 -> f) of each of the
  V deformed vertices at float32; the GCN stack over V vertices at bf16
  (its last layer aggregating all its columns); the MLP h -> 500 -> 400
  -> 300 -> latent at float32.
- The decoder at float32: the latent to the 512-wide code and each fold's
  first layer's share of the code once a cloud; per point the rest of
  each fold ((2 or 3) -> 512 -> 512 -> 3).
- The exact search (K1), float32: 9 operations a pair, (B·repeat, n)
  samples against the G = grid_size² decoded points, both ways.
- The sampler on the frozen mesh (24 bytes a sample, forward only: the
  frozen mesh takes no gradient) and the sorted segment sums (K2) of the
  Chamfer backward ((B·repeat, n) -> G: 16 bytes an entry read, 12 a
  segment written), at HBM speed.
A training step counts the encoder and the decoder three times (forward
and backward); the search and the frozen model run forward alone.
"""

from __future__ import annotations

import math

from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.flops.vision import VISION_VERTS, conv_flops, gcn_flops, gcn_stack_flops, mlp_flops, shapes
from benchmark.reference.autoencoder import CODE, DENSE, decoder_widths


def frozen_seconds(vision: dict, batch: int) -> dict:
    """Least seconds of the frozen deformation's forward over ``batch``
    rows, by part."""
    sh = shapes(vision)
    stage_verts = (VISION_VERTS, sh["verts"], sh["verts"])
    return {
        "frozen_conv": batch * 2 * conv_flops(vision) / PEAK_OPS["tf32"],
        "frozen_gcn": batch * sum(gcn_flops(vision, v, sh["features"]) for v in stage_verts) / PEAK_OPS["bf16"],
        "frozen_mlp": batch * sum(stage_verts) * mlp_flops(sh["features"]) / PEAK_OPS["fp32"],
    }


def encoder_flops(cfg: dict, verts: int) -> tuple[float, float]:
    """(bf16, float32) operations of one mesh's encoder forward."""
    f, h = cfg["feature_size"], cfg["hidden_gcn_size"]
    gcn = gcn_stack_flops(verts, f, h, h, cfg["num_gcn_layers"], cfg["cut"])
    widths = (h, *DENSE, cfg["encoding_size"])
    dense = sum(2.0 * a * b for a, b in zip(widths, widths[1:]))
    return gcn, verts * mlp_flops(f) + dense


def decoder_flops(cfg: dict) -> float:
    """One cloud's decoder forward: the code and the folds' code shares
    once, the rest per point."""
    w = decoder_widths(cfg["encoding_size"])
    per_cloud = 2.0 * (w[0][0] * CODE + 2 * CODE * CODE)
    per_point = sum(2.0 * (a - CODE if k in (1, 4) else a) * b for k, (a, b) in enumerate(w) if k)
    return per_cloud + cfg["grid_size"] ** 2 * per_point


def kernel_bounds(cfg: dict) -> dict:
    """{kernel name: (launches a train step, least seconds of those
    launches)}: K1 both ways, K2 once."""
    rows, n, g = cfg["batch_size"] * cfg["repeat"], cfg["number_points"], cfg["grid_size"] ** 2
    return {"nn_exact": (2, 2 * rows * n * g * 9.0 / PEAK_OPS["fp32"]),
            "segsum_sorted": (1, (rows * n * 16 + rows * g * 12) / PEAK_HBM_BYTES)}


def step_least_seconds(cfg: dict, vision: dict) -> dict:
    """Least seconds of one train step's required work, by part, and
    ``total``."""
    b = cfg["batch_size"]
    gcn, enc32 = encoder_flops(cfg, shapes(vision)["verts"])
    bounds = kernel_bounds(cfg)
    parts = {
        **frozen_seconds(vision, b),
        "encoder_gcn": 3 * b * gcn / PEAK_OPS["bf16"],
        "encoder_fp32": 3 * b * enc32 / PEAK_OPS["fp32"],
        "decoder": 3 * b * decoder_flops(cfg) / PEAK_OPS["fp32"],
        "search": bounds["nn_exact"][1],
        "sampler": b * cfg["repeat"] * cfg["number_points"] * 24 / PEAK_HBM_BYTES,
        "segsum": bounds["segsum_sorted"][1],
    }
    parts["total"] = math.fsum(parts.values())
    return parts
