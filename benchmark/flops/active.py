"""The work of the active-touch env's observations and of the greedy
oracle's steps, from the configuration's shapes alone, and the least time
it could take at the published peaks.

- The deformation forward of each mesh scored (flops/vision.py's counts:
  GCN products at bf16, the positional MLP at float32); the convolutions
  once for each distinct image of a step (the env's chunks re-run the
  pyramids on every candidate's copy of the image: those repeats are not
  counted).
- The exact search (K1): every pair of both directions, 9 float32
  operations a pair, ``repeat`` samplings a mesh.
- The sampler's 24 bytes a sample each way at HBM speed.
- The autoencoder's encoder over each observed mesh (the latent the
  policies read): its positional MLP, its GCN stack (the last layer
  aggregating every feature) and its dense head.
The candidates a step requires are ``num_actions`` per env row; the
padding of a last short chunk is not counted.
"""

from __future__ import annotations

import math

from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.flops.vision import VISION_VERTS, conv_flops, gcn_flops, gcn_stack_flops, mlp_flops, shapes


def forward_seconds(cfg: dict, rows: int, images: int) -> dict:
    """Least seconds, by part, of ``rows`` meshes reconstructed from
    ``images`` distinct images, sampled and scored by exact search."""
    sh = shapes(cfg)
    stage_verts = (VISION_VERTS, sh["verts"], sh["verts"])
    n, r = cfg["number_points"], cfg["repeat"]
    return {
        "gcn": rows * sum(gcn_flops(cfg, v, sh["features"]) for v in stage_verts) / PEAK_OPS["bf16"],
        "conv": images * 2 * conv_flops(cfg) / PEAK_OPS["tf32"],
        "mlp": rows * sum(stage_verts) * mlp_flops(sh["features"]) / PEAK_OPS["fp32"],
        "search": rows * r * 2 * n * n * 9.0 / PEAK_OPS["fp32"],
        "sampler": rows * r * n * 24 / PEAK_HBM_BYTES,
    }


def encoder_seconds(cfg: dict, rows: int) -> float:
    """Least seconds of the autoencoder's encoder over ``rows`` meshes."""
    a, verts = cfg["autoencoder"], shapes(cfg)["verts"]
    f, h = a["feature_size"], a["hidden_gcn_size"]
    gcn = gcn_stack_flops(verts, f, h, h, a["num_gcn_layers"], a["cut"])
    widths = (h, 500, 400, 300, a["encoding_size"])
    dense = sum(2.0 * x * y for x, y in zip(widths, widths[1:]))
    return rows * (gcn / PEAK_OPS["bf16"] + (verts * mlp_flops(f) + dense) / PEAK_OPS["fp32"])


def _total(parts: dict) -> dict:
    parts["total"] = math.fsum(parts.values())
    return parts


def observation_seconds(cfg: dict) -> dict:
    """An observation of the env batch (each reset): its meshes from their
    images, their scores and their latents."""
    b = cfg["env_batch_size"]
    return _total({**forward_seconds(cfg, b, b), "encoder": encoder_seconds(cfg, b)})


def greedy_step_seconds(cfg: dict) -> dict:
    """A greedy step: every action scored for each env row, the best
    committed and observed."""
    b = cfg["env_batch_size"]
    cand = forward_seconds(cfg, b * cfg["num_actions"], b)
    obs = forward_seconds(cfg, b, 0)
    return _total({**{k: cand[k] + obs[k] for k in cand}, "encoder": encoder_seconds(cfg, b)})


def k1_launches(cfg: dict, resets: int, steps: int) -> tuple[int, float]:
    """(launches, least seconds) of the exact search over ``resets``
    observations of the env batch and ``steps`` greedy steps, at the
    launched shapes: per chunk of candidates two launches of
    (b·chunk·repeat, n) queries against n points, per observation two of
    (b·repeat, n)."""
    b, r, n = cfg["env_batch_size"], cfg["repeat"], cfg["number_points"]
    chunk = min(cfg["candidate_chunk"], cfg["num_actions"])
    chunks = -(-cfg["num_actions"] // chunk)
    per_pair = 9.0 * n * n / PEAK_OPS["fp32"]
    obs = (2, 2 * b * r * per_pair)
    step = (2 * chunks + 2, 2 * chunks * b * chunk * r * per_pair + obs[1])
    return resets * obs[0] + steps * step[0], resets * obs[1] + steps * step[1]
