"""The work a v_t_g step requires, from the configuration's shapes alone,
and the least time it could take at the published peaks.

- GCN products, bf16 operands: per layer and sample V·in·out·2 for the
  weight product and V²·k·2 for the adjacency product (k = round(cut·out)
  columns in a hidden layer, all 3 in the last).  Stage 1 runs on the
  1536 vision vertices, stages 2 and 3 on all V.
- Convolutions, TF32: H_out·W_out·C_out·C_in·k²·2 per layer, image and
  pyramid; each distinct image once.
- The positional MLP, float32: (63·f/4 + f/4·f/2 + f/2·f)·2 per vertex
  and stage.
- The clustered search, float32: 9 operations a pair, queries × T·S pairs
  each way (queries padded to whole tiles); the chunk selection's bound
  and vote arithmetic.
- The sampler (24 bytes a sample each way) and the segment sums of the
  backward (16 bytes an entry read, 12 a segment written) at HBM speed.
A training step counts the forward three times (forward and backward).
"""

from __future__ import annotations

import math

from benchmark.flops.peaks import PEAK_HBM_BYTES, PEAK_OPS
from benchmark.reference.vision import encoder_plan

VISION_VERTS, TOUCH_VERTS = 1536, 25
VISION_FACES, TOUCH_FACES = 1728, 32


def _pad(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def shapes(cfg: dict) -> dict:
    charts = (1 if cfg["finger"] else 4) * cfg["num_grasps"]
    _, _, channels = encoder_plan(cfg["num_cnn_blocks"], cfg["layers_per_block"], cfg["cnn_kernel"])
    return {
        "charts": charts,
        "verts": VISION_VERTS + TOUCH_VERTS * charts,
        "faces": VISION_FACES + TOUCH_FACES * charts,
        "features": sum(channels),
    }


def gcn_stack_flops(verts: int, features: int, hidden: int, out: int, layers: int, cut: float) -> float:
    """One GCN stack's forward over ``verts`` vertices, one sample: per
    layer V·in·out·2 for the weight product and V²·k·2 for the adjacency
    product, k = round(cut·out) columns in a hidden layer and all of the
    last layer's."""
    total = 0.0
    for i in range(layers):
        a = features if i == 0 else hidden
        b = out if i == layers - 1 else hidden
        k = b if i == layers - 1 else round(b * cut)
        total += 2.0 * verts * a * b + 2.0 * verts * verts * k
    return total


def gcn_flops(cfg: dict, verts: int, features: int) -> float:
    """One of the deformation's GCN stacks (out to the 3 coordinates)."""
    return gcn_stack_flops(verts, features, cfg["hidden_gcn_size"], 3, cfg["num_gcn_layers"], cfg["cut"])


def conv_flops(cfg: dict, size: int = 256) -> float:
    """One pyramid's forward over one image."""
    specs, _, _ = encoder_plan(cfg["num_cnn_blocks"], cfg["layers_per_block"], cfg["cnn_kernel"], size)
    k, cin, total = cfg["cnn_kernel"], 3, 0.0
    for feats, stride, _ in specs:
        size = size // stride if stride > 1 else size
        total += 2.0 * size * size * feats * cin * k * k
        cin = feats
    return total


def mlp_flops(features: int) -> float:
    """The positional MLP's forward (63 -> f/4 -> f/2 -> f), one vertex."""
    f = features
    return 2.0 * (63 * (f // 4) + (f // 4) * (f // 2) + (f // 2) * f)


def search(cfg: dict) -> dict:
    """The clustered search's launches of one loss: per direction the
    pairs K3 scans and the selection's operations and bytes."""
    c = cfg["clustered_search"]
    s, t_max, tile, factor = c["chunk"], c["chunks_per_tile"], c["tile"], c["candidate_factor"]
    rows = cfg["batch_size"] * cfg["repeat"]
    n = _pad(cfg["number_points"], tile)  # queries and references, padded alike
    chunks = n // s
    t = min(t_max, chunks)
    cand = min(factor * t, chunks)
    tiles = rows * (n // tile)
    bounds = (8 * chunks if cand < chunks else 0) + 257 * cand
    select_ops = tiles * (10.0 * bounds + 3 * tile * cand)
    out = []
    for distinct in (cfg["batch_size"], rows):  # predictions -> gt clouds, gt -> predictions
        moved = (rows * n * 3 + distinct * chunks * 4 + tiles * 3 + tiles * t) * 4
        out.append({"pairs": rows * n * t * s, "select_ops": select_ops, "select_bytes": moved})
    return {"directions": out}


def kernel_bounds(cfg: dict, train: bool) -> dict:
    """{kernel name: (launches a step, least seconds of those launches)}
    for the clustered search (K3), the chunk selection and, in training,
    the segment sums (K2)."""
    sh, fp32, hbm = shapes(cfg), PEAK_OPS["fp32"], PEAK_HBM_BYTES
    d = search(cfg)["directions"]
    out = {
        "nn_cluster": (len(d), sum(9.0 * x["pairs"] for x in d) / fp32),
        "select_chunks": (len(d), sum(max(x["select_ops"] / fp32, x["select_bytes"] / hbm) for x in d)),
    }
    if train:
        b, r, n = cfg["batch_size"], cfg["repeat"], cfg["number_points"]
        # both clouds' streams -> each prediction cloud's points
        loss_stream = b * r * 2 * n * 16 + b * r * n * 12
        # 3 corners x B rows of R n samples -> the faces
        sampler_stream = 3 * b * r * n * 16 + 3 * b * sh["faces"] * 12
        out["segsum_sorted"] = (2, (loss_stream + sampler_stream) / hbm)
    return out


def step_least_seconds(cfg: dict, train: bool) -> dict:
    """Least seconds of one step's required work, by part, and ``total``."""
    sh, b = shapes(cfg), cfg["batch_size"]
    mult = 3.0 if train else 1.0
    stage_verts = (VISION_VERTS, sh["verts"], sh["verts"])
    gcn = sum(gcn_flops(cfg, v, sh["features"]) for v in stage_verts)
    samples = b * cfg["repeat"] * cfg["number_points"]
    d = search(cfg)["directions"]
    parts = {
        "gcn": mult * b * gcn / PEAK_OPS["bf16"],
        "conv": mult * b * 2 * conv_flops(cfg) / PEAK_OPS["tf32"],
        "mlp": mult * b * sum(stage_verts) * mlp_flops(sh["features"]) / PEAK_OPS["fp32"],
        "search": sum(9.0 * x["pairs"] for x in d) / PEAK_OPS["fp32"],
        "select": sum(max(x["select_ops"] / PEAK_OPS["fp32"], x["select_bytes"] / PEAK_HBM_BYTES) for x in d),
        "sampler": (2 if train else 1) * samples * 24 / PEAK_HBM_BYTES,
    }
    if train:
        parts["segsum"] = kernel_bounds(cfg, True)["segsum_sorted"][1]
    parts["total"] = math.fsum(parts.values())
    return parts
