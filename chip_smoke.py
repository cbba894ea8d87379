#!/usr/bin/env python3
"""Build and time the port's hand-written CUDA kernels on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

from the root of a checkout.  It imports nothing of JAX or of the JAX
package.  It holds each kernel to its plain version at every shape it times,
and ends by running the port's checks on the card, which hold the kernels on
their seeded cases and the paths, the policies, the command line and the
multi-rank layer; they also run alone:

    python -m pytest tests/test_torch_kernels.py tests/test_torch_step_graph.py \\
        tests/test_torch_card.py -q -m cuda --noconftest

A failed check is printed as ``FAILED: ...`` and the run goes on; the script
exits with 1 if any check failed.  It prints, in order:

1. the environment: the python, torch and CUDA versions, the card's name
   and power limit, and the TF32 settings, set explicitly;
2. the build: every kernel from ``csrc/``, built afresh (its library is
   removed first), one ``nvcc`` each, all started together, with its
   registers and spills (a spill, or no register line, fails), and the
   instruction mix of the exact and the pruned nearest-neighbour kernels'
   scan loops as built (``cuobjdump -sass``);
3. CUDA-event timings (the median of repeated launches) of each kernel, of
   its plain PyTorch version and, where one exists, of the single PyTorch
   call that computes the same function, beside the kernel's bound, at the
   shapes the paths give it, each held to its plain version there:
   - K1 (``nn_exact``) at the v_t_g step's (48, 30000) x 30000, the touch
     step's (192, 4000) x 4000, the autoencoder's (48, 30000) x 6400, a
     chunk of the environment's candidates (90, 30000) x 30000, a chunk of
     the supervised policy's probes (45, 30000) x 30000, one observation
     (9, 30000) x 30000, and one of 4 shards of the v_t_g distance either
     way, (48, 30000) x 7500 and (48, 7500) x 30000; distances and indices
     equal to the plain version's, both ways;
   - K3 (``nn_cluster``) and the chunk selection (``select_chunks``) at the
     clustered step's shapes, with the prep of one clustered loss (Morton
     sorts, padding, selection) and K3's agreement with K1 there, and K3 on
     a shard either way; the table and K3 equal to their plain versions,
     K3 never nearer than K1, and at the train step the same distance as
     K1 for at least 0.90 of the queries; the selection of one loss must be
     no slower than its torch-op version;
   - K2 (``segsum_sorted``) on the backward streams: the v_t_g step's,
     the touch step's, the clustered loss's (48, 60000) (also with its
     stable sort), the autoencoder's, the sampler's of the vision and of the
     touch step, and one face taking every sample of a row; each single,
     as 20 calls between one pair of events, and as 20 calls replayed from
     a CUDA graph (the device's time alone), beside ``scatter_add_``, which
     the kernel must not be slower than by the device's time (on every
     stream but the last, which is one address for the library's atomics);
     within 1e-5 x (1 + the segment's sum of |v|) of its plain version and
     bit-equal over two calls;
4. the ``cuda`` tests above, in a child process;
5. a ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
   ``{"ok": <no check failed>, "device": {...}}``.

The ``kernels`` line holds one entry a kernel: its source, the TPU kernel it
replaces, its times at each shape, and ``max_abs_err``, its largest
difference from its plain version at the timed shapes.  ``launches``,
``launches_by_path`` and K3's ``agreement_on_generated`` are null: the
``cuda`` tests count the paths' launches and hold K3 against K1 on generated
clouds.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from active_3d_vision_and_touch_tpu_torch.core import touch_chart
from active_3d_vision_and_touch_tpu_torch.ops import (
    KERNELS,
    NN_CLUSTER,
    NN_EXACT,
    SEGSUM,
    SELECT_CHUNKS,
)
from active_3d_vision_and_touch_tpu_torch.ops import chamfer_cluster as cluster
from active_3d_vision_and_touch_tpu_torch.ops._cuda import build_all, nvcc_path
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import REPEAT, min_dists, min_dists_plain
from active_3d_vision_and_touch_tpu_torch.ops.sample import draw_sample_noise, sample_faces
from active_3d_vision_and_touch_tpu_torch.ops.segsum import (
    scatter_add_3,
    segment_accumulate_sorted,
    segment_sum_plain,
)
from active_3d_vision_and_touch_tpu_torch.testing import (
    CHUNK,
    CHUNKS_PER_TILE,
    MIN_AGREEMENT,
    clustered_clouds,
    clustered_searches,
    folded_samples,
    sorted_padded,
    surface_clouds,
    vtg_mesh,
)

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SM_LANES = 132 * 128  # an H100 SXM: 132 SMs, each issuing for 4 x 32 lanes a clock
N = 30000  # the v_t_g step's points a cloud
CUDA_TESTS = ("tests/test_torch_kernels.py", "tests/test_torch_step_graph.py", "tests/test_torch_card.py")
# the autoencoder's decoded points (its 80 x 80 folding grid), the
# environment's candidates per scoring pass (score_candidates' default
# chunk) and the supervised policy's probes (PolicyConfig.training_actions)
AE_POINTS, ENV_CHUNK, PROBES = 80 * 80, 10, 5
# K1's time targets by shape, on a card at its 700 W limit.  They are
# printed as met or missed and fail nothing: a card set to a lower limit
# runs slower.  The same for K3, either way, and for the chunk selection
# of one loss (both directions, with the torch ops that feed the kernel)
K1_TARGET_MS = {
    "main": 16.0, "touch_shape": 1.25, "autoencoder_shape": 3.2, "env_chunk_shape": 28.0,
    "probe_chunk_shape": 14.0, "observation_shape": 4.0,
}
K3_TARGET_MS, SELECT_TARGET_MS = 1.50, 2.0


FAILED: list[str] = []


def check(cond: bool, msg: str) -> None:
    """Records and prints a failed check; the run goes on."""
    if not cond:
        FAILED.append(msg)
        print(f"FAILED: {msg}", flush=True)


def time_ms(fn, reps: int = 10, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, after a warm-up.  With ``inner`` = 1 a call of a few
    tens of microseconds is timed with the host's enqueue time in it; many
    calls between one pair of events leave the device's time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def graph_ms(fn, reps: int = 10, inner: int = 20) -> float:
    """Device time of one call of ``fn``: ``inner`` calls captured into a
    CUDA graph, the median over ``reps`` replays, per call.  No host work
    lies between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return time_ms(graph.replay, reps) / inner


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms_and_clock(fn, reps: int = 20, inner: int = 1) -> tuple[float, int]:
    """:func:`time_ms` of ``fn`` and the SM clock in MHz that ``nvidia-smi``
    reads while the launches run.  The query takes longer than a few short
    launches, so a short ``fn`` is given an ``inner`` that keeps the card
    busy for some tens of milliseconds."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    ms = time_ms(fn, reps, inner)
    return ms, int(smi.communicate(timeout=60)[0].split()[0])


def phase_environment() -> str:
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    # the GCN's large products are bf16 with float32 accumulation by design
    # (models/gcn.py); the remaining float32 matmuls stay full float32 and
    # the convolutions use TF32, PyTorch's defaults, set here explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = nvidia_smi("name,power.limit")
    print(f"card: {card}  devices: {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    for k in KERNELS:  # a library already built prints no ptxas lines to hold
        k.library.unlink(missing_ok=True)
    seconds = build_all(list(KERNELS))
    print(f"build: {len(KERNELS)} kernels in {seconds:.2f} s")
    for k in KERNELS:
        used = [ln.strip() for ln in k.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {k.name}: {'; '.join(used)}")
        check(any("registers" in ln for ln in used), f"{k.name}: ptxas printed no register line")
        check(all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in used if "spill" in ln),
              f"{k.name}: ptxas reports register spills")
    for k in (NN_EXACT, NN_CLUSTER):
        print(f"  {k.name} scan loop as built: {sass_inner_loop(k)}")


def sass_inner_loop(kernel) -> str:
    """The instruction mix of the built kernel's scan loop, read from
    ``cuobjdump -sass``: among the spans closed by a backward branch, the
    one densest in FMUL.  A pair of points takes 3 FMUL, so the span's FMUL
    count gives the pairs one pass of the loop serves."""
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return "cuobjdump not found: not read"
    out = subprocess.run([str(cuobjdump), "-sass", str(kernel.library)],
                         capture_output=True, text=True, timeout=300).stdout
    code = [(int(a, 16), op) for a, op in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)[^\n]*;", out)]
    loops = []
    for addr, target in re.findall(r"/\*([0-9a-f]{4,})\*/[^\n]*\bBRA\s+0x([0-9a-f]+)", out):
        lo, hi = int(target, 16), int(addr, 16)
        if lo <= hi:
            ops = [op.split(".")[0] for a, op in code if lo <= a <= hi]
            loops.append((ops.count("FMUL") / len(ops), ops))
    density, ops = max(loops, default=(0.0, []))
    if density == 0.0:
        return "no loop with FMUL found: not read"
    pairs = ops.count("FMUL") / 3
    mix = sorted(((ops.count(op), op) for op in set(ops)), reverse=True)
    return (f"{len(ops)} instructions for {pairs:.0f} pairs, {len(ops) / pairs:.2f} a pair: "
            + ", ".join(f"{n} {op}" for n, op in mix[:8])
            + f", {sum(n for n, _ in mix[8:])} others")


def make_clouds(g: torch.Generator) -> dict:
    """The kernels' inputs at the paths' shapes, from one seed.  Prediction
    clouds are 3 x 30k area-weighted samples of the initial v_t_g atlas (its
    touch slots at 0, as the vision step fuses them) per mesh, folded onto
    the batch; gt clouds are Gaussian (``gt``, the v_t_g step's; ``decoded``,
    the autoencoder's 6400 points; the touch step's few-millimetre clouds)
    or surface-like (``surface``, the clustered step's 16; the env's 3; the
    shards'), drawn from ``g`` on its device."""
    dev = g.device
    verts, faces = vtg_mesh(dev)
    folded = lambda meshes: folded_samples(verts.expand(meshes, -1, -1), faces, N, g)  # noqa: E731
    tiled = lambda t, k=1: t.repeat_interleave(k, 0).repeat(REPEAT, 1, 1)  # noqa: E731
    chart = touch_chart()
    gt3 = surface_clouds(3, N, g, dev)
    return {
        **clustered_clouds(g, dev, N),
        "gt": tiled(torch.randn(16, N, 3, device=dev, generator=g) * 0.1),
        "touch_preds": folded_samples(torch.as_tensor(chart.verts, device=dev)[None].expand(64, -1, -1),
                                      torch.as_tensor(chart.faces, device=dev).long(), 4000, g),
        "touch_gt": tiled(torch.randn(64, 4000, 3, device=dev, generator=g) * 0.005),
        "decoded": tiled(torch.randn(16, AE_POINTS, 3, device=dev, generator=g) * 0.1),
        "env_preds": folded(3 * ENV_CHUNK), "env_gt": tiled(gt3, ENV_CHUNK),
        "probe_preds": folded(3 * PROBES), "probe_gt": tiled(gt3, PROBES),
        "obs_preds": folded(3), "obs_gt": tiled(gt3),
    }


def time_nn(x: torch.Tensor, y: torch.Tensor, plain_reps: int) -> dict:
    """K1's times at one shape beside its two bounds."""
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    # 3 sub + 3 mul + 2 add + 1 compare per (query, ref) pair over the FP32
    # peak, which counts an FMA as two; none of the nine fuses, so at one
    # instruction a lane a clock the issue bound is twice that
    bound_ms = 9.0 * b * n * m / PEAK_FP32_OPS * 1e3
    ms, sm_mhz = time_ms_and_clock(lambda: min_dists(x, y))
    return {
        "ms": ms,
        "sm_clock_mhz": sm_mhz,
        "issue_slots_a_pair": ms * 1e-3 * sm_mhz * 1e6 * SM_LANES / (b * n * m),
        "ms_y_to_x": time_ms(lambda: min_dists(y, x), 20),
        "plain_ms": time_ms(lambda: min_dists_plain(x, y), plain_reps),
        "library_ms": None,
        "bound_ms": bound_ms,
        "bound_by": "operations",
        "issue_bound_ms": 2 * bound_ms,
    }


def phase_nn(c: dict) -> dict:
    """K1 at every shape: its numbers at the v_t_g step's at the top, each
    other shape's under its key."""
    shapes = {
        "main": ("preds", "gt", 10), "touch_shape": ("touch_preds", "touch_gt", 3),
        "autoencoder_shape": ("preds", "decoded", 5), "env_chunk_shape": ("env_preds", "env_gt", 2),
        "probe_chunk_shape": ("probe_preds", "probe_gt", 2),
        "observation_shape": ("obs_preds", "obs_gt", 5),
        "shard_x_to_y": ("shard_x", "shard_y", 3), "shard_y_to_x": ("shard_y", "shard_x", 3),
    }
    out, err = {}, 0.0
    for key, (a, b, plain_reps) in shapes.items():
        x, y = c[a], c[b]
        t = out[key] = time_nn(x, y, plain_reps)
        for p, q in ((x, y), (y, x)):  # tolerance 0: same rounding, same order, first index wins
            (d, i), (d_p, i_p) = min_dists(p, q), min_dists_plain(p, q)
            err = max(err, float((d - d_p).abs().max()))
            check(torch.equal(d, d_p) and torch.equal(i, i_p),
                  f"nn_exact disagrees with its plain version at {key} {tuple(p.shape[:2])}x{q.shape[1]}")
        target = K1_TARGET_MS.get(key)
        met = "" if target is None else (
            f"; target {target} ms {'met' if max(t['ms'], t['ms_y_to_x']) <= target else 'MISSED'}")
        print(f"  nn_exact at {key} {tuple(x.shape[:2])}x{y.shape[1]}: kernel {t['ms']:.3f} ms "
              f"(y->x {t['ms_y_to_x']:.3f} ms)  plain {t['plain_ms']:.3f} ms  bound "
              f"{t['bound_ms']:.4f} ms (operations), issue bound {t['issue_bound_ms']:.4f} ms, of which "
              f"the kernel reaches {t['issue_bound_ms'] / t['ms']:.3f}; {t['issue_slots_a_pair']:.2f} "
              f"issue slots a pair at the {t['sm_clock_mhz']} MHz read meanwhile{met}")
    one = c["preds"][:1].contiguous(), c["gt"][:1].contiguous()
    print(f"  yardstick at (1, 30000)x30000: nn_exact {time_ms(lambda: min_dists(*one)):.3f} ms, "
          f"torch.cdist(...).min(-1) {time_ms(lambda: torch.cdist(*one).min(-1)):.3f} ms")
    return {**out.pop("main"), "max_abs_err": err, **out}


def k3_plain_and_bound(xs, ys, ids) -> dict:
    """K3's plain version's time on one table and K3's bound: 3 sub + 3 mul
    + 2 add + 1 compare per (query, listed ref) pair; by bytes (queries,
    distinct refs and table read once, outputs written once) the bound is
    far lower."""
    b, n, t = xs.shape[0], xs.shape[1], ids.shape[2]
    pairs = b * n * t * CHUNK
    moved = (xs.numel() + ys.numel() + ids.numel() + 2 * b * n) * 4
    return {
        "plain_ms": time_ms(lambda: cluster.nn_cluster_plain(xs, ys, ids, CHUNK), 3),
        "library_ms": None,  # no single PyTorch call computes a table-driven pruned NN
        "bound_ms": max(9.0 * pairs / PEAK_FP32_OPS, moved / PEAK_HBM_BYTES) * 1e3,
        "bound_by": "operations" if 9.0 * pairs / PEAK_FP32_OPS > moved / PEAK_HBM_BYTES else "bytes",
    }


def time_select(xs_p, ys1_p, ys_p, tiles: int) -> dict:
    """The selection kernel's times beside its plain version's and its
    bounds, at the train step's shapes: one launch x->y (48 rows against 16
    distinct gt clouds), one y->x, and both directions through the
    dispatcher, the torch ops that make the centres, radii and centroids
    included."""
    c = ys1_p.shape[1] // CHUNK
    t_sel = min(CHUNKS_PER_TILE, c)
    k_cand = min(cluster._CAND_FACTOR * t_sel, c)
    both = lambda select: (  # noqa: E731
        select(xs_p, ys1_p, CHUNK, CHUNKS_PER_TILE), select(ys_p, xs_p, CHUNK, CHUNKS_PER_TILE))
    stats1 = tuple(t.contiguous() for t in cluster._selection_stats(xs_p, ys1_p, CHUNK))
    stats2 = tuple(t.contiguous() for t in cluster._selection_stats(ys_p, xs_p, CHUNK))
    ms, sm_mhz = time_ms_and_clock(
        lambda: cluster._select_chunks_cuda(xs_p, *stats1, t_sel), 10, inner=20)
    # per tile: 8 C anchor bounds if there is a candidate stage, 256 K voter
    # bounds and K centroid bounds, each 3 sub, 3 mul, 2 add, a square root
    # and a subtraction; the three argmin passes compare 3 x 256 x K values.
    # Over the FP32 peak (which counts an FMA as two, and none of these
    # fuses, so at one instruction a lane a clock the issue bound is twice
    # that, at the clock read meanwhile).  The rankings, the ordering keys
    # and the square root's own instructions are the kernel's choices and
    # are not counted.
    bounds = (8 * c if k_cand < c else 0) + 257 * k_cand
    ops = tiles * (10.0 * bounds + 3 * 256 * k_cand)
    moved = (xs_p.numel() + sum(t.numel() for t in stats1) + tiles * t_sel) * 4
    return {
        "ms": ms,
        "sm_clock_mhz": sm_mhz,
        "ms_y_to_x": time_ms(lambda: cluster._select_chunks_cuda(ys_p, *stats2, t_sel), 10, inner=20),
        "both_directions_ms": time_ms(lambda: both(cluster.select_chunks), 10, inner=5),
        "stats_both_directions_ms": time_ms(lambda: (
            cluster._selection_stats(xs_p, ys1_p, CHUNK),
            cluster._selection_stats(ys_p, xs_p, CHUNK)), 10, inner=5),
        "plain_ms": time_ms(
            lambda: cluster.select_chunks_plain(xs_p, ys1_p, CHUNK, CHUNKS_PER_TILE), 3),
        "plain_both_directions_ms": time_ms(lambda: both(cluster.select_chunks_plain), 3),
        "library_ms": None,  # no single PyTorch call ranks, votes and selects per tile
        "bound_ms": max(ops / PEAK_FP32_OPS, moved / PEAK_HBM_BYTES) * 1e3,
        "bound_by": "operations" if ops / PEAK_FP32_OPS > moved / PEAK_HBM_BYTES else "bytes",
        "issue_bound_ms": ops / (SM_LANES * sm_mhz * 1e6) * 1e3,
    }


def phase_cluster(c: dict, g: torch.Generator) -> tuple[dict, dict, tuple]:
    """K3 and the selection at the clustered step's shapes (48 folded
    prediction clouds against 16 distinct surface-like gt clouds) and K3 on
    a shard either way.  Returns K3's numbers, the selection's, and the
    clustered backward's stream for K2 (its ids unsorted, its values)."""
    preds, gt = c["preds"], c["surface"]

    def prep():
        """Everything of a clustered loss's forward but the two scans."""
        xs_p, ys1_p = sorted_padded(preds, 256), sorted_padded(gt, 256)
        ys_p = ys1_p.repeat(REPEAT, 1, 1)
        ids1 = cluster.select_chunks(xs_p, ys1_p, CHUNK, CHUNKS_PER_TILE)
        return xs_p, ys1_p, ys_p, ids1, cluster.select_chunks(ys_p, xs_p, CHUNK, CHUNKS_PER_TILE)

    searches = clustered_searches(c)
    (xs_p, ys1_p, ys_p), _ = searches["train step x->y"], prep()
    err, select_err, agree, found, tables = 0.0, 0.0, [], {}, {}
    for key, (xs, ys, ys_tiled) in searches.items():
        # the table and K3 against their plain versions, index for index;
        # K3's neighbours against K1's, the oracle: never nearer
        ids = tables[key] = cluster.select_chunks(xs, ys, CHUNK, CHUNKS_PER_TILE)
        plain_ids = cluster.select_chunks_plain(xs, ys, CHUNK, CHUNKS_PER_TILE)
        select_err = max(select_err, float((ids.long() - plain_ids.long()).abs().max()))
        check(ids.dtype == torch.int32 and torch.equal(ids, plain_ids)
              and int(ids.min()) >= 0 and int(ids.max()) < ys.shape[1] // CHUNK,
              f"select_chunks disagrees with its plain version at {key}")
        d, i = found[key] = cluster.nn_cluster(xs, ys, ids, CHUNK)
        d_p, i_p = cluster.nn_cluster_plain(xs, ys, ids, CHUNK)
        err = max(err, float((d - d_p).abs().max()))
        check(torch.equal(d, d_p) and torch.equal(i, i_p), f"nn_cluster disagrees with its plain version at {key}")
        d_exact = min_dists(xs, ys_tiled)[0]
        d_found = cluster._sq_dist(xs, cluster._take(ys_tiled, i.long()))
        check(bool((d_found >= d_exact).all()), f"clustered distance below the exact one at {key}")
        if key.startswith("train step"):
            agree.append(float((d_found == d_exact).float().mean()))
    check(min(agree) >= MIN_AGREEMENT, f"clustered neighbour agreement {agree} below {MIN_AGREEMENT}")
    ids1, ids2 = tables["train step x->y"], tables["train step y->x"]

    b, np_, t = xs_p.shape[0], xs_p.shape[1], ids1.shape[2]
    pairs = b * np_ * t * CHUNK
    ms, sm_mhz = time_ms_and_clock(lambda: cluster.nn_cluster(xs_p, ys1_p, ids1, CHUNK), 20, inner=10)
    timing = {
        "ms": ms,
        "sm_clock_mhz": sm_mhz,
        "issue_slots_a_pair": ms * 1e-3 * sm_mhz * 1e6 * SM_LANES / pairs,
        "ms_y_to_x": time_ms(lambda: cluster.nn_cluster(ys_p, xs_p, ids2, CHUNK), 20),
        **k3_plain_and_bound(xs_p, ys1_p, ids1),
        # nine instructions a pair, none fused, at one a lane a clock
        "issue_bound_ms": 2 * 9.0 * pairs / PEAK_FP32_OPS * 1e3,
        "agreement_with_exact": agree,
        "agreement_on_generated": None,
        "prep_ms": time_ms(prep, 10),
    }
    for key, search in (("shard_x_to_y", "shard x->y"), ("shard_y_to_x", "shard y->x")):
        (xs, ys, _), ids = searches[search], tables[search]
        timing[key] = {"ms": time_ms(lambda: cluster.nn_cluster(xs, ys, ids, CHUNK), 20),
                       **k3_plain_and_bound(xs, ys, ids), "table": [ids.shape[2], ys.shape[1] // CHUNK]}
        s = timing[key]
        print(f"  nn_cluster at the {key} shape {tuple(xs.shape[:2])}, T {s['table'][0]} of "
              f"{s['table'][1]} chunks: {s['ms']:.3f} ms  plain {s['plain_ms']:.3f} ms  bound "
              f"{s['bound_ms']:.4f} ms ({s['bound_by']})")
    timing["max_abs_err"] = err
    select = {**time_select(xs_p, ys1_p, ys_p, b * np_ // 256), "max_abs_err": select_err}
    sort_ms = time_ms(lambda: (cluster._sort_by_morton(preds), cluster._sort_by_morton(gt)), 10)
    print(f"  nn_cluster at {tuple(xs_p.shape[:2])}, T={t}, S={CHUNK}: kernel x->y {timing['ms']:.3f} ms, "
          f"y->x {timing['ms_y_to_x']:.3f} ms, plain {timing['plain_ms']:.3f} ms, "
          f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}), "
          f"issue bound {timing['issue_bound_ms']:.4f} ms, of which the kernel reaches "
          f"{timing['issue_bound_ms'] / timing['ms']:.3f}; {timing['issue_slots_a_pair']:.2f} issue "
          f"slots a pair at the {sm_mhz} MHz read meanwhile; target {K3_TARGET_MS} ms "
          f"{'met' if max(timing['ms'], timing['ms_y_to_x']) <= K3_TARGET_MS else 'MISSED'}; "
          f"neighbour agreement with nn_exact {agree}")
    print(f"  select_chunks at {tuple(xs_p.shape[:2])} x C={ys1_p.shape[1] // CHUNK}, T={t}: kernel "
          f"x->y {select['ms']:.4f} ms, y->x {select['ms_y_to_x']:.4f} ms, plain x->y "
          f"{select['plain_ms']:.3f} ms; bound {select['bound_ms']:.4f} ms ({select['bound_by']}), "
          f"issue bound {select['issue_bound_ms']:.4f} ms at the {select['sm_clock_mhz']} MHz read "
          f"meanwhile, of which the kernel reaches {select['issue_bound_ms'] / select['ms']:.3f}")
    print(f"  chunk selection of one loss (both directions): {select['both_directions_ms']:.3f} ms "
          f"through the kernel, of which the torch ops for centres, radii and centroids "
          f"{select['stats_both_directions_ms']:.3f} ms; {select['plain_both_directions_ms']:.3f} ms "
          f"as torch ops (select_chunks_plain); target {SELECT_TARGET_MS} ms "
          f"{'met' if select['both_directions_ms'] <= SELECT_TARGET_MS else 'MISSED'}")
    check(select["both_directions_ms"] <= select["plain_both_directions_ms"],
          "the selection kernel is slower than select_chunks_plain")
    print(f"  prep of one clustered loss (both directions): {timing['prep_ms']:.3f} ms, of which "
          f"Morton sorts of 48 + 16 clouds {sort_ms:.3f} ms, chunk selection "
          f"{select['both_directions_ms']:.3f} ms; the two scans take "
          f"{timing['ms'] + timing['ms_y_to_x']:.3f} ms")

    # the clustered backward's stream: per cloud the n own entries and the
    # m cross entries, original-frame ids, one 60k-entry stable sort
    xperm = cluster._sort_by_morton(preds)[1]
    iy = found["train step y->x"][1][:, :N].long().clamp(0, N - 1)
    idx = torch.cat([xperm, cluster._take(xperm, iy)], dim=1)  # (48, 60000)
    return timing, select, (idx, torch.randn(b, 2 * N, 3, device=g.device, generator=g) * 1e-4)


def time_segsum(idx_s: torch.Tensor, vals_s: torch.Tensor, s: int) -> dict:
    """K2's times on one sorted stream beside ``scatter_add_``'s, each as
    the median of single calls, as 20 calls between one pair of events, and
    as 20 calls replayed from a CUDA graph (the device's time alone)."""
    b, m = idx_s.shape
    expand = idx_s.long()[..., None].expand(-1, -1, 3)
    kernel = lambda: segment_accumulate_sorted(idx_s, vals_s, s)  # noqa: E731
    library = lambda: torch.zeros(  # noqa: E731
        b, s, 3, device=idx_s.device).scatter_add_(1, expand, vals_s)
    return {
        "ms": time_ms(kernel, 50),
        "ms_batched": time_ms(kernel, 10, inner=20),
        "ms_graphed": graph_ms(kernel),
        "plain_ms": time_ms(lambda: segment_sum_plain(idx_s, vals_s, s), 20),
        "library_ms": time_ms(library, 50),
        "library_ms_batched": time_ms(library, 10, inner=20),
        "library_ms_graphed": graph_ms(library),
        # ids (4 B) and values (12 B) read once, 12 B written per segment;
        # the kernel's zero-fill of empty segments is not in the bound
        "bound_ms": (b * m * 16 + b * s * 12) / PEAK_HBM_BYTES * 1e3,
        "bound_by": "bytes",
    }


def sorted_stream(ids: torch.Tensor, vals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A backward's K2 stream: ``ids`` sorted along each row, stably, and
    ``vals`` (b, m, 3) in their order."""
    idx_s, perm = torch.sort(ids, dim=1, stable=True)
    return (idx_s.to(torch.int32).contiguous(),
            torch.gather(vals, 1, perm[..., None].long().expand(-1, -1, 3)).contiguous())


def phase_segsum(c: dict, clustered: tuple, g: torch.Generator) -> dict:
    """K2 on each backward's stream: its numbers on the v_t_g step's at
    the top, each other stream's under its key (a ``_stream`` with its own
    ``max_abs_err``)."""
    vals = lambda *shape: torch.randn(*shape, 3, device=g.device, generator=g) * 1e-4  # noqa: E731
    argmins = lambda x, y: min_dists(x, y)[1]  # noqa: E731
    streams = {
        # the gt->prediction argmins, which send many gt points to one
        # sample (the duplicate-heavy direction)
        "main": (*sorted_stream(argmins(c["gt"], c["preds"]), vals(48, N)), N),
        "touch_shape": (*sorted_stream(argmins(c["touch_gt"], c["touch_preds"]), vals(192, 4000)), 4000),
        "clustered_stream": (*sorted_stream(*clustered), N),
        # the samples' argmins into the decoded points
        "autoencoder_stream": (*sorted_stream(argmins(c["preds"], c["decoded"]), vals(48, N)),
                               AE_POINTS),
    }
    # the sampler's backward: 3 corners x 16 meshes of 3 x 30k sorted face
    # ids of the vision atlas, 3 corners x 64 touch charts of 3 x 4000; and
    # the vision shape with one face taking every sample, one warp a row
    (verts, faces), chart = vtg_mesh(g.device), touch_chart()
    for key, verts, faces, num in (
        ("sampler_stream", verts.expand(16, -1, -1), faces, REPEAT * N),
        ("touch_sampler_stream", torch.as_tensor(chart.verts, device=g.device)[None].expand(64, -1, -1),
         torch.as_tensor(chart.faces, device=g.device).long(), REPEAT * 4000),
    ):
        e, _, _ = draw_sample_noise(verts.shape[0], num, g, g.device)
        ids = sample_faces(verts, faces, e).to(torch.int32).repeat(3, 1).contiguous()
        streams[key] = (ids, vals(*ids.shape), faces.shape[0])
    ids, v, f = streams["sampler_stream"]
    streams["one_face_stream"] = (torch.full_like(ids, 17), v, f)

    out, err = {}, 0.0
    for key, (idx_s, vals_s, s) in streams.items():
        t = out[key] = time_segsum(idx_s, vals_s, s)
        # the plain version adds with atomics: |err| <= 1e-5 x (1 + Σ|v| of the segment)
        got = segment_accumulate_sorted(idx_s, vals_s, s)
        diff = (got - segment_sum_plain(idx_s, vals_s, s)).abs()
        e = float(diff.max())
        err = max(err, e)
        check(bool((diff <= 1e-5 * (1 + segment_sum_plain(idx_s, vals_s.abs(), s))).all())
              and torch.equal(got, segment_accumulate_sorted(idx_s, vals_s, s)),
              f"segsum_sorted disagrees with its plain version, or with itself, at {key}")
        if key.endswith("_stream"):
            t["max_abs_err"] = e
        if key == "clustered_stream":
            t["with_sort_ms"] = time_ms(lambda: scatter_add_3(*clustered, N), 20)
        print(f"  segsum_sorted at {key} {tuple(idx_s.shape)}->S={s}: kernel {t['ms']:.4f} ms single, "
              f"{t['ms_batched']:.4f} ms batched, {t['ms_graphed']:.4f} ms graphed  plain "
              f"{t['plain_ms']:.3f} ms  library (scatter_add_) {t['library_ms']:.4f} ms single, "
              f"{t['library_ms_batched']:.4f} ms batched, {t['library_ms_graphed']:.4f} ms graphed  "
              f"bound {t['bound_ms']:.4f} ms (bytes)"
              + (f"; with its stable sort {t['with_sort_ms']:.3f} ms" if "with_sort_ms" in t else ""))
        # one face a row is one address for the library's atomics and one
        # warp for the kernel: printed, and held to no time
        check(key == "one_face_stream" or t["ms_graphed"] <= t["library_ms_graphed"],
              f"segsum_sorted is slower than scatter_add_ at {key}")
    return {**out.pop("main"), "max_abs_err": err, **out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    print("== 1 environment")
    card = phase_environment()
    print("== 2 build")
    phase_build()
    print("== 3 timings at the paths' shapes")
    g = torch.Generator(device="cuda").manual_seed(0)
    clouds = make_clouds(g)
    timing = {NN_EXACT.name: phase_nn(clouds)}
    timing[NN_CLUSTER.name], timing[SELECT_CHUNKS.name], clustered = phase_cluster(clouds, g)
    timing[SEGSUM.name] = phase_segsum(clouds, clustered, g)
    print(f"== 4 the cuda tests, at {time.perf_counter() - t_start:.1f} s", flush=True)
    tests = subprocess.run([sys.executable, "-m", "pytest", *CUDA_TESTS, "-q", "-m", "cuda", "--noconftest"],
                           cwd=ROOT)
    check(tests.returncode == 0, f"the cuda tests failed (exit code {tests.returncode})")
    print(f"== done in {time.perf_counter() - t_start:.1f} s")

    sources = {
        NN_EXACT.name: "active_3d_vision_and_touch_tpu/ops/chamfer.py:32",
        SEGSUM.name: "active_3d_vision_and_touch_tpu/ops/segsum.py:43",
        NN_CLUSTER.name: "active_3d_vision_and_touch_tpu/ops/chamfer_cluster.py:119",
        # no TPU kernel: the XLA ops of tile_select under lax.map
        SELECT_CHUNKS.name: "active_3d_vision_and_touch_tpu/ops/chamfer_cluster.py:247",
    }
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {
            "name": k.name,
            "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": sources[k.name],
            "launches": None,  # counted by the cuda tests, path by path
            "launches_by_path": None,
            **{key: timing[k.name][key] for key in fields},
            **{key: value for key, value in timing[k.name].items() if key not in fields},
        }
        for k in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": not FAILED, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
