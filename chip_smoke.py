#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

from the root of a checkout.  It imports nothing of JAX or of the JAX
package, and runs these phases in order; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit, and
   the TF32 settings, set explicitly;
2. build: every hand-written kernel from ``csrc/``, one ``nvcc`` each, all
   started together; no register spills; the instruction mix of the exact
   nearest-neighbour kernel's scan loop as built (``cuobjdump -sass``);
3. kernels against their plain PyTorch versions on the card, at test shapes
   (the seeded cases of the package's ``testing`` module: tile edges, placed
   ties, run shapes) and at the shapes the train step gives them, each with
   its stated tolerance; the segment sum twice on one input, bit-equal; the
   clustered search against the exact one, its oracle; then CUDA-event
   timings (median of repeated launches) of each kernel, its plain version
   and, where one exists, a single PyTorch call computing the same
   function, and of the clustered search's torch-op prep; the segment sum
   must be no slower than ``scatter_add_`` by the device's time (replays of
   a CUDA graph of 20 launches);
4. the main paths at full width, each taking 1 warm-up and 3 train steps
   and 1 eval step from random weights made from the seed, with every
   launch counter set to 0 just before and read just after, and each kernel
   required to have run exactly as often as the path needs:
   ``VisionEngine`` on the v_t_g configuration (batch 16, 30k points,
   3-repeat Chamfer) with ``loss_nn="exact"``, the same with ``loss_nn``
   left at its default ``"clustered"``, and ``TouchEngine`` on its default
   configuration (batch 64, 121x121 images, 4000 samples);
5. the outputs: the full-width losses with the kernels against the same
   step on the plain versions, the clustered Chamfer on the kernels against
   the same on the plain versions and against the exact loss, and small
   configurations on the card against the same ones on the CPU;
6. a profile of one train step of each path: device time by kernel;
7. a ``kernels`` JSON line, the card's ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.
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

from active_3d_vision_and_touch_tpu_torch.core import build_adj_info, touch_chart, vision_charts
from active_3d_vision_and_touch_tpu_torch.core.config import TouchConfig, VisionConfig
from active_3d_vision_and_touch_tpu_torch.models import prepare_charts
from active_3d_vision_and_touch_tpu_torch.ops import KERNELS, NN_CLUSTER, NN_EXACT, SEGSUM
from active_3d_vision_and_touch_tpu_torch.ops import chamfer_cluster as cluster
from active_3d_vision_and_touch_tpu_torch.ops._cuda import build_all, nvcc_path
from active_3d_vision_and_touch_tpu_torch.ops.chamfer import min_dists, min_dists_plain
from active_3d_vision_and_touch_tpu_torch.ops.sample import batch_sample, draw_sample_noise
from active_3d_vision_and_touch_tpu_torch.ops.segsum import (
    scatter_add_3,
    segment_accumulate_sorted,
    segment_sum_plain,
)
from active_3d_vision_and_touch_tpu_torch.testing import (
    NN_SHAPES,
    NN_TIE_CASES,
    SEGSUM_CASES,
    nn_shape_case,
    nn_tie_case,
    segsum_case,
)
from active_3d_vision_and_touch_tpu_torch.train.touch import TouchEngine
from active_3d_vision_and_touch_tpu_torch.train.vision import VisionEngine

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# the v_t_g train step of bench.py, on the port
MAIN = dict(
    use_img=True, use_touch=True, finger=False, batch_size=16,
    number_points=30000, loss_nn="exact", eval=True,
)
REPEAT = 3  # Chamfer repeats folded onto the batch: 48 clouds per launch
CHUNK, CHUNKS_PER_TILE = 128, 24  # the clustered search's defaults
# Least share of queries whose clustered neighbour is the exact one, on the
# surface clouds of this script at 30k points, in either direction.  An
# H100 showed 0.9765 (predictions -> gt) and 0.9273 (gt -> predictions); the
# clouds are made from a seed, so a fall below 0.90 is a change in the code
MIN_AGREEMENT = 0.90
# K1's time targets at the two main-path shapes, on a card at its 700 W limit.
# They are printed as met or missed and fail nothing: a card set to a lower
# limit runs slower.  What is checked is relative, within one run
K1_TARGET_MS = {"(48, 30000)x30000": 16.0, "the touch shape (192, 4000)x4000": 1.25}
SM_LANES = 132 * 128  # an H100 SXM: 132 SMs, each issuing for 4 x 32 lanes a clock
EXPERIMENTS = str(ROOT / "build" / "chip_smoke")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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


def main_batch(cfg: VisionConfig, seed: int = 0) -> dict:
    """A seeded random batch shaped as bench.py's."""
    rng = np.random.default_rng(seed)
    b = cfg.batch_size
    return {
        "img": rng.uniform(size=(b, 256, 256, 3)).astype(np.float32),
        "gt_points": rng.normal(size=(b, cfg.number_points, 3)).astype(np.float32) * 0.1,
        "touch_charts": rng.normal(size=(b, cfg.num_grasps, 4, 25, 4)).astype(np.float32) * 0.1,
    }


def surface_clouds(b: int, n: int, g: torch.Generator, dev: torch.device) -> torch.Tensor:
    """(b, n, 3) surface-like clouds made on the card from the generator:
    area-weighted samples of the vision atlas (a sphere of radius 0.25),
    scaled per axis by 0.6-1.4 and bent by a low-frequency displacement.
    The pruned search is built for surfaces; a Gaussian volume is none."""
    atlas = vision_charts()
    verts = torch.as_tensor(atlas.verts, device=dev)[None].expand(b, -1, -1)
    verts = verts * (0.6 + 0.8 * torch.rand(b, 1, 3, device=dev, generator=g))
    phase = 6.28 * torch.rand(b, 1, 3, device=dev, generator=g)
    verts = verts + 0.03 * torch.sin(9.0 * verts.roll(1, dims=-1) + phase)
    faces = torch.as_tensor(atlas.faces, device=dev).long()
    return batch_sample(verts, faces, n, generator=g)


def surface_batch(cfg: VisionConfig, dev: torch.device, seed: int = 0) -> dict:
    """main_batch with a surface-like gt cloud, for the clustered loss."""
    batch = main_batch(cfg, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    batch["gt_points"] = surface_clouds(cfg.batch_size, cfg.number_points, g, dev)
    return batch


def touch_batch(cfg: TouchConfig, seed: int = 0) -> dict:
    """A seeded random batch shaped as the touch trainer's: gel images,
    fingertip poses and local touch point clouds of a few millimetres."""
    rng = np.random.default_rng(seed)
    b = cfg.batch_size
    return {
        "sim_touch": rng.uniform(size=(b, 121, 121, 3)).astype(np.float32),
        "ref_pos": (rng.normal(size=(b, 3)) * 0.1).astype(np.float32),
        "ref_rot": np.linalg.qr(rng.normal(size=(b, 3, 3)))[0].astype(np.float32),
        "samples": (rng.normal(size=(b, cfg.num_samples, 3)) * 0.005).astype(np.float32),
    }


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
    seconds = build_all(list(KERNELS))
    print(f"build: {len(KERNELS)} kernels in {seconds:.2f} s")
    for k in KERNELS:
        used = [ln.strip() for ln in k.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {k.name}: {'; '.join(used) or 'library already built'}")
        spills = [ln for ln in used if "spill" in ln]
        check(all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in spills),
              f"{k.name}: ptxas reports register spills")
    print(f"  {NN_EXACT.name} scan loop as built: {sass_inner_loop(NN_EXACT)}")


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


def check_nn(x: torch.Tensor, y: torch.Tensor, label: str) -> float:
    """K1 against its plain version: tolerance 0 (same rounding, same
    order, first index wins); returns the max abs distance error."""
    d, i = min_dists(x, y)
    d_p, i_p = min_dists_plain(x, y)
    err = float((d - d_p).abs().max())
    mismatch = int((i != i_p).sum())
    print(f"  nn_exact {label} {tuple(x.shape[:2])}x{y.shape[1]}: "
          f"max_abs_err {err} index mismatches {mismatch}")
    check(err == 0.0 and mismatch == 0, f"nn_exact disagrees with its plain version at {label}")
    return err


def check_segsum(idx_s: torch.Tensor, vals_s: torch.Tensor, s: int, label: str,
                 twice: bool = False) -> float:
    """K2 against its plain version (index_add_, which adds with atomics on
    the card): |err| <= 1e-5 * (1 + Σ|v| of the segment).  ``twice`` runs
    the kernel a second time on the same input and requires equal bits."""
    out = segment_accumulate_sorted(idx_s, vals_s, s)
    if twice:
        check(torch.equal(out, segment_accumulate_sorted(idx_s, vals_s, s)),
              f"segsum_sorted gave two different results on one input at {label}")
    ref = segment_sum_plain(idx_s, vals_s, s)
    scale = segment_sum_plain(idx_s, vals_s.abs(), s)
    err = float((out - ref).abs().max())
    ok = bool(((out - ref).abs() <= 1e-5 * (1 + scale)).all())
    rows = torch.arange(idx_s.shape[0], device=idx_s.device)[:, None] * (s + 1)
    largest = int(torch.bincount((idx_s.clamp(0, s).long() + rows).flatten()).max())
    print(f"  segsum_sorted {label} {tuple(idx_s.shape)}->S={s}: max_abs_err {err} "
          f"largest run in a row {largest}{'  bit-equal twice' if twice else ''}")
    check(ok, f"segsum_sorted disagrees with its plain version at {label}")
    return err


def time_nn(x: torch.Tensor, y: torch.Tensor, plain_reps: int) -> dict:
    """K1's times at one shape beside its two bounds."""
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    # 3 sub + 3 mul + 2 add + 1 compare per (query, ref) pair over the FP32
    # peak, which counts an FMA as two; none of the nine fuses, so at one
    # instruction a lane a clock the issue bound is twice that
    bound_ms = 9.0 * b * n * m / PEAK_FP32_OPS * 1e3
    smi = subprocess.Popen(  # reads the SM clock while the launches run
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    ms = time_ms(lambda: min_dists(x, y), 20)
    sm_mhz = int(smi.communicate(timeout=60)[0].split()[0])
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


def print_nn(label: str, t: dict) -> None:
    print(f"  nn_exact at {label}: kernel {t['ms']:.3f} ms (y->x {t['ms_y_to_x']:.3f} ms)  "
          f"plain {t['plain_ms']:.3f} ms  bound {t['bound_ms']:.4f} ms (operations), "
          f"issue bound {t['issue_bound_ms']:.4f} ms, of which the kernel reaches "
          f"{t['issue_bound_ms'] / t['ms']:.3f}; {t['issue_slots_a_pair']:.2f} issue slots a pair "
          f"at the {t['sm_clock_mhz']} MHz read meanwhile; target {K1_TARGET_MS[label]} ms "
          f"{'met' if max(t['ms'], t['ms_y_to_x']) <= K1_TARGET_MS[label] else 'MISSED'}")


def print_segsum(label: str, t: dict) -> None:
    """Prints K2's times and requires the kernel to be no slower than
    ``scatter_add_`` by the device's time (graph replays): the single and
    batched readings hold the host's enqueue time and are only printed."""
    print(f"  segsum_sorted at {label}: kernel {t['ms']:.4f} ms single, {t['ms_batched']:.4f} ms "
          f"batched, {t['ms_graphed']:.4f} ms graphed  plain {t['plain_ms']:.3f} ms  "
          f"library (scatter_add_) {t['library_ms']:.4f} ms single, "
          f"{t['library_ms_batched']:.4f} ms batched, {t['library_ms_graphed']:.4f} ms graphed  "
          f"bound {t['bound_ms']:.4f} ms (bytes); kernel no slower than the library: "
          f"single {t['ms'] <= t['library_ms']}, batched {t['ms_batched'] <= t['library_ms_batched']}")
    check(t["ms_graphed"] <= t["library_ms_graphed"],
          f"segsum_sorted is slower than scatter_add_ at {label}")


def phase_kernels(dev: torch.device) -> dict:
    """Kernels against their plain versions, then timings at main-path shapes."""
    g = torch.Generator(device=dev).manual_seed(0)
    nn_err = 0.0
    for b, n, m in ((2, 4096, 4096), (1, 30000, 30000)):
        x = torch.randn(b, n, 3, device=dev, generator=g)
        y = torch.randn(b, m, 3, device=dev, generator=g)
        nn_err = max(nn_err, check_nn(x, y, "random"))
    # ties: every ref repeated, queries sitting on refs
    base = torch.randint(-3, 4, (2, 500, 3), device=dev, generator=g).float()
    nn_err = max(nn_err, check_nn(base[:, :300].contiguous(), torch.cat([base, base], 1), "ties"))
    # sizes on and beside the tiles, and equal minima placed in one load of
    # four refs, in the next load, in the next group of eight and in
    # neighbouring tiles
    for n, m in NN_SHAPES:
        x, y = (torch.from_numpy(a).to(dev) for a in nn_shape_case(n, m))
        nn_err = max(nn_err, check_nn(x, y, "tile edge"))
    for name in NN_TIE_CASES:
        x, y = (torch.from_numpy(a).to(dev) for a in nn_tie_case(name))
        nn_err = max(nn_err, check_nn(x, y, f"ties {name}"))

    # main-path inputs: 3 x 30k area-weighted samples of the initial atlas
    # per cloud, folded onto the batch, against the tiled gt cloud
    atlas = vision_charts()
    faces = torch.as_tensor(build_adj_info(atlas).faces, device=dev).long()
    verts = torch.as_tensor(atlas.verts, device=dev)[None].expand(16, -1, -1)
    fused = torch.cat([verts, torch.zeros(16, 500, 3, device=dev)], 1)  # touch slots
    n = MAIN["number_points"]
    pts = batch_sample(fused, faces, REPEAT * n, generator=g)
    preds = torch.cat(torch.split(pts, n, dim=1), 0).contiguous()  # (48, 30k, 3)
    gt = (torch.randn(16, n, 3, device=dev, generator=g) * 0.1).repeat(REPEAT, 1, 1)
    nn_err = max(nn_err, check_nn(preds, gt, "train-step x->y"))
    nn_err = max(nn_err, check_nn(gt, preds, "train-step y->x"))

    # K2 on the backward's sorted stream: the gt->prediction argmins, which
    # send many gt points to one sample (the duplicate-heavy direction)
    _, iy = min_dists(gt, preds)
    idx_s, perm = torch.sort(iy, dim=1, stable=True)
    vals = torch.randn(gt.shape, device=dev, generator=g) * 1e-4
    vals_s = torch.gather(vals, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    seg_err = check_segsum(idx_s, vals_s, n, "train-step", twice=True)
    # synthetic: a duplicate-heavy id, empty segments, out-of-range ids
    ids = torch.randint(0, n + 2000, (48, n), device=dev, generator=g)
    ids[:, :5000] = 17
    ids[ids % 7 == 3] = 12
    syn_s, _ = torch.sort(ids.int(), dim=1)
    syn_v = torch.randn(48, n, 3, device=dev, generator=g)
    seg_err = max(seg_err, check_segsum(syn_s.contiguous(), syn_v, n, "synthetic", twice=True))
    # run lengths around the one-thread / one-warp threshold and the slab
    # size, short runs across a slab's end, a slab packed with 9-entry runs,
    # rows with nothing to sum, stream lengths that are no multiple of four
    for name in SEGSUM_CASES:
        case_idx, case_vals, case_s = segsum_case(name)
        seg_err = max(seg_err, check_segsum(
            torch.from_numpy(case_idx).to(dev), torch.from_numpy(case_vals).to(dev), case_s,
            name, twice=True))

    # the touch trainer's shapes: 64 charts x 3 repeats of 4000 samples of
    # the chart sheet against clouds of a few millimetres
    chart = touch_chart()
    cverts = torch.as_tensor(chart.verts, device=dev)[None].expand(64, -1, -1)
    cfaces = torch.as_tensor(chart.faces, device=dev).long()
    tpts = batch_sample(cverts, cfaces, REPEAT * 4000, generator=g)
    tpreds = torch.cat(torch.split(tpts, 4000, dim=1), 0).contiguous()  # (192, 4000, 3)
    tgt = (torch.randn(64, 4000, 3, device=dev, generator=g) * 0.005).repeat(REPEAT, 1, 1)
    nn_err = max(nn_err, check_nn(tpreds, tgt, "touch x->y"))
    nn_err = max(nn_err, check_nn(tgt, tpreds, "touch y->x"))
    _, tiy = min_dists(tgt, tpreds)
    tidx_s, tperm = torch.sort(tiy, dim=1, stable=True)
    tvals_s = torch.gather(
        torch.randn(192, 4000, 3, device=dev, generator=g) * 1e-4, 1,
        tperm[..., None].expand(-1, -1, 3)).contiguous()
    seg_err = max(seg_err, check_segsum(tidx_s, tvals_s, 4000, "touch"))
    timing = {
        "nn_exact": {**time_nn(preds, gt, 10), "max_abs_err": nn_err,
                     "touch_shape": time_nn(tpreds, tgt, 3)},
        "segsum_sorted": {**time_segsum(idx_s, vals_s, n), "max_abs_err": seg_err,
                          "touch_shape": time_segsum(tidx_s, tvals_s, 4000)},
    }
    print_nn("(48, 30000)x30000", timing["nn_exact"])
    print_nn("the touch shape (192, 4000)x4000", timing["nn_exact"]["touch_shape"])
    print_segsum("(48, 30000)->S=30000", timing["segsum_sorted"])
    print_segsum("the touch shape (192, 4000)->S=4000", timing["segsum_sorted"]["touch_shape"])
    one = preds[:1].contiguous(), gt[:1].contiguous()
    print(f"  yardstick at (1, 30000)x30000: nn_exact {time_ms(lambda: min_dists(*one)):.3f} ms, "
          f"torch.cdist(...).min(-1) {time_ms(lambda: torch.cdist(*one).min(-1)):.3f} ms")
    return timing


def check_cluster(xs, ys, ids, chunk: int, label: str) -> float:
    """K3 against its plain version: tolerance 0 on distance and index
    (same rounding, same scan order, same tie rule)."""
    d, i = cluster.nn_cluster(xs, ys, ids, chunk)
    d_p, i_p = cluster.nn_cluster_plain(xs, ys, ids, chunk)
    err = float((d - d_p).abs().max())
    mismatch = int((i != i_p).sum())
    print(f"  nn_cluster {label} xs {tuple(xs.shape[:2])} refs {tuple(ys.shape[:2])} "
          f"table {tuple(ids.shape)} S={chunk}: max_abs_err {err} index mismatches {mismatch}")
    check(err == 0.0 and mismatch == 0, f"nn_cluster disagrees with its plain version at {label}")
    return err


def check_against_exact(xs, ys_tiled, i_sorted, label: str) -> float:
    """The clustered neighbour against K1, the oracle: the re-derived
    distance is never below the exact one (a hard check); returns the
    share of queries whose distance equals the exact one."""
    d_exact, _ = min_dists(xs, ys_tiled)
    d_found = cluster._sq_dist(xs, cluster._take(ys_tiled, i_sorted.long()))
    agree = float((d_found == d_exact).float().mean())
    excess = float(d_found.mean() / d_exact.mean() - 1.0)
    print(f"  nn_cluster vs nn_exact {label}: neighbour agreement {agree:.6f}, "
          f"mean distance {excess:.3e} above the exact one")
    check(bool((d_found >= d_exact).all()), f"clustered distance below the exact one at {label}")
    return agree


def phase_cluster(dev: torch.device) -> tuple[dict, dict]:
    """K3 against its plain version and against K1, then its timings and
    the prep's at the clustered train step's shapes.  Returns K3's numbers
    and K2's on the clustered backward's stream."""
    g = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    # small surface case: S 64, T 16 of 18 chunks
    pts = surface_clouds(2, 1024 + 1100, g, dev)  # in face order: shuffle, then split
    pts = pts[:, torch.randperm(pts.shape[1], device=dev, generator=g)]
    x, y = pts[:, :1024], pts[:, 1024:] * 1.01
    xs = cluster._edge_pad_points(cluster._sort_by_morton(x)[0], 256).contiguous()
    ys = cluster._edge_pad_points(cluster._sort_by_morton(y)[0], 64).contiguous()
    err = max(err, check_cluster(xs, ys, cluster.select_chunks(xs, ys, 64, 16), 64, "surface"))
    # ties: 5 distinct chunks of lattice points, each 4 times, listed in an
    # order that is not the index order; queries sit on lattice points, so
    # equal distances occur inside a chunk and across chunks
    base = torch.randint(-3, 4, (1, 5, 32, 3), device=dev, generator=g).float()
    refs = base.repeat(1, 4, 1, 1).reshape(1, 20 * 32, 3).contiguous()
    queries = torch.randint(-3, 4, (2, 512, 3), device=dev, generator=g).float()
    table = torch.tensor([17, 2, 12, 7, 9, 4, 0], dtype=torch.int32, device=dev)
    err = max(err, check_cluster(queries, refs, table.expand(2, 2, -1).contiguous(), 32, "ties"))

    # the clustered train step's inputs: 48 folded prediction clouds sampled
    # from the initial atlas against 16 distinct surface-like gt clouds
    n = MAIN["number_points"]
    atlas = vision_charts()
    faces = torch.as_tensor(atlas.faces, device=dev).long()
    verts = torch.as_tensor(atlas.verts, device=dev)[None].expand(16, -1, -1)
    pts = batch_sample(verts, faces, REPEAT * n, generator=g)
    preds = torch.cat(torch.split(pts, n, dim=1), 0).contiguous()  # (48, 30k, 3)
    gt = surface_clouds(16, n, g, dev)

    def prep():
        """Everything of a clustered loss's forward but the two scans."""
        xs, _ = cluster._sort_by_morton(preds)
        ys1, _ = cluster._sort_by_morton(gt)
        xs_p = cluster._edge_pad_points(xs, 256).contiguous()
        ys1_p = cluster._edge_pad_points(ys1, 256).contiguous()
        ys_p = ys1_p.repeat(REPEAT, 1, 1)
        ids1 = cluster.select_chunks(xs_p, ys1_p, CHUNK, CHUNKS_PER_TILE)
        ids2 = cluster.select_chunks(ys_p, xs_p, CHUNK, CHUNKS_PER_TILE)
        return xs_p, ys1_p, ys_p, ids1, ids2

    xs_p, ys1_p, ys_p, ids1, ids2 = prep()
    err = max(err, check_cluster(xs_p, ys1_p, ids1, CHUNK, "train-step x->y (y_distinct 16)"))
    err = max(err, check_cluster(ys_p, xs_p, ids2, CHUNK, "train-step y->x"))
    _, i1 = cluster.nn_cluster(xs_p, ys1_p, ids1, CHUNK)
    _, i2 = cluster.nn_cluster(ys_p, xs_p, ids2, CHUNK)
    agree = [check_against_exact(xs_p, ys_p, i1, "x->y"), check_against_exact(ys_p, xs_p, i2, "y->x")]
    check(min(agree) >= MIN_AGREEMENT,
          f"clustered neighbour agreement {agree} below {MIN_AGREEMENT}")

    b, np_, t = xs_p.shape[0], xs_p.shape[1], ids1.shape[2]
    pairs = b * np_ * t * CHUNK
    moved = (xs_p.numel() + ys1_p.numel() + ids1.numel() + 2 * b * np_) * 4
    timing = {
        "ms": time_ms(lambda: cluster.nn_cluster(xs_p, ys1_p, ids1, CHUNK), 20),
        "ms_y_to_x": time_ms(lambda: cluster.nn_cluster(ys_p, xs_p, ids2, CHUNK), 20),
        "plain_ms": time_ms(lambda: cluster.nn_cluster_plain(xs_p, ys1_p, ids1, CHUNK), 3),
        "library_ms": None,  # no single PyTorch call computes a table-driven pruned NN
        # 3 sub + 3 mul + 2 add + 1 compare per (query, listed ref) pair; by
        # bytes (queries, distinct refs and table read once, outputs written
        # once) the bound is far lower
        "bound_ms": max(9.0 * pairs / PEAK_FP32_OPS, moved / PEAK_HBM_BYTES) * 1e3,
        "bound_by": "operations" if 9.0 * pairs / PEAK_FP32_OPS > moved / PEAK_HBM_BYTES else "bytes",
        # nine instructions a pair, none fused, at one a lane a clock
        "issue_bound_ms": 2 * 9.0 * pairs / PEAK_FP32_OPS * 1e3,
        "max_abs_err": err,
        "agreement_with_exact": agree,
    }
    sort_ms = time_ms(lambda: (cluster._sort_by_morton(preds), cluster._sort_by_morton(gt)), 10)
    select_ms = time_ms(lambda: (cluster.select_chunks(xs_p, ys1_p, CHUNK, CHUNKS_PER_TILE),
                                 cluster.select_chunks(ys_p, xs_p, CHUNK, CHUNKS_PER_TILE)), 10)
    timing["prep_ms"] = time_ms(prep, 10)
    print(f"  nn_cluster at {tuple(xs_p.shape[:2])}, T={t}, S={CHUNK}: kernel x->y {timing['ms']:.3f} ms, "
          f"y->x {timing['ms_y_to_x']:.3f} ms, plain {timing['plain_ms']:.3f} ms, "
          f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}), "
          f"issue bound {timing['issue_bound_ms']:.4f} ms, of which the kernel reaches "
          f"{timing['issue_bound_ms'] / timing['ms']:.3f}")
    print(f"  prep of one clustered loss (both directions): {timing['prep_ms']:.3f} ms, of which "
          f"Morton sorts of 48 + 16 clouds {sort_ms:.3f} ms, chunk selection {select_ms:.3f} ms; "
          f"the two scans take {timing['ms'] + timing['ms_y_to_x']:.3f} ms")

    # K2 on the clustered backward's stream: per cloud the n own entries and
    # the m cross entries, original-frame ids, one 60k-entry stable sort
    xperm = cluster._sort_by_morton(preds)[1]
    iy = i2[:, :n].long().clamp(0, n - 1)
    idx = torch.cat([xperm, cluster._take(xperm, iy)], dim=1)  # (48, 60000)
    vals = torch.randn(b, 2 * n, 3, device=dev, generator=g) * 1e-4
    idx_s, perm = torch.sort(idx, dim=1, stable=True)
    idx_s = idx_s.to(torch.int32).contiguous()
    vals_s = torch.gather(vals, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    seg_err = check_segsum(idx_s, vals_s, n, "clustered stream")
    stream = {
        **time_segsum(idx_s, vals_s, n),
        "with_sort_ms": time_ms(lambda: scatter_add_3(idx, vals, n), 20),
        "max_abs_err": seg_err,
    }
    print_segsum(f"the {tuple(idx_s.shape)} clustered stream ->S={n}", stream)
    print(f"  scatter_add_3 on that stream, with its stable sort: {stream['with_sort_ms']:.3f} ms")
    return timing, stream


def run_path(engine, batch: dict, expected: dict, label: str) -> dict:
    """1 warm-up + 3 train steps + 1 eval step with the launch counters set
    to 0 just before and read just after; returns the counts by kernel."""
    held = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    losses, step_ms = [], []
    for step in range(4):  # 1 warm-up + 3 measured
        t0 = time.perf_counter()
        losses.append(float(engine.train_step(batch, engine.step_generator(step))))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    eval_loss = float(engine.eval_step(batch, engine.step_generator(100)))
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in KERNELS}

    print(f"  [{label}] train losses {losses}  eval loss {eval_loss}")
    print(f"  [{label}] train step ms {[round(t, 3) for t in step_ms]}  median of 3 after warm-up "
          f"{float(np.median(step_ms[1:])):.3f}  eval step ms {eval_ms:.3f}")
    print(f"  [{label}] peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"({held / 2**30:.3f} GiB held before the path)  launches {launches}")
    check(all(np.isfinite(losses + [eval_loss])), f"non-finite loss on the {label} path")
    check(launches == expected, f"unexpected kernel launches on the {label} path: {launches}")
    return launches


def phase_main_paths(dev: torch.device) -> tuple[dict, dict]:
    """The three main paths, each through its engine as a user builds it.
    Returns the engines with their batches, and the launches by path."""
    paths, launches = {}, {}

    cfg = VisionConfig(**MAIN, experiments_root=EXPERIMENTS)
    engine = VisionEngine(cfg, log=False)  # the default device: the card
    batch = engine.to_device(main_batch(cfg))
    # 2 NN launches per loss (both directions), 2 segment sums per backward
    launches["exact"] = run_path(
        engine, batch, {NN_EXACT.name: 2 * 5, SEGSUM.name: 2 * 4, NN_CLUSTER.name: 0}, "exact")
    paths["exact"] = (engine, batch)

    clustered = {k: v for k, v in MAIN.items() if k != "loss_nn"}  # the default
    cfg = VisionConfig(**clustered, experiments_root=EXPERIMENTS)
    check(cfg.loss_nn == "clustered", "the default loss_nn is no longer 'clustered'")
    engine = VisionEngine(cfg, log=False)
    batch = engine.to_device(surface_batch(cfg, dev))
    # 2 pruned scans per loss; one fused segment sum per backward (only dx)
    launches["clustered"] = run_path(
        engine, batch, {NN_EXACT.name: 0, SEGSUM.name: 4, NN_CLUSTER.name: 2 * 5}, "clustered")
    paths["clustered"] = (engine, batch)

    cfg = TouchConfig(eval=True, experiments_root=EXPERIMENTS)  # batch 64, 4000 samples, exact
    engine = TouchEngine(cfg, log=False)
    batch = engine.to_device(touch_batch(cfg))
    launches["touch"] = run_path(
        engine, batch, {NN_EXACT.name: 2 * 5, SEGSUM.name: 2 * 4, NN_CLUSTER.name: 0}, "touch")
    paths["touch"] = (engine, batch)
    return paths, launches


def loss_and_grads(engine, batch: dict, seed: int):
    engine.model.eval()  # running statistics: the two passes see one model
    engine.model.zero_grad(set_to_none=True)
    loss = engine._loss(batch, engine.step_generator(seed), None)
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in engine.model.parameters()]


def phase_outputs(paths: dict) -> None:
    """Full width: kernels vs plain versions inside the whole exact step,
    the clustered Chamfer on the kernels vs the plain versions, and the
    clustered loss vs the exact one.  Small width: the card vs the CPU."""
    engine, batch = paths["exact"]
    t0 = time.perf_counter()
    loss_k, grads_k = loss_and_grads(engine, batch, 7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine.config.loss_nn = "xla"  # the plain brute force and index_add_
    loss_p, grads_p = loss_and_grads(engine, batch, 7)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    engine.config.loss_nn = "exact"
    print(f"  full width, forward + backward: {(t1 - t0) * 1e3:.3f} ms on the kernels, "
          f"{(t2 - t1) * 1e3:.3f} ms on the plain versions")
    worst = max(float((a - b).norm() / (b.norm() + 1e-30)) for a, b in zip(grads_k, grads_p))
    print(f"  full width: loss kernels {loss_k} plain {loss_p}; "
          f"worst relative grad error (norm) {worst:.3e}")
    # the forward is bit-identical; the backward differs by the order of
    # atomic adds (index_add_, grid_sample), which bf16 rounding can amplify
    check(abs(loss_k - loss_p) <= 1e-6 * abs(loss_p), "full-width loss: kernels != plain")
    check(worst <= 1e-3, "full-width gradients: kernels != plain")

    # the clustered Chamfer at the train step's shapes: 48 folded clouds
    # sampled from the deformed mesh against the 16 gt clouds
    engine, batch = paths["clustered"]
    n = engine.config.number_points
    engine.model.eval()
    with torch.no_grad():
        charts = prepare_charts(batch["touch_charts"], engine.initial_mesh, 16)
        verts, _ = engine.model(batch["img"], charts, engine.adj, engine.original_adj)
        pts = batch_sample(verts, engine.faces, REPEAT * n, generator=engine.step_generator(8))
    preds = torch.cat(torch.split(pts, n, dim=1), 0).contiguous()
    out = {}
    for plain in (False, True):
        x = preds.clone().requires_grad_()
        cd = cluster.chamfer_clustered_tiled_gt(x, batch["gt_points"], REPEAT, plain=plain)
        (grad,) = torch.autograd.grad(cd.sum(), x)
        out[plain] = (cd.detach(), grad)
    value_err = float((out[False][0] - out[True][0]).abs().max())
    grad_err = float((out[False][1] - out[True][1]).abs().max())
    grad_max = float(out[True][1].abs().max())
    print(f"  chamfer_clustered_tiled_gt at (48, {n}) x (16, {n}): value max_abs_err {value_err}, "
          f"x-gradient max_abs_err {grad_err:.3e} against a largest element of {grad_max:.3e}")
    # the forward is the same arithmetic on the same neighbours; the backward
    # differs by the order of index_add_'s atomic adds: K2's tolerance, 1e-5
    # relative, against the gradient's largest element
    check(value_err == 0.0, "clustered Chamfer value: kernels != plain")
    check(grad_err <= 1e-5 * grad_max, "clustered Chamfer x-gradient: kernels != plain")

    # clustered against exact on the same batch and the same draws: a pruned
    # search can miss a neighbour, never find a nearer one
    loss_c, _ = loss_and_grads(engine, batch, 7)
    engine.config.loss_nn = "exact"
    loss_e, _ = loss_and_grads(engine, batch, 7)
    engine.config.loss_nn = "clustered"
    print(f"  full width: clustered loss {loss_c} exact loss {loss_e} "
          f"relative gap {(loss_c - loss_e) / loss_e:.3e}")
    check(loss_c >= loss_e * (1 - 1e-6), "clustered loss below the exact loss")

    small = dict(batch_size=2, number_points=256, num_gcn_layers=3, hidden_gcn_size=32,
                 num_cnn_blocks=3, eval=True, experiments_root=EXPERIMENTS)
    rng = np.random.default_rng(1)
    host = {
        "img": rng.uniform(size=(2, 64, 64, 3)).astype(np.float32),
        "gt_points": (rng.normal(size=(2, 256, 3)) * 0.1).astype(np.float32),
        "touch_charts": (rng.normal(size=(2, 5, 4, 25, 4)) * 0.1).astype(np.float32),
    }
    coded = dict(host, touch_charts=host["touch_charts"].copy())
    coded["touch_charts"][..., 3] = rng.integers(0, 3, size=(2, 5, 4, 25))  # mask codes: contacts
    draws = draw_sample_noise(2, REPEAT * 256, torch.Generator().manual_seed(2))
    for label, extra, data in (
        ("exact", dict(loss_nn="exact"), host),
        ("clustered, touch_global and touch_plane", dict(touch_global=True, touch_plane=True), coded),
    ):
        cfg = VisionConfig(**small, **extra)
        results = {}
        for device in ("cuda", "cpu"):
            eng = VisionEngine(cfg, device=device, log=False)
            d = tuple(t.to(device) for t in draws)
            results[device] = float(eng.eval_step(eng.to_device(data), draws=d))
            trained = float(eng.train_step(eng.to_device(data), draws=d))
            check(np.isfinite(trained), f"small width ({label}): non-finite train loss on {device}")
        rel = abs(results["cuda"] - results["cpu"]) / abs(results["cpu"])
        print(f"  small width ({label}): eval loss card {results['cuda']} "
              f"cpu {results['cpu']} rel {rel:.2e}")
        # the card runs the GCN products in bf16 and the convolutions in TF32
        check(rel <= 5e-2, f"small-width loss ({label}): card and CPU disagree")


def phase_profile(engine, batch: dict, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    gen = engine.step_generator(200)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"  profile ({label}): no device time recorded (not measured)")
        return
    print(f"  profile of one {label} train step: wall {wall_ms:.3f} ms (under the profiler), "
          f"device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print("== 1 environment")
    card = phase_environment()
    print("== 2 build")
    phase_build()
    print("== 3 kernels against their plain versions")
    timing = phase_kernels(dev)
    timing[NN_CLUSTER.name], timing[SEGSUM.name]["clustered_stream"] = phase_cluster(dev)
    print("== 4 main paths at full width: v_t_g exact, v_t_g clustered (the default), touch")
    paths, launches = phase_main_paths(dev)
    print("== 5 outputs")
    phase_outputs(paths)
    print("== 6 profile")
    for label, (engine, batch) in paths.items():
        phase_profile(engine, batch, label)
    print(f"== done in {time.perf_counter() - t_start:.1f} s")

    sources = {
        NN_EXACT.name: "active_3d_vision_and_touch_tpu/ops/chamfer.py:32",
        SEGSUM.name: "active_3d_vision_and_touch_tpu/ops/segsum.py:43",
        NN_CLUSTER.name: "active_3d_vision_and_touch_tpu/ops/chamfer_cluster.py:119",
    }
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {
            "name": k.name,
            "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": sources[k.name],
            # summed over the main paths, each counted from 0
            "launches": sum(by_kernel[k.name] for by_kernel in launches.values()),
            "launches_by_path": {path: by_kernel[k.name] for path, by_kernel in launches.items()},
            **{key: timing[k.name][key] for key in fields},
            **{key: value for key, value in timing[k.name].items() if key not in fields},
        }
        for k in KERNELS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
