"""Offline dataset generation.

The port's copy of the JAX package's ``data/generation.py``: the same files,
byte for byte, from the same seeds; the touch-chart stage runs the port's
``TouchEngine`` on its device.

Produces the on-disk dataset the loaders and the active environment
consume, mirroring the reference pipeline (``utility/data_making.py``) plus
the touch-chart cache producer the reference *lacks* (its
``touch_charts.npy`` files only ship inside the downloaded tar; SURVEY.md
§L3 note):

    object_info/<id>_verts.npy, <id>_faces.npy, <id>.obj
    point_cloud_info/<id>.npy            30k surface points
    images_colourful/<id>.npy            256x256x3 RGB
    grasp_info/<id>/<grasp>/<finger>_touch.npy, _points.npy, _ref_frame.npy
    touch_charts/<id>/touch_charts.npy   (50, 4, 25, 4) predicted charts
    data_split.npy                       named splits dict

Objects come from :mod:`data.primitives` (procedural) or from any OBJ
collection through the same preprocessing.
"""

from __future__ import annotations

import functools
import os
import zlib
from glob import glob
from pathlib import Path

import numpy as np
from scipy import ndimage

from active_3d_vision_and_touch_tpu_torch.core.device import host_to_device
from active_3d_vision_and_touch_tpu_torch.core.mesh import load_obj, save_obj, scale_points
from active_3d_vision_and_touch_tpu_torch.data.datasets import object_dirs
from active_3d_vision_and_touch_tpu_torch.data.primitives import random_object
from active_3d_vision_and_touch_tpu_torch.sim.collision import subdivide_to_density
from active_3d_vision_and_touch_tpu_torch.sim.sampler import Sampler

SPLIT_NAMES = ("recon_train", "auto_train", "RL_train", "valid", "test")


# --------------------------------------------------------------------------
# surface point-cloud extraction (voxelize → ODM space carve → surface)
# reference: data_making.py:50-72 + utils.py:382-532, vectorized numpy
# --------------------------------------------------------------------------
def _first_last_occupied(occ: np.ndarray, axis: int):
    """Per-pixel (min, max) occupied index along ``axis`` (dim where empty)."""
    dim = occ.shape[axis]
    idx = np.arange(dim)
    shape = [1, 1, 1]
    shape[axis] = dim
    idx = idx.reshape(shape)
    any_occ = occ.any(axis=axis)
    lo = np.where(any_occ, np.where(occ, idx, dim).min(axis=axis), dim)
    hi = np.where(any_occ, np.where(occ, idx, -1).max(axis=axis), -1)
    return lo, hi, any_occ


def carve_voxels(occ: np.ndarray) -> np.ndarray:
    """Orthographic-depth-map space carving: keep only voxels inside the
    visual hull defined by the 6 axis-aligned depth maps, fill interior."""
    dim = occ.shape[0]
    keep = np.ones_like(occ, bool)
    for axis in range(3):
        lo, hi, any_occ = _first_last_occupied(occ, axis)
        shape = [1, 1, 1]
        shape[axis] = dim
        idx = np.arange(dim).reshape(shape)
        lo_b = np.expand_dims(lo, axis)
        hi_b = np.expand_dims(hi, axis)
        keep &= (idx >= lo_b) & (idx <= hi_b)
    keep = ndimage.binary_fill_holes(keep)
    return keep


def extract_surface_points(
    verts: np.ndarray,
    faces: np.ndarray,
    dim: int = 128,
    num_points: int = 30000,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """(num_points, 3) uniform-ish surface cloud aligned to the mesh."""
    rng = rng or np.random.default_rng(0)
    verts = np.asarray(verts, np.float64)
    vmin, vmax = verts.min(), verts.max()
    unit = (verts - vmin) / (vmax - vmin) - 0.5

    pts = subdivide_to_density(unit, np.asarray(faces), 1.0 / dim)
    idx = np.clip(((pts + 0.5) * (dim - 1)).astype(int), 0, dim - 1)
    occ = np.zeros((dim,) * 3, bool)
    occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True

    solid = carve_voxels(occ)
    # surface voxels: occupied with at least one empty 26-neighbor
    counts = ndimage.convolve(solid.astype(np.float32), np.ones((3, 3, 3)), mode="constant")
    surface = solid & (counts < 27)
    points = np.argwhere(surface).astype(np.float64)

    # realign voxel indices to the original mesh extents (utils.py:522-532)
    for i in range(3):
        points[:, i] -= (points[:, i].max() + points[:, i].min()) / 2.0
        v_range = verts[:, i].max() - verts[:, i].min()
        p_range = points[:, i].max() + 1 - points[:, i].min()
        points[:, i] *= v_range / p_range
    points += (verts.max(0) + verts.min(0)) / 2.0

    while points.shape[0] < num_points:
        points = np.concatenate([points, points])
    choice = rng.choice(points.shape[0], num_points, replace=False)
    return points[choice].astype(np.float32)


# --------------------------------------------------------------------------
# dataset directory builders
# --------------------------------------------------------------------------
def save_object_info(
    root: str, num_objects: int, seed: int = 0, version: int = 3
) -> list[str]:
    """Generate procedural objects and store verts/faces/obj per object."""
    dirs = object_dirs(root)
    os.makedirs(dirs["object_info"], exist_ok=True)
    names = []
    for i in range(num_objects):
        name = f"{i:06d}"
        base = os.path.join(dirs["object_info"], name)
        if not os.path.exists(base + "_faces.npy"):
            # objects are deterministic per (seed, index): skipping existing
            # ones is a pure no-op that also keeps growth runs from
            # rewriting files a concurrently-running campaign is reading
            mesh = random_object(seed * 1_000_003 + i, version=version)
            np.save(base + "_verts.npy", mesh.verts)
            np.save(base + "_faces.npy", mesh.faces)
            save_obj(base + ".obj", mesh.verts, mesh.faces)
        names.append(name)
    return names


def ingest_obj_dir(root: str, obj_dir: str, scale: float = 3.1) -> list[str]:
    """Ingest an external OBJ collection into ``object_info``.

    The reference rescales/centers every downloaded ABC mesh before
    simulation (``utility/data_making.py:76-95``); we apply the identical
    normalization (:func:`core.mesh.scale_points` with the same default
    scale) to each OBJ's vertices and then store verts/faces/obj in the
    dataset layout, so the rest of the pipeline (point clouds, grasp
    simulation, splits, training) is byte-for-byte the procedural path.
    Files are taken in sorted order and renamed to the ``%06d`` scheme
    (the original stem is kept in a sidecar ``<name>_source.txt``)."""
    paths = sorted(glob(os.path.join(obj_dir, "*.obj")))
    if not paths:
        raise FileNotFoundError(f"no .obj files found in {obj_dir!r}")
    dirs = object_dirs(root)
    os.makedirs(dirs["object_info"], exist_ok=True)
    names = []
    for i, path in enumerate(paths):
        name = f"{i:06d}"
        mesh = load_obj(path)
        verts = scale_points(mesh.verts, scale=scale)
        base = os.path.join(dirs["object_info"], name)
        np.save(base + "_verts.npy", verts)
        np.save(base + "_faces.npy", mesh.faces)
        save_obj(base + ".obj", verts, mesh.faces)
        with open(base + "_source.txt", "w") as f:
            f.write(os.path.basename(path) + "\n")
        names.append(name)
    return names


def save_point_info(root: str, dim: int = 128, num_points: int = 30000) -> None:
    dirs = object_dirs(root)
    os.makedirs(dirs["point_cloud_info"], exist_ok=True)
    for file in sorted(glob(os.path.join(dirs["object_info"], "*_verts.npy"))):
        name = os.path.basename(file)[: -len("_verts.npy")]
        dest = os.path.join(dirs["point_cloud_info"], name + ".npy")
        if os.path.exists(dest):
            continue
        verts = np.load(file)
        faces = np.load(file.replace("_verts", "_faces"))
        pts = extract_surface_points(verts, faces, dim=dim, num_points=num_points)
        np.save(dest, pts)


def save_simulation(
    root: str,
    num_actions: int = 50,
    batch_size: int = 8,
    names: list[str] | None = None,
) -> None:
    """Run every grasp on every object, dumping touch signals, touch point
    clouds, sensor frames, and one RGB image per object."""
    dirs = object_dirs(root)
    os.makedirs(dirs["grasp_info"], exist_ok=True)
    os.makedirs(dirs["images_colourful"], exist_ok=True)
    if names is None:
        names = sorted(
            os.path.basename(f)[: -len("_verts.npy")]
            for f in glob(os.path.join(dirs["object_info"], "*_verts.npy"))
        )

    for start in range(0, len(names), batch_size):
        chunk = names[start : start + batch_size]
        s = Sampler(bs=len(chunk), vision=True)
        prefixes = [os.path.join(dirs["object_info"], n) for n in chunk]
        s.load_objects(prefixes, from_dataset=True)

        signals = s.sample([0] * len(chunk), touch=False, vision=True)
        for n, img in zip(chunk, signals["vision"]):
            np.save(os.path.join(dirs["images_colourful"], n + ".npy"), img)

        for action in range(num_actions):
            signals = s.sample([action] * len(chunk), touch=True, touch_point_cloud=True)
            for b, n in enumerate(chunk):
                for finger in range(4):
                    dest = Path(dirs["grasp_info"]) / n / str(action)
                    dest.mkdir(parents=True, exist_ok=True)
                    status = signals["touch_status"][b][finger]
                    if status == "touch":
                        np.save(
                            dest / f"{finger}_touch.npy",
                            signals["touch_signal"][b][finger].astype(np.uint8),
                        )
                        pts = signals["touch_point_cloud"][b][finger]
                        if len(pts) > 4096:
                            # full 121^2 unprojections dominate the dump
                            # (up to 176 KB/finger, ~31 MB/object); training
                            # draws 2000 iid points, so a 4096-point random
                            # subsample is statistically equivalent and 3x
                            # smaller on disk
                            keep = np.random.default_rng(
                                zlib.crc32(f"{n}:{action}:{finger}".encode())
                            ).choice(len(pts), 4096, replace=False)
                            pts = pts[keep]
                        np.save(dest / f"{finger}_points.npy", pts)
                    if status != "no_intersection":
                        ref = {
                            "pos": signals["finger_transform_pos"][b][finger],
                            "rot": signals["finger_transform_rot_M"][b][finger],
                        }
                        np.save(dest / f"{finger}_ref_frame.npy", ref)
        s.disconnect()


def make_data_split(
    root: str,
    train: int | None = None,
    valid: int | None = None,
    test: int | None = None,
) -> dict:
    """Named splits over the generated objects (reference sizes 7700x3 /
    2000 / 1000 scale down proportionally for small runs).

    Assignment is a STABLE per-name hash bucket (not a shuffle of the name
    list): an object keeps its split as the dataset grows, so a pilot run
    on a prefix can never leak later test objects into training.  Explicit
    ``train``/``valid``/``test`` counts subsample the buckets."""
    dirs = object_dirs(root)
    names = sorted(
        os.path.basename(f)[: -len("_verts.npy")]
        for f in glob(os.path.join(dirs["object_info"], "*_verts.npy"))
    )
    if train is not None and valid is not None and test is not None:
        # explicit counts (tiny fixtures): slice the hash-ordered list so
        # every split is guaranteed its requested size
        names = sorted(names, key=lambda n: zlib.crc32(f"split:{n}".encode()))
        splits = {
            "recon_train": names[:train],
            "auto_train": names[train : 2 * train],
            "RL_train": names[2 * train : 3 * train],
            "valid": names[3 * train : 3 * train + valid],
            "test": names[3 * train + valid : 3 * train + valid + test],
        }
        np.save(os.path.join(root, "data_split.npy"), splits)
        return splits

    # proportions mirror the reference: 3 x 28% train pools, 8% valid,
    # remainder test
    edges = {"recon_train": 28, "auto_train": 56, "RL_train": 84,
             "valid": 92, "test": 100}
    splits = {k: [] for k in edges}
    for n in names:
        bucket = zlib.crc32(f"split:{n}".encode()) % 100
        for k, hi in edges.items():
            if bucket < hi:
                splits[k].append(n)
                break
    caps = {"recon_train": train, "auto_train": train, "RL_train": train,
            "valid": valid, "test": test}
    for k, cap in caps.items():
        if cap is not None:
            splits[k] = splits[k][: max(cap, 1)]
    # tiny datasets can leave buckets empty — rebalance so the splits fill
    # in priority order (train pools before eval pools, matching the old
    # count-based behavior).  Real datasets never hit this: no bucket runs
    # empty, so their assignment stays purely hash-stable.
    priority = list(edges)
    for k in priority:
        if splits[k]:
            continue
        for donor in reversed(priority):
            spare = len(splits[donor]) > 1 or (
                splits[donor] and priority.index(donor) > priority.index(k)
            )
            if donor != k and spare:
                splits[k].append(splits[donor].pop())
                break
    np.save(os.path.join(root, "data_split.npy"), splits)
    return splits


def make_touch_charts(
    root: str, touch_engine, batch: int = 128, num_actions: int = 50
) -> None:
    """Cache predicted touch charts for every (object, grasp, finger) slot:
    (50, 4, 25, 4) = chart xyz + mask channel.  Mask codes follow the
    environment convention: 0 failed grasp, 1 grasp-without-touch (chart
    collapsed to the sensor position), 2 successful touch.

    ``touch_engine`` is a :class:`train.touch.TouchEngine`; its model runs
    frozen on the engine's device, ``batch`` images a call (the last call of
    an object takes the rest, unpadded).  This is the producer for the files
    the reference only ships pre-built (``data_loaders.py:216-218``).
    """
    dirs = object_dirs(root)
    os.makedirs(dirs["touch_charts"], exist_ok=True)
    # sent without waiting: the host goes on reading while the card computes
    to_device = functools.partial(host_to_device, device=touch_engine.device)

    def read_object(obj_dir):
        """Host half: gather one object's touch images + frames."""
        charts = np.zeros((num_actions, 4, 25, 4), np.float32)
        pending = []  # (grasp, finger, touch_img, pos, rot)
        for grasp in range(num_actions):
            gdir = os.path.join(obj_dir, str(grasp))
            for finger in range(4):
                ref_file = os.path.join(gdir, f"{finger}_ref_frame.npy")
                touch_file = os.path.join(gdir, f"{finger}_touch.npy")
                if not os.path.exists(ref_file):
                    continue  # failed grasp: mask 0, zeros
                ref = np.load(ref_file, allow_pickle=True).item()
                if os.path.exists(touch_file):
                    img = np.load(touch_file).astype(np.float32) / 255.0
                    pending.append((grasp, finger, img, ref["pos"], ref["rot"]))
                else:  # grasp but no touch: chart collapses to sensor origin
                    charts[grasp, finger, :, :3] = ref["pos"]
                    charts[grasp, finger, :, 3] = 1.0
        return charts, pending

    def dispatch(pending):
        """Device half: queue the predict calls for the pending list; the
        charts stay on the device."""
        futures = []
        for i in range(0, len(pending), batch):
            chunk = pending[i : i + batch]
            touch, pos, rot = (np.stack([c[k] for c in chunk]) for k in (2, 3, 4))
            futures.append(
                (chunk, touch_engine.predict(to_device(touch), to_device(pos), to_device(rot)))
            )
        return futures

    def finalize(name, charts, futures):
        for chunk, verts_dev in futures:
            verts = verts_dev.cpu().numpy()
            for (grasp, finger, *_), v in zip(chunk, verts):
                charts[grasp, finger, :, :3] = v
                charts[grasp, finger, :, 3] = 2.0
        dest_dir = os.path.join(dirs["touch_charts"], name)
        os.makedirs(dest_dir, exist_ok=True)
        np.save(os.path.join(dest_dir, "touch_charts.npy"), charts)

    # software pipeline: while the device runs object i's predict batches
    # (CUDA launches are asynchronous), the host reads object i+1's files
    grasp_dirs = [
        d
        for d in sorted(glob(os.path.join(dirs["grasp_info"], "*")))
        if not os.path.exists(
            os.path.join(
                dirs["touch_charts"], os.path.basename(d), "touch_charts.npy"
            )
        )
    ]
    in_flight = None  # (name, charts, futures)
    for obj_dir in grasp_dirs:
        charts, pending = read_object(obj_dir)
        if in_flight is not None:
            finalize(*in_flight)
        in_flight = (os.path.basename(obj_dir), charts, dispatch(pending))
    if in_flight is not None:
        finalize(*in_flight)


def generate_dataset(
    root: str,
    num_objects: int,
    seed: int = 0,
    num_actions: int = 50,
    point_dim: int = 128,
    num_points: int = 30000,
    version: int = 3,
    from_obj_dir: str | None = None,
) -> dict:
    """One-call pipeline: objects → point clouds → simulation → split.

    ``from_obj_dir`` swaps the procedural generator for an external OBJ
    collection (reference ABC-download path, ``data_making.py:76-95``);
    ``num_objects``/``seed``/``version`` are ignored in that mode."""
    if from_obj_dir is not None:
        names = ingest_obj_dir(root, from_obj_dir)
    else:
        names = save_object_info(root, num_objects, seed, version=version)
    save_point_info(root, dim=point_dim, num_points=num_points)
    save_simulation(root, num_actions=num_actions, names=names)
    return make_data_split(root)
