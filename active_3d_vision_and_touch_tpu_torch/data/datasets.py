"""Host-side loading of the datasets of the three training stages.

The port's own copy of the JAX package's ``data/datasets.py``
(``object_dirs`` from its ``data/generation.py``, ``load_split``, the
object list, the array cache, ``TouchDataset``, ``VisionDataset``,
``ActiveDataset`` and the prefetching ``Loader``), over the same on-disk
layout.  It is numpy only: batches are dicts of numpy arrays, which the
engines and the environment move to their device.  One difference: the
vision dataset's training draw takes an optional ``seed``.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np

from active_3d_vision_and_touch_tpu_torch.utils import profiler


def object_dirs(root: str) -> dict:
    """The dataset's per-kind directories under ``root``."""
    return {
        "object_info": os.path.join(root, "object_info"),
        "point_cloud_info": os.path.join(root, "point_cloud_info"),
        "images_colourful": os.path.join(root, "images_colourful"),
        "grasp_info": os.path.join(root, "grasp_info"),
        "touch_charts": os.path.join(root, "touch_charts"),
    }


class _ArrayCache:
    """Process-wide read-only cache of ``np.load`` results.

    The datasets re-read the same per-object files every epoch, so epochs
    after the first come from RAM.  Bounded by ``cap_bytes`` (8 GB);
    entries are immutable: callers copy or index, never mutate.
    """

    def __init__(self, cap_bytes: int = 8 * 1024**3):
        self.cap = cap_bytes
        self.used = 0
        self.data: dict = {}
        self.lock = threading.Lock()

    def load(self, path: str) -> np.ndarray:
        with self.lock:
            arr = self.data.get(path)
        if arr is None:
            arr = np.load(path)
            arr.setflags(write=False)
            with self.lock:
                if self.used + arr.nbytes <= self.cap and path not in self.data:
                    self.data[path] = arr
                    self.used += arr.nbytes
        return arr


_array_cache = _ArrayCache()


def load_split(root: str) -> dict:
    return np.load(os.path.join(root, "data_split.npy"), allow_pickle=True).item()


def _object_names(root: str, split: str, limit: int | None = None) -> list[str]:
    dirs = object_dirs(root)
    names = sorted(
        os.path.basename(f)[: -len(".npy")]
        for f in glob(os.path.join(dirs["images_colourful"], "*.npy"))
    )
    if limit:
        random.Random(0).shuffle(names)
        names = names[:limit]
    split_names = set(load_split(root)[split])
    pc = dirs["point_cloud_info"]
    return [
        n
        for n in names
        if n in split_names and os.path.exists(os.path.join(pc, n + ".npy"))
    ]


class TouchDataset:
    """Items are the (object, grasp, finger) triples of the split's
    objects that hold a touch (``grasp_info/<obj>/<grasp>/<finger>_touch.npy``
    beside ``_points.npy`` and ``_ref_frame.npy``)."""

    def __init__(
        self,
        root: str,
        split: str = "recon_train",
        num_samples: int = 4000,
        limit: int | None = None,
    ):
        self.root = root
        self.dirs = object_dirs(root)
        self.num_samples = num_samples
        self.items: list[tuple[str, str, str]] = []
        for n in _object_names(root, split, limit):
            for touch_file in sorted(
                glob(os.path.join(self.dirs["grasp_info"], n, "*", "*_touch.npy"))
            ):
                grasp = os.path.basename(os.path.dirname(touch_file))
                finger = os.path.basename(touch_file).split("_")[0]
                self.items.append((n, grasp, finger))

    def __len__(self):
        return len(self.items)

    def _standardize(self, points: np.ndarray, rng) -> np.ndarray:
        """``num_samples`` of ``points``, drawn without repetition where
        there are enough, the cloud repeated fourfold until there are."""
        while points.shape[0] < self.num_samples:
            points = np.concatenate([points] * 4)
        return points[rng.permutation(points.shape[0])[: self.num_samples]]

    def __getitem__(self, index: int) -> dict:
        name, grasp, finger = self.items[index]
        gdir = os.path.join(self.dirs["grasp_info"], name, grasp)
        rng = np.random.default_rng(index)
        touch = _array_cache.load(os.path.join(gdir, f"{finger}_touch.npy"))
        points = _array_cache.load(os.path.join(gdir, f"{finger}_points.npy"))
        ref = np.load(os.path.join(gdir, f"{finger}_ref_frame.npy"), allow_pickle=True).item()
        return {
            "names": (name, grasp, finger),
            "sim_touch": touch.astype(np.float32) / 255.0,
            "samples": self._standardize(points, rng).astype(np.float32),
            "ref_pos": np.asarray(ref["pos"], np.float32),
            "ref_rot": np.asarray(ref["rot"], np.float32),
        }

    @staticmethod
    def collate(items: list[dict]) -> dict:
        out = {"names": [it["names"] for it in items]}
        for key in ("sim_touch", "samples", "ref_pos", "ref_rot"):
            out[key] = np.stack([it[key] for it in items])
        return out


class VisionDataset:
    """Per object: the image, the gt cloud and the padded touch-chart
    slots of a draw of grasps.

    Training draws a random object, a grasp count in [0, num_grasps] and
    the grasp ids.  Outside training each object is drawn 5 times, each
    draw fixed by (object, draw) (reference ``data_loaders.py:172-193``);
    under ``eval_mode`` a ``val_grasps`` >= 0 fixes the count.  The
    training draw comes from ``random.Random()`` (the operating system's
    entropy), as in the JAX package, or, given a ``seed``, from a generator
    seeded from (seed, item, how often the item was read), whatever the
    loader's thread order.
    """

    def __init__(
        self,
        root: str,
        split: str = "recon_train",
        use_img: bool = True,
        use_touch: bool = True,
        finger: bool = False,
        num_grasps: int = 5,
        number_points: int = 30000,
        num_actions: int = 50,
        val_grasps: int = -1,
        eval_mode: bool = False,
        limit: int | None = None,
        seed: int | None = None,
    ):
        self.root = root
        self.dirs = object_dirs(root)
        self.split = split
        self.training = split in ("recon_train", "auto_train")
        self.use_img = use_img
        self.use_touch = use_touch
        self.finger = finger
        self.num_grasps = num_grasps
        self.number_points = number_points
        self.num_actions = num_actions
        self.val_grasps = val_grasps
        self.eval_mode = eval_mode
        self.seed = seed
        self._reads: Counter = Counter()
        self._lock = threading.Lock()
        base = _object_names(root, split, limit)
        if use_touch:
            base = [
                n for n in base
                if os.path.exists(os.path.join(self.dirs["touch_charts"], n, "touch_charts.npy"))
            ]
        iters = 1 if self.training else 5
        self.items = [(n, s) for s in range(iters) for n in base]

    def __len__(self):
        return len(self.items)

    def _train_rng(self, index: int) -> random.Random:
        if self.seed is None:
            return random.Random()
        with self._lock:
            reads = self._reads[index]
            self._reads[index] += 1
        return random.Random(zlib.crc32(f"{self.seed}:{index}:{reads}".encode()))

    def _grasp_draw(self, index: int):
        if self.training:
            rng = self._train_rng(index)
            name, _ = rng.choice(self.items)
        else:
            name, seed = self.items[index]
            # stable across processes (python's str hash is salted)
            rng = random.Random(zlib.crc32(f"{name}:{seed}".encode()))
        if (not self.training) and self.eval_mode and self.val_grasps >= 0:
            count = self.val_grasps
        else:
            count = rng.choice(range(0, self.num_grasps + 1))
        grasps = list(range(self.num_actions))
        rng.shuffle(grasps)
        return name, grasps[:count]

    def __getitem__(self, index: int) -> dict:
        name, grasps = self._grasp_draw(index)
        rng = np.random.default_rng(zlib.crc32(f"{name}:{index}".encode()))
        data = {"names": (name, tuple(grasps))}
        points = _array_cache.load(os.path.join(self.dirs["point_cloud_info"], name + ".npy"))
        pick = rng.permutation(points.shape[0])[: self.number_points]
        data["gt_points"] = points[pick].astype(np.float32)
        if self.use_img:
            img = _array_cache.load(os.path.join(self.dirs["images_colourful"], name + ".npy"))
            data["img"] = img.astype(np.float32) / 255.0
        if self.use_touch:
            all_charts = _array_cache.load(
                os.path.join(self.dirs["touch_charts"], name, "touch_charts.npy")
            ).reshape(self.num_actions, 4, 25, 4)
            picked = all_charts[grasps]  # (k, 4, 25, 4)
            if self.finger:
                picked = picked[:, 1]  # the canonical finger
                pad = np.zeros((self.num_grasps - len(grasps), 25, 4), np.float32)
            else:
                pad = np.zeros((self.num_grasps - len(grasps), 4, 25, 4), np.float32)
            data["touch_charts"] = np.concatenate([picked, pad]).astype(np.float32)
        return data

    @staticmethod
    def collate(items: list[dict]) -> dict:
        out = {"names": [it["names"] for it in items]}
        for key in ("gt_points", "img", "touch_charts"):
            if key in items[0]:
                out[key] = np.stack([it[key] for it in items])
        return out


class ActiveDataset:
    """Rollout objects: image + gt cloud + names, the length truncated to a
    multiple of ``env_batch_size`` (reference ``data_loaders.py:263-336``)."""

    def __init__(
        self,
        root: str,
        split: str = "RL_train",
        use_img: bool = True,
        number_points: int = 30000,
        env_batch_size: int = 3,
        limit: int | None = None,
    ):
        self.root = root
        self.dirs = object_dirs(root)
        self.use_img = use_img
        self.number_points = number_points
        self.env_batch_size = env_batch_size
        self.names = _object_names(root, split, limit)

    def __len__(self):
        return (len(self.names) // self.env_batch_size) * self.env_batch_size

    def __getitem__(self, index: int) -> dict:
        name = self.names[index]
        rng = np.random.default_rng(zlib.crc32(str(name).encode()))
        points = _array_cache.load(os.path.join(self.dirs["point_cloud_info"], name + ".npy"))
        pick = rng.permutation(points.shape[0])[: self.number_points]
        data = {
            "names": os.path.join(self.dirs["object_info"], name),
            "gt_points": points[pick].astype(np.float32),
        }
        if self.use_img:
            img = _array_cache.load(os.path.join(self.dirs["images_colourful"], name + ".npy"))
            data["img"] = img.astype(np.float32) / 255.0
        return data

    @staticmethod
    def collate(items: list[dict]) -> dict:
        out = {"names": [it["names"] for it in items]}
        for key in ("gt_points", "img"):
            if key in items[0]:
                out[key] = np.stack([it[key] for it in items])
        return out


class Loader:
    """Minimal prefetching batch loader over a dataset with ``collate``.

    One thread assembles batches (items read by a small thread pool) ahead
    of the consumer.  An error in a worker is raised to the consumer.  The
    consumer's wait for a batch is the span ``loader.wait``; a wait that
    found the queue empty counts ``loader.starved``.

    ``process_shard=(index, count)`` shards the data over ranks: every rank
    draws the same seeded global order and keeps ``order[index::count]``,
    so the ranks' batches are disjoint and together make the global batch
    (``batch_size`` is the local one)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        num_threads: int = 4,
        process_shard: tuple[int, int] | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.process_shard = process_shard
        self._epoch = 0

    def _local_len(self) -> int:
        n = len(self.dataset)
        if self.process_shard is not None:
            index, count = self.process_shard
            n = (n - index + count - 1) // count
        return n

    def __len__(self):
        n = self._local_len() // self.batch_size
        if not self.drop_last and self._local_len() % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        if self.process_shard is not None:
            index, count = self.process_shard
            order = order[index::count]
        self._epoch += 1
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in batches:
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(self.dataset.collate(items)):
                            return
                put(stop)
            except Exception as e:  # handed to the consumer, which raises it
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                if q.empty():
                    profiler.count("loader.starved")
                with profiler.span("loader.wait"):
                    item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            abandoned.set()
