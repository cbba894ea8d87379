"""Host-side loading of the active policies' rollout objects.

The port's own copy of the part of the JAX package's ``data/datasets.py``
that the policies read (``object_dirs`` from its ``data/generation.py``,
``load_split``, the object list, the array cache, ``ActiveDataset`` and the
prefetching ``Loader``).  It is numpy only: batches are dicts of numpy
arrays, which the environment moves to its device.  The touch and vision
datasets are not here yet.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from glob import glob

import numpy as np


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
    of the consumer.  An error in a worker is raised to the consumer."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        num_threads: int = 4,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
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
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            abandoned.set()
