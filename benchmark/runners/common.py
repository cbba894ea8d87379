"""What the runners share: the feed from the port's ``Loader``, the
benchmark's own spans, the configuration's precision."""

from __future__ import annotations

import contextlib
import time

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Feed:
    """The port's ``Loader``, epochs chained; the host's wait in each
    ``next()`` is the benchmark's own span."""

    def __init__(self, loader):
        self.loader, self.it, self.waits = loader, iter(loader), []

    def next(self) -> dict:
        t0 = time.perf_counter()
        try:
            raw = next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            raw = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        return raw

    def close(self) -> None:
        self.it.close()


class Preloaded(Feed):
    """``count`` batches of the port's ``Loader``, assembled in the set-up
    and then cycled: the step without the Loader's threads beside it."""

    def __init__(self, loader, count: int):
        it = iter(loader)
        self.batches, self.i, self.waits = [], 0, []
        while len(self.batches) < count:
            try:
                self.batches.append(next(it))
            except StopIteration:
                it = iter(loader)
        it.close()

    def next(self) -> dict:
        t0 = time.perf_counter()
        raw = self.batches[self.i % len(self.batches)]
        self.i += 1
        self.waits.append(time.perf_counter() - t0)
        return raw

    def close(self) -> None:
        self.batches = []


def no_span(name: str):
    return contextlib.nullcontext()


def precision(config: dict) -> None:
    """TF32 on or off for float32 products and convolutions, as the
    configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = config["precision"]["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = config["precision"]["conv_tf32"]


class Phases:
    """Seconds of the set-up's phases, in order, from the process's start."""

    def __init__(self, t_start: float):
        self.last, self.spans = t_start, []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.spans.append((name, now - self.last))
        self.last = now

    def note(self) -> str:
        return "set-up s: " + ", ".join(f"{name} {s:.3f}" for name, s in self.spans)
