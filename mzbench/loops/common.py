"""Pieces both traffic loops use."""

from __future__ import annotations

import numpy as np
import torch


class Marker:
    """A point in the device's queue: a CUDA event recorded now, or, on the
    CPU, where every operation has finished when it returns, nothing."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn with ``rng``
    (reservoir sampling), so that which answers are checked follows the
    seed and not the run's length."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def rng(seed: int, stream: int) -> np.random.Generator:
    """A NumPy generator for one use (``stream``) of the run's seed."""
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check(name: str, value: int, limit: int) -> dict:
    """One number compared: correct needs ``value`` at most ``limit``."""
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(value <= limit)}
