"""Steady-state throughput between device synchronisations.

Counterpart of ``tpu_ddp/metrics/timing.py`` (``Throughput``). PyTorch
returns before the device finishes, so ``start`` and ``stop`` synchronise
the device: the interval then covers the device work, not the enqueue.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from tpu_ddp_torch.runtime import synchronize


class Throughput:
    """Images per second over the timed intervals, on one chip."""

    def __init__(self, device: torch.device):
        self.device = device
        self.images = 0
        self.seconds = 0.0
        self._start: Optional[float] = None

    def start(self) -> None:
        synchronize(self.device)
        self._start = time.perf_counter()

    def add(self, n_images: int) -> None:
        self.images += n_images

    def stop(self) -> None:
        if self._start is None:
            raise RuntimeError("Throughput.stop() without start()")
        synchronize(self.device)
        self.seconds += time.perf_counter() - self._start
        self._start = None

    @property
    def images_per_sec_per_chip(self) -> float:
        if not self.seconds:
            return float("nan")
        return self.images / self.seconds
