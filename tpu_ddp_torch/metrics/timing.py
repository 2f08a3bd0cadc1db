"""Steady-state throughput between device synchronisations.

Counterpart of ``tpu_ddp/metrics/timing.py`` (``Throughput``). PyTorch
returns before the device finishes, so ``start`` and ``stop`` synchronise
the device: the interval then covers the device work, not the enqueue.
With a telemetry ``registry``, ``stop`` publishes the JAX class's gauges
``throughput/images_per_sec`` and ``throughput/images_per_sec_per_chip``
(one card a rank: the same number).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from tpu_ddp_torch.runtime import synchronize


class Throughput:
    """Images per second over the timed intervals, on one chip."""

    def __init__(self, device: torch.device, registry=None):
        self.device = device
        self._registry = registry
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
        if self._registry is not None and self.seconds:
            for name in ("throughput/images_per_sec", "throughput/images_per_sec_per_chip"):
                self._registry.gauge(name).set(self.images_per_sec_per_chip)

    @property
    def images_per_sec_per_chip(self) -> float:
        if not self.seconds:
            return float("nan")
        return self.images / self.seconds
