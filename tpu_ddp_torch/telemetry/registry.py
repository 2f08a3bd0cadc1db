"""Process-wide metric registry: counters, gauges, histograms.

Counterpart of ``tpu_ddp/telemetry/registry.py``. Thread-safe (the
watchdog thread, the prefetcher thread and the checkpoint writer all record
concurrently with the train loop) and stdlib-only. ``default_registry()``
is the process-wide instance every subsystem shares.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonically increasing count (steps, images, recompiles)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins scalar (images/sec, HBM high-water, MFU)."""

    def __init__(self) -> None:
        self._value: Optional[float] = None

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> Optional[float]:
        return self._value


class Histogram:
    """Streaming distribution with exact percentiles over a bounded window.

    Keeps up to ``max_samples`` raw values (plenty for per-step phase times
    over any realistic run); count/sum/min/max stay exact beyond the window.
    """

    def __init__(self, max_samples: int = 65536) -> None:
        self._lock = threading.Lock()
        self._values: List[float] = []
        self._max_samples = max_samples
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self._values) < self._max_samples:
                self._values.append(v)

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the retained window; None if empty."""
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return None
        rank = max(0, min(len(vals) - 1, math.ceil(p / 100.0 * len(vals)) - 1))
        return vals[rank]

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def summary(self) -> Dict[str, Optional[float]]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
        }


class Registry:
    """Named metric namespace; get-or-create accessors are thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time view of every metric, JSON-serializable."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in counters.items()},
            "gauges": {
                k: g.value for k, g in gauges.items() if g.value is not None
            },
            "histograms": {k: h.summary() for k, h in histograms.items()},
        }


_default: Optional[Registry] = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    """The process-wide registry (created on first use)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Registry()
        return _default


def reset_default_registry() -> None:
    """Drop the process-wide registry (tests only: isolates counts)."""
    global _default
    with _default_lock:
        _default = None
