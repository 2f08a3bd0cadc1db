"""Telemetry event model: spans, instants, counter snapshots.

Counterpart of ``tpu_ddp/telemetry/events.py``, with its schema versions.
Deliberately stdlib-only (no torch import): the launcher
(``tpu_ddp_torch/cli/launch.py``) emits job-lifecycle events from a process
that must never initialize a backend, and the summarizer reads traces on
machines with no accelerator stack at all.

Timestamps are **monotonic** (``time.monotonic``) relative to a per-process
``Clock`` epoch, so span math is immune to wall-clock steps (NTP slews
mid-run would otherwise produce negative durations). The wall-clock anchor
of the epoch is recorded once in the sink header so traces from different
hosts can be aligned offline.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional

#: Version of the JSONL trace record schema. Bump on any breaking change to
#: the record shape; ``trace summarize`` refuses records from the future.
SCHEMA_VERSION = 1

#: Version of the run-metadata dict embedded in sink headers (config
#: snapshot, torch version, device kind, mesh, strategy). Bump on breaking
#: changes; readers refuse metadata from the future.
RUN_META_SCHEMA_VERSION = 1

#: Version of the ``eval`` instant's attrs (the step/epoch-anchored eval
#: point the Trainer emits into the trace per evaluation — the durable
#: eval HISTORY that used to die as latest-value gauges). Bump on
#: breaking changes; the curve readers refuse points from the future.
EVAL_POINT_SCHEMA_VERSION = 1

# Event kinds
SPAN = "span"          # a named phase with a duration
INSTANT = "instant"    # a point event (trace written, watchdog fired, ...)
COUNTERS = "counters"  # a registry snapshot at a point in time


class Clock:
    """Monotonic clock with a recorded wall-time anchor for its epoch."""

    def __init__(self) -> None:
        self.epoch_monotonic = time.monotonic()
        self.epoch_unix = time.time()

    def now(self) -> float:
        """Seconds since this clock's epoch (monotonic)."""
        return time.monotonic() - self.epoch_monotonic


@dataclasses.dataclass
class Event:
    """One telemetry record. ``ts_s`` is seconds since the emitting
    process's ``Clock`` epoch; ``dur_s`` is 0 for non-span kinds."""

    name: str
    kind: str = SPAN
    ts_s: float = 0.0
    dur_s: float = 0.0
    step: Optional[int] = None
    process_index: int = 0
    thread_id: int = 0
    depth: int = 0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        """JSON-serializable dict (the JSONL line body)."""
        rec: Dict[str, Any] = {
            "schema_version": SCHEMA_VERSION,
            "type": self.kind,
            "name": self.name,
            "ts_s": round(self.ts_s, 9),
            "pid": self.process_index,
            "tid": self.thread_id,
        }
        if self.kind == SPAN:
            rec["dur_s"] = round(self.dur_s, 9)
            rec["depth"] = self.depth
        if self.step is not None:
            rec["step"] = self.step
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec


class _SpanStack(threading.local):
    """Per-thread open-span stack (for nesting depth)."""

    def __init__(self) -> None:
        self.depth = 0


_stack = _SpanStack()


def current_depth() -> int:
    return _stack.depth


def push_span() -> int:
    """Enter a span on this thread; returns the span's nesting depth."""
    d = _stack.depth
    _stack.depth = d + 1
    return d


def pop_span() -> None:
    _stack.depth = max(0, _stack.depth - 1)
