"""Pluggable telemetry sinks.

Counterpart of ``tpu_ddp/telemetry/sinks.py``: the same records for the
same events. Three in-tree sinks, all stdlib-only:

- ``JsonlTraceSink`` — schema-versioned JSON Lines, one record per event,
  flushed line-by-line so a crash (or a watchdog SIGKILL) loses at most the
  event being written. This is the canonical on-disk format that
  ``python -m tpu_ddp_torch.telemetry summarize`` reads.
- ``ChromeTraceSink`` — Chrome ``trace_event`` JSON (the
  ``{"traceEvents": [...]}`` object form), loadable in Perfetto
  (https://ui.perfetto.dev) or ``chrome://tracing``. Spans become complete
  ("X") events, instants become "i", counter snapshots become "C" series.
- ``TerminalSummarySink`` — aggregates span durations per phase and prints
  a per-phase table (count / total / mean / p50 / p95 / max) on close.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Dict, List, Optional, TextIO

from tpu_ddp_torch.telemetry.events import (
    COUNTERS,
    SCHEMA_VERSION,
    SPAN,
    Clock,
    Event,
)
from tpu_ddp_torch.telemetry.registry import Histogram


class Sink:
    """Interface: receives every Event; close() finalizes output."""

    def emit(self, event: Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlTraceSink(Sink):
    """One JSON object per line; first line is a header record carrying the
    wall-clock anchor of the monotonic epoch (for cross-host alignment)
    and, when provided, the RUN METADATA (config snapshot, torch version,
    device kind, mesh shape, strategy) — what lets a reader label a run and
    refuse a mismatched one instead of treating every trace as
    anonymous."""

    def __init__(self, path: str, *, clock: Optional[Clock] = None,
                 process_index: int = 0,
                 run_meta: Optional[dict] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._fh: Optional[TextIO] = open(path, "w")
        clock = clock or Clock()
        header = {
            "schema_version": SCHEMA_VERSION,
            "type": "header",
            "epoch_unix": clock.epoch_unix,
            "pid": process_index,
        }
        if run_meta:
            header["run_meta"] = run_meta
        self._write(header)

    def _write(self, record: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(json.dumps(record) + "\n")
            # crash-safe: every line reaches the OS before the next event
            self._fh.flush()

    def emit(self, event: Event) -> None:
        self._write(event.to_record())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class ChromeTraceSink(Sink):
    """Buffers Chrome trace_event records; writes the JSON object on close.

    ``ts``/``dur`` are microseconds per the trace_event spec. The pid is
    the rank (one track group per rank) and the tid is the
    emitting thread, so prefetcher/watchdog activity lands on its own row.

    The buffer is bounded (``max_events``, default 1M ≈ a few hundred MB
    of dicts): past the cap new records are dropped and counted, and the
    written trace carries a ``telemetry_dropped_events`` metadata record —
    a multi-day run must not grow host RSS without bound, and the JSONL
    sink (streamed, unbounded) remains the full record.
    """

    def __init__(self, path: str, *, process_index: int = 0,
                 max_events: int = 1_000_000,
                 run_meta: Optional[dict] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._max_events = max_events
        self.dropped = 0
        self._events: List[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": process_index,
                "args": {"name": f"tpu_ddp_torch rank {process_index}"},
            }
        ]
        if run_meta:
            # metadata record: Perfetto surfaces it under the track args
            self._events.append({
                "name": "run_meta",
                "ph": "M",
                "pid": process_index,
                "args": dict(run_meta),
            })
        self._closed = False

    def emit(self, event: Event) -> None:
        base = {
            "pid": event.process_index,
            "tid": event.thread_id,
            "ts": event.ts_s * 1e6,
        }
        records: List[dict] = []
        if event.kind == SPAN:
            args = dict(event.attrs)
            if event.step is not None:
                args["step"] = event.step
            records.append({
                **base,
                "name": event.name,
                "cat": "phase",
                "ph": "X",
                "dur": event.dur_s * 1e6,
                "args": args,
            })
        elif event.kind == COUNTERS:
            # one "C" series per scalar; Perfetto renders each as a track
            scalars = dict(event.attrs.get("counters", {}))
            scalars.update(event.attrs.get("gauges", {}))
            for name, value in scalars.items():
                if isinstance(value, (int, float)):
                    records.append({
                        **base,
                        "name": name,
                        "ph": "C",
                        "args": {"value": value},
                    })
        else:  # INSTANT
            records.append({
                **base,
                "name": event.name,
                "cat": "instant",
                "ph": "i",
                "s": "p",  # process-scoped marker
                "args": dict(event.attrs),
            })
        with self._lock:
            if self._closed:
                return
            room = self._max_events - len(self._events)
            if room >= len(records):
                self._events.extend(records)
            else:
                self._events.extend(records[:max(0, room)])
                self.dropped += len(records) - max(0, room)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            events = self._events
            if self.dropped:
                events.append({
                    "name": "telemetry_dropped_events",
                    "ph": "M",
                    "pid": events[0].get("pid", 0),
                    "args": {"dropped": self.dropped,
                             "max_events": self._max_events},
                })
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        os.replace(tmp, self.path)


class TerminalSummarySink(Sink):
    """Per-phase duration table printed at close (host-0 style stdout)."""

    def __init__(self, stream: Optional[TextIO] = None):
        self._stream = stream
        self._lock = threading.Lock()
        self._phases: Dict[str, Histogram] = {}

    def emit(self, event: Event) -> None:
        if event.kind != SPAN:
            return
        with self._lock:
            hist = self._phases.setdefault(event.name, Histogram())
        hist.record(event.dur_s)

    def close(self) -> None:
        with self._lock:
            phases = dict(self._phases)
        if not phases:
            return
        out = self._stream or sys.stdout
        out.write(format_phase_table(phases) + "\n")
        out.flush()


def format_phase_table(phases: Dict[str, Histogram]) -> str:
    """Render {phase: Histogram} as the fixed-width per-phase table used by
    both the terminal sink and the summarizer."""
    header = (
        f"{'phase':<18} {'count':>7} {'total_s':>10} {'mean_ms':>9} "
        f"{'p50_ms':>9} {'p95_ms':>9} {'max_ms':>9}"
    )
    lines = [header, "-" * len(header)]
    for name in sorted(phases, key=lambda n: -phases[n].sum):
        h = phases[name]
        if not h.count:
            continue
        lines.append(
            f"{name:<18} {h.count:>7d} {h.sum:>10.3f} "
            f"{1e3 * (h.mean or 0):>9.2f} "
            f"{1e3 * (h.percentile(50) or 0):>9.2f} "
            f"{1e3 * (h.percentile(95) or 0):>9.2f} "
            f"{1e3 * h.max:>9.2f}"
        )
    return "\n".join(lines)
