"""The Telemetry object: spans + counters wired to pluggable sinks.

Counterpart of ``tpu_ddp/telemetry/core.py``. One ``Telemetry`` instance
per run (the Trainer owns it); the disabled ``NULL`` singleton makes every
call a cheap no-op so instrumented code never branches on "is telemetry
on". Stdlib-only: the launcher and the summarizer import this without
pulling in torch.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional, Sequence

import contextlib

from tpu_ddp_torch.telemetry.events import (
    COUNTERS,
    INSTANT,
    SPAN,
    Clock,
    Event,
    pop_span,
    push_span,
)
from tpu_ddp_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
)


class Telemetry:
    """Event emitter + registry facade.

    Spans also record into the registry histogram ``phase/<name>`` so the
    end-of-run counters snapshot carries the same per-phase distribution
    the sinks saw.
    """

    def __init__(
        self,
        sinks: Sequence = (),
        *,
        registry: Optional[Registry] = None,
        process_index: int = 0,
        enabled: bool = True,
        clock: Optional[Clock] = None,
    ):
        self.enabled = enabled and bool(sinks)
        self.sinks = list(sinks)
        self.registry = registry if registry is not None else default_registry()
        self.process_index = process_index
        self.clock = clock or Clock()
        self.current_step: Optional[int] = None
        self._closed = False
        # whether ``close`` writes ``run_end``: False once ``peer_lost``
        # marks a life that ends because a collective lost its peer
        self._ends_clean = True
        # high-rate window taps (the anomaly profiler's capture manager):
        # each listener sees every span's (name, dur_s) as it closes —
        # how a capture window measures its own per-phase times without
        # re-reading the JSONL it is being written into
        self._span_listeners: list = []

    # -- spans / events ---------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int] = None,
             **attrs) -> Iterator[None]:
        """Time a phase; emits one SPAN event on exit. Nesting is tracked
        per thread and recorded as ``depth`` (Chrome viewers stack slices
        on the same tid by time containment; depth makes nesting explicit
        for the JSONL consumers)."""
        if not self.enabled:
            yield
            return
        depth = push_span()
        t0 = self.clock.now()
        try:
            yield
        finally:
            dur = self.clock.now() - t0
            pop_span()
            self._emit(Event(
                name=name,
                kind=SPAN,
                ts_s=t0,
                dur_s=dur,
                step=self.current_step if step is None else step,
                process_index=self.process_index,
                thread_id=threading.get_ident() & 0xFFFF,
                depth=depth,
                attrs=attrs,
            ))
            self.registry.histogram(f"phase/{name}").record(dur)
            for listener in self._span_listeners:
                try:
                    listener(name, dur)
                except Exception:  # a broken tap must never kill training
                    pass

    def instant(self, name: str, step: Optional[int] = None,
                **attrs) -> None:
        """Point event (e.g. "profiler_trace_written", "watchdog_hang")."""
        if not self.enabled:
            return
        self._emit(Event(
            name=name,
            kind=INSTANT,
            ts_s=self.clock.now(),
            step=self.current_step if step is None else step,
            process_index=self.process_index,
            thread_id=threading.get_ident() & 0xFFFF,
            attrs=attrs,
        ))

    def emit_counters(self, step: Optional[int] = None, *,
                      name: str = "counters") -> None:
        """Snapshot the registry into the sinks (JSONL record + Chrome "C"
        series). Call at natural boundaries (epoch end, run end); the
        Trainer's mid-epoch cadence passes ``name="counters_snapshot"``
        so readers can tell a periodic tail from a clean-shutdown
        snapshot."""
        if not self.enabled:
            return
        snap = self.registry.snapshot()
        self._emit(Event(
            name=name,
            kind=COUNTERS,
            ts_s=self.clock.now(),
            step=self.current_step if step is None else step,
            process_index=self.process_index,
            thread_id=threading.get_ident() & 0xFFFF,
            attrs=snap,
        ))

    def _emit(self, event: Event) -> None:
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception:  # a broken sink must never kill training
                pass

    # -- registry facade --------------------------------------------------

    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> Histogram:
        return self.registry.histogram(name)

    def count(self, name: str, n: float = 1) -> None:
        if self.enabled:
            self.registry.counter(name).inc(n)

    # -- span listeners (capture windows) ---------------------------------

    def add_span_listener(self, listener) -> None:
        """Register a ``(name, dur_s)`` callback fired as each span
        closes — the profiler's capture window taps the live stream for
        its measured-phase record. No-op stream when disabled (spans
        never fire)."""
        self._span_listeners.append(listener)

    def remove_span_listener(self, listener) -> None:
        try:
            self._span_listeners.remove(listener)
        except ValueError:
            pass

    # -- lifecycle --------------------------------------------------------

    def peer_lost(self) -> None:
        """Mark this life as ended by a lost peer: ``close`` then writes
        no ``run_end``, so the ledger books the life ``killed`` (``hang``
        when the watchdog fired). A port rank is one process, so it can
        outlive a rank that died; a JAX life owns every device and never
        does, which is why the JAX ``close`` has no such case."""
        self._ends_clean = False

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.enabled:
            # clean-shutdown marker: the fleet aggregator uses it to tell
            # an ENDED host (trace goes quiet because the run finished)
            # from a LOST one (trace goes quiet because the host died)
            if self._ends_clean:
                self.instant("run_end")
            self.emit_counters()
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass


#: Shared disabled instance: every method is a no-op.
NULL = Telemetry(sinks=(), enabled=False)
