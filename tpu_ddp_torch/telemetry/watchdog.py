"""Hang watchdog: heartbeat files + stall stack dumps.

Counterpart of ``tpu_ddp/telemetry/watchdog.py``. The failure mode this
covers is the silent multi-rank wedge: one rank stops making progress —
stuck in a collective whose peer died, or blocked on a hung device — and
every *other* rank blocks with it, producing a job that burns cards while
emitting nothing. Two mechanisms:

- **Heartbeat file** (``heartbeat-p<process>.json``, atomic replace,
  rate-limited to one write/second): an external supervisor — or a human
  with ``cat`` — can see per-host liveness and the last completed step
  without attaching to the process.
- **In-process deadline**: a daemon thread checks monotonic time since the
  last ``beat()``. When the deadline passes it logs a stack dump of every
  thread (so the wedge site is in the log even if the process is later
  SIGKILLed), emits a ``watchdog_hang`` telemetry instant, and bumps the
  ``watchdog/hangs`` counter. One dump per stall episode — a new beat
  re-arms it — so a long stall doesn't spam the log.

Stdlib-only and torch-free: the watchdog must keep functioning precisely
when the CUDA runtime is the thing that hung. Under a run dir the trainer's
``on_hang`` writes the hang bundle (``comms/forensics.py::write_hang_bundle``)
before any abort.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Optional

log = logging.getLogger(__name__)

#: exit code of a --watchdog-abort escalation. The goodput ledger's
#: ``hang`` classification comes from the trace evidence (the
#: ``watchdog_hang`` instant with no ``run_end``), not this code — but
#: the elastic supervisor logs it, and a distinctive value keeps a
#: watchdog abort distinguishable from a crash in process tables.
HANG_EXIT_CODE = 113


def read_heartbeat(path: str) -> Optional[dict]:
    """Parse one ``heartbeat-p<i>.json`` liveness file; None when the
    file is absent or torn mid-replace (both mean "no signal", and the
    fleet aggregator treats them as such — never as a crash)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def heartbeat_age_seconds(record: Optional[dict],
                          now: Optional[float] = None) -> Optional[float]:
    """Seconds since a heartbeat record's wall-time stamp (the staleness
    input of the lost-host verdict); None without a usable record."""
    if not record or not isinstance(record.get("wall_time"), (int, float)):
        return None
    return (time.time() if now is None else now) - record["wall_time"]


def all_stack_dump() -> str:
    """Formatted stacks of every live thread (the hang forensic record)."""
    lines = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        lines.extend(traceback.format_stack(frame))
    return "".join(
        line if line.endswith("\n") else line + "\n" for line in lines
    )


class HangWatchdog:
    """Deadline monitor over a ``beat()`` heartbeat.

    Parameters
    ----------
    deadline_seconds: stall threshold — no beat for this long fires the
        watchdog. The first deadline window starts at ``start()``.
    heartbeat_dir: where to write ``heartbeat-p<i>.json`` (None disables
        file heartbeats; the in-process deadline still runs).
    process_index: this rank (file naming + records).
    telemetry: optional Telemetry for the ``watchdog_hang`` instant and
        the ``watchdog/hangs`` counter.
    on_hang: optional callback(dump_text) — tests hook this.
    poll_interval: monitor wakeup period (default: deadline/4, min 10ms).
    abort_on_hang: escalate after the dump — ``os._exit(HANG_EXIT_CODE)``
        from the monitor thread, so a wedged runtime becomes a
        RESTARTABLE death (the trace's ``watchdog_hang`` instant with no
        ``run_end`` classifies it ``hang`` in the goodput ledger, and
        the elastic supervisor's hang budget decides the restart)
        instead of an eternal chip-burning stall. Opt-in
        (``--watchdog-abort``): an unsupervised run may prefer the
        wedge forensically intact.
    """

    def __init__(
        self,
        deadline_seconds: float,
        *,
        heartbeat_dir: Optional[str] = None,
        process_index: int = 0,
        telemetry=None,
        on_hang: Optional[Callable[[str], None]] = None,
        poll_interval: Optional[float] = None,
        abort_on_hang: bool = False,
    ):
        if deadline_seconds <= 0:
            raise ValueError("deadline_seconds must be > 0")
        self.deadline_seconds = deadline_seconds
        self.heartbeat_dir = heartbeat_dir
        self.process_index = process_index
        self.telemetry = telemetry
        self.on_hang = on_hang
        self.abort_on_hang = abort_on_hang
        self.poll_interval = poll_interval or max(deadline_seconds / 4, 0.01)
        self.fire_count = 0
        self._last_beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._last_file_write = 0.0
        self._armed = True  # one dump per stall episode
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if heartbeat_dir:
            os.makedirs(heartbeat_dir, exist_ok=True)

    @property
    def heartbeat_path(self) -> Optional[str]:
        if not self.heartbeat_dir:
            return None
        return os.path.join(
            self.heartbeat_dir, f"heartbeat-p{self.process_index}.json"
        )

    @property
    def fired(self) -> bool:
        return self.fire_count > 0

    @property
    def last_step(self) -> Optional[int]:
        return self._last_step

    def seconds_since_beat(self) -> float:
        """Age of the newest ``beat()`` — the freshness the ``/healthz``
        endpoint and the staleness verdicts are computed from."""
        return time.monotonic() - self._last_beat

    def is_stale(self) -> bool:
        """True once the deadline has passed without a beat: the same
        condition that fires the stack dump, exposed as a predicate so
        the monitor exporter's ``/healthz`` flips in lockstep with it."""
        return self.seconds_since_beat() > self.deadline_seconds

    def start(self) -> "HangWatchdog":
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="tpu-ddp-torch-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def beat(self, step: Optional[int] = None) -> None:
        """Mark progress: training completed a step (or another liveness
        boundary). Re-arms the stall dump and refreshes the heartbeat
        file (rate-limited to 1 write/sec, atomic)."""
        self._last_beat = time.monotonic()
        self._last_step = step
        self._armed = True
        self._write_heartbeat()

    def _write_heartbeat(self, force: bool = False) -> None:
        path = self.heartbeat_path
        if path is None:
            return
        now = time.monotonic()
        if not force and now - self._last_file_write < 1.0:
            return
        self._last_file_write = now
        record = {
            "schema_version": 1,
            "wall_time": time.time(),
            "step": self._last_step,
            "pid": os.getpid(),
            "process_index": self.process_index,
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)
        except OSError:  # heartbeat IO must never take down training
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        # final flush past the rate limit: the file must reflect the last
        # completed step, not whichever beat the limiter let through
        self._write_heartbeat(force=True)

    # -- monitor thread ---------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            stalled = time.monotonic() - self._last_beat
            if stalled > self.deadline_seconds and self._armed:
                self._armed = False
                self._fire(stalled)

    def _fire(self, stalled_seconds: float) -> None:
        self.fire_count += 1
        dump = all_stack_dump()
        header = (
            f"tpu_ddp_torch watchdog: no step completed in "
            f"{stalled_seconds:.1f}s (deadline {self.deadline_seconds:.1f}s, "
            f"process {self.process_index}, last step {self._last_step}); "
            f"thread stacks follow\n"
        )
        log.error("%s%s", header, dump)
        if self.heartbeat_dir:
            try:
                hang_path = os.path.join(
                    self.heartbeat_dir, f"hang-p{self.process_index}.log"
                )
                with open(hang_path, "a") as f:
                    f.write(header + dump + "\n")
            except OSError:
                pass
        if self.telemetry is not None:
            self.telemetry.count("watchdog/hangs")
            self.telemetry.instant(
                "watchdog_hang",
                stalled_seconds=round(stalled_seconds, 3),
                last_step=self._last_step,
            )
        if self.on_hang is not None:
            try:
                self.on_hang(header + dump)
            except Exception:
                pass
        if self.abort_on_hang:
            # forensics are durable (JSONL sinks flush per line, the
            # hang log is written above): escalate. os._exit on purpose
            # — the main thread is the thing that is wedged, so a
            # cooperative shutdown would hang exactly like the run did.
            self._write_heartbeat(force=True)
            os.write(
                2,
                b"\ntpu_ddp_torch watchdog: --watchdog-abort escalation - "
                b"aborting the wedged process (exit %d)\n"
                % HANG_EXIT_CODE,
            )
            os._exit(HANG_EXIT_CODE)
