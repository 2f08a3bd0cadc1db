"""Capture manager: anomaly-triggered profiling windows -> bundles.

The port's copy of ``tpu_ddp/profiler/capture.py``: the same arming, the
same bundle layout and ``meta.json`` keys, so either package's ``profile``
reads either's bundles. One :class:`CaptureManager` rides inside each
training process (the trainer owns it whenever ``--telemetry-dir`` gives
it somewhere to write). It sits dormant at zero cost until a window is
**armed**, one of three ways:

- ``--profile-steps A:B``: a config window over global steps;
- ``POST /profile?steps=N`` on the monitor exporter: an operator (or the
  watch process) arms a window on a live run, no restart (loopback-only
  unless ``--monitor-allow-remote-trigger``);
- the ``capture_profile`` alert action: a STR001/THR001/DWT001 firing
  edge in the watch-side alert engine POSTs the trigger, rate-limited by
  ``MonitorConfig.max_auto_profiles``.

While a window is open the manager runs three capture sources: the host
stack sampler (``profiler/host.py``), a ``torch.profiler`` session
(``profiler/device.py``; CUDA activity on the card; a session already
running, the ``--profile-dir`` epoch's, degrades it to a note), and a
telemetry span listener that records the window's measured per-phase
times. When the window closes it writes a schema-versioned **bundle** to
``<run_dir>/profiles/step_<start>-p<i>/``::

    meta.json            # trigger provenance, window, measured phases,
                         # run metadata, sources manifest
    host_stacks.folded   # flamegraph-compatible folded stacks
    host_top.json        # self-time top-frames table
    device/trace.json    # the torch.profiler Chrome trace (when armed)

and bumps the ``profiler/captures_total`` / ``profiler/capture_seconds``
telemetry counters. ``tpu-ddp-torch profile`` (``profiler/report.py``)
renders bundles back.

Module-level stdlib-only (torch is imported lazily inside the device
source), so the monitor/watch side imports the trigger helper and the
bundle readers without torch.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: bump on any breaking change to the bundle meta.json shape
PROFILE_SCHEMA_VERSION = 1

#: subdirectory of the run dir that holds capture bundles
PROFILES_DIRNAME = "profiles"


def parse_profile_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"A:B"`` -> ``(A, B)`` (a window over global steps: the capture
    opens once step A completes and closes at step B). None for
    None/empty. Raises ValueError on malformed specs — ``TrainConfig.
    validate()`` calls this so a typo fails at parse time, not at step A.
    """
    if not spec:
        return None
    m = re.fullmatch(r"\s*(\d+)\s*:\s*(\d+)\s*", str(spec))
    if not m:
        raise ValueError(
            f"profile_steps must look like 'A:B' (global steps, A < B), "
            f"got {spec!r}"
        )
    a, b = int(m.group(1)), int(m.group(2))
    if a >= b:
        raise ValueError(
            f"profile_steps window is empty: start {a} >= end {b}"
        )
    return a, b


class CaptureManager:
    """Arm/run/write one profiling window at a time for this process.

    Thread-safety: ``request()`` arrives on the exporter's HTTP handler
    threads while ``on_step()`` runs on the train loop — the armed/active
    transitions hold ``_lock``. The actual capture work (sampler start,
    bundle write) happens on the train-loop thread only.
    """

    def __init__(
        self,
        run_dir: str,
        *,
        process_index: int = 0,
        window_steps: int = 8,
        host_hz: float = 97.0,
        telemetry=None,
        run_meta: Optional[dict] = None,
        max_captures: int = 16,
        device_trace: bool = True,
        cuda: bool = False,
    ):
        if window_steps < 1:
            raise ValueError(
                f"window_steps must be >= 1, got {window_steps}")
        self.run_dir = run_dir
        self.profiles_dir = os.path.join(run_dir, PROFILES_DIRNAME)
        self.process_index = process_index
        self.window_steps = int(window_steps)
        self.host_hz = float(host_hz)
        self.telemetry = telemetry
        self.run_meta = run_meta or {}
        self.max_captures = int(max_captures)
        self.device_trace = bool(device_trace)
        self.cuda = bool(cuda)              # CUDA activity in the trace
        self.completed = 0
        self._lock = threading.Lock()
        self._armed: Optional[dict] = None
        self._active: Optional[dict] = None
        self._last_step: Optional[int] = None

    # -- arming (three sources) -------------------------------------------

    def arm_window(self, start: int, end: int) -> None:
        """The ``--profile-steps A:B`` config source: capture the steps
        in (A, B] — opens once step A completes (or immediately for a
        window already underway, e.g. after a mid-window resume)."""
        with self._lock:
            self._armed = {
                "source": "config", "rule": None, "host": None,
                "start": int(start), "steps": int(end) - int(start),
                "requested_steps": int(end) - int(start),
            }

    def request(self, *, steps: Optional[int] = None, source: str = "http",
                rule: Optional[str] = None,
                host: Optional[int] = None) -> bool:
        """Arm a window starting at the next completed step (the
        ``POST /profile`` and alert-action source). Returns False —
        never raises — when refused: a window is already armed or open,
        or this run hit ``max_captures``."""
        steps = int(steps) if steps else self.window_steps
        if steps < 1:
            return False
        with self._lock:
            if self._armed is not None or self._active is not None:
                return False
            if self.completed >= self.max_captures:
                return False
            self._armed = {
                "source": source, "rule": rule, "host": host,
                "start": None, "steps": steps, "requested_steps": steps,
            }
        return True

    # -- window lifecycle (train-loop thread) -----------------------------

    def on_step(self, step: int) -> None:
        """Called after every completed optimizer step (after a fused
        group, with the group's last global step). Opens an armed window
        when its start step arrives and closes the active one when the
        window is over. Window boundaries snap to dispatch boundaries
        under ``--steps-per-call`` fusion."""
        finish = start = None
        with self._lock:
            self._last_step = step
            if (self._active is not None
                    and step >= self._active["end_step"]):
                finish, self._active = self._active, None
            if (finish is None and self._active is None
                    and self._armed is not None):
                armed_start = self._armed.get("start")
                if armed_start is None or step >= armed_start:
                    start, self._armed = self._armed, None
                    # the active slot is CLAIMED under the lock — a
                    # concurrent request() must see it and refuse, even
                    # while the sampler below is still spinning up
                    start = dict(start)
                    start["start_step"] = step
                    start["end_step"] = step + start["steps"]
                    start["start_wall"] = time.time()
                    start["t0"] = time.monotonic()
                    start["phases"] = {}
                    self._active = start
        if finish is not None:
            self._finish(finish, step)
        if start is not None:
            self._start(start, step)

    def _start(self, active: dict, step: int) -> None:
        """Spin up the capture sources for a window already claimed in
        ``on_step`` (``active`` IS ``self._active``)."""
        from tpu_ddp_torch.profiler.host import HostSampler

        active["sampler"] = HostSampler(hz=self.host_hz)
        active["sampler"].start()
        active["bundle_dir"] = self._bundle_dir(step)
        # device trace arming is best-effort by contract: a profiler that
        # will not start degrades to a note in the bundle, never an error
        device_note = "device trace disabled"
        if self.device_trace:
            from tpu_ddp_torch.profiler.device import start_device_trace

            device_note = start_device_trace(
                os.path.join(active["bundle_dir"], "device"), cuda=self.cuda)
        active["device_note"] = device_note
        if self.telemetry is not None:
            self.telemetry.add_span_listener(self._on_span)
            self.telemetry.instant(
                "profile_capture_started",
                trigger=active["source"], rule=active.get("rule"),
                steps=active["steps"],
            )
        log.info(
            "profiler: capture window open at step %d (%d step(s), "
            "trigger %s%s)", step, active["steps"], active["source"],
            f":{active['rule']}" if active.get("rule") else "",
        )

    def _on_span(self, name: str, dur_s: float) -> None:
        active = self._active
        if active is None:
            return
        bucket = active["phases"].setdefault(
            name, {"count": 0, "total_s": 0.0})
        bucket["count"] += 1
        bucket["total_s"] += float(dur_s)

    def _finish(self, active: dict, step: int, *,
                note: Optional[str] = None) -> None:
        duration = time.monotonic() - active["t0"]
        sampler = active.get("sampler")
        if sampler is None:
            # close() raced the window's startup: record an empty
            # sampler rather than losing the bundle
            from tpu_ddp_torch.profiler.host import HostSampler

            sampler = HostSampler(hz=self.host_hz)
        else:
            sampler.stop()
        if self.telemetry is not None:
            self.telemetry.remove_span_listener(self._on_span)
        if "device_note" not in active:
            device_note = "device trace not armed (window interrupted)"
        else:
            device_note = active["device_note"]
            if device_note is None:  # trace was successfully armed
                from tpu_ddp_torch.profiler.device import stop_device_trace

                device_note = stop_device_trace()
        self.completed += 1
        path = self._write_bundle(active, step, duration, sampler,
                                  device_note, note)
        if self.telemetry is not None:
            self.telemetry.count("profiler/captures_total")
            self.telemetry.count("profiler/capture_seconds", duration)
            self.telemetry.instant(
                "profile_capture_written", path=path,
                steps=step - active["start_step"],
                duration_s=round(duration, 3),
            )
        log.info("profiler: capture bundle -> %s", path)

    def _bundle_dir(self, start_step: int) -> str:
        base = os.path.join(
            self.profiles_dir, f"step_{start_step}-p{self.process_index}")
        path, i = base, 1
        while os.path.exists(path):  # same-step re-capture: never clobber
            path = f"{base}.{i}"
            i += 1
        return path

    def _write_bundle(self, active: dict, step: int, duration: float,
                      sampler, device_note: Optional[str],
                      note: Optional[str]) -> str:
        path = (active.get("bundle_dir")
                or self._bundle_dir(active["start_step"]))
        try:
            os.makedirs(path, exist_ok=True)
            folded = sampler.folded()
            with open(os.path.join(path, "host_stacks.folded"), "w") as f:
                f.write(folded)
            with open(os.path.join(path, "host_top.json"), "w") as f:
                json.dump(sampler.top_frames(), f, indent=1)
            steps_covered = step - active["start_step"]
            meta = {
                "schema_version": PROFILE_SCHEMA_VERSION,
                "process_index": self.process_index,
                "trigger": {
                    "source": active["source"],
                    "rule": active.get("rule"),
                    "host": active.get("host"),
                    "requested_steps": active.get("requested_steps"),
                },
                "window": {
                    "start_step": active["start_step"],
                    "end_step": step,
                    "steps": steps_covered,
                    "start_wall": active["start_wall"],
                    "duration_s": round(duration, 6),
                },
                "measured_phases": active["phases"],
                "sources": {
                    "host": {
                        "file": "host_stacks.folded",
                        "samples": sampler.samples,
                        "hz": self.host_hz,
                    },
                    "device": ({"note": device_note} if device_note
                               else {"trace_dir": "device"}),
                },
                "run_meta": self.run_meta,
            }
            if note:
                meta["note"] = note
            tmp = os.path.join(path, f"meta.json.tmp.{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)
            os.replace(tmp, os.path.join(path, "meta.json"))
        except OSError:  # a full disk must not take down training
            log.exception("profiler: failed to write capture bundle")
        return path

    def close(self) -> None:
        """End-of-run: a window still open (the run drained or finished
        mid-window) is closed and written — a truncated capture of a
        preempted run is exactly when the evidence matters most. The
        end step is the last ``on_step`` value (NOT a span count, which
        would undercount by steps_per_call under scan fusion)."""
        with self._lock:
            active, self._active = self._active, None
            self._armed = None
            last_step = self._last_step
        if active is not None:
            end = max(active["start_step"],
                      last_step if last_step is not None
                      else active["start_step"])
            self._finish(active, end,
                         note="run ended mid-window; capture truncated")


# -- trigger + bundle discovery (watch/report side, stdlib-only) ----------

def _is_loopback(ip: str) -> bool:
    """The POST /profile origin gate: only loopback peers may arm a
    capture unless ``--monitor-allow-remote-trigger`` opted in."""
    return (ip.startswith("127.") or ip == "::1"
            or ip.startswith("::ffff:127."))


def post_profile_trigger(run_dir: str, *, host: Optional[int] = None,
                         steps: Optional[int] = None,
                         rule: Optional[str] = None,
                         timeout: float = 3.0) -> bool:
    """The default ``capture_profile`` alert action: discover the run's
    exporter endpoints (``exporter-p<i>.json``) and POST ``/profile`` —
    to the implicated host for host-scoped alerts, to every host for
    fleet-scoped ones. Best-effort: returns True when at least one host
    armed a capture."""
    import urllib.parse
    import urllib.request

    endpoints: Dict[int, dict] = {}
    for path in sorted(glob.glob(
            os.path.join(run_dir, "exporter-p*.json"))):
        m = re.search(r"-p(\d+)\.", os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                endpoints[int(m.group(1))] = json.load(f)
        except (OSError, ValueError):
            continue
    if host is not None:
        endpoints = {h: e for h, e in endpoints.items() if h == host}
    armed = False
    for h, endpoint in sorted(endpoints.items()):
        port = endpoint.get("port")
        if not port:
            continue
        params = {"source": "alert"}
        if steps:
            params["steps"] = str(int(steps))
        if rule:
            params["rule"] = rule
        if host is not None:
            params["host"] = str(host)
        query = urllib.parse.urlencode(params)
        # loopback first: a watcher co-located with the trainer (the
        # common case, and the only one the exporter's default origin
        # gate accepts) must not depend on the recorded hostname
        # resolving. The recorded URL is the remote-host fallback —
        # it only arms when the run opted into
        # --monitor-allow-remote-trigger, which is exactly its contract.
        bases = [f"http://127.0.0.1:{port}"]
        recorded = endpoint.get("url")
        if recorded and recorded not in bases:
            bases.append(recorded)
        for base in bases:
            try:
                req = urllib.request.Request(
                    f"{base}/profile?{query}", data=b"", method="POST")
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    if resp.status == 200:
                        armed = True
                        break
            except Exception:  # refused/unreachable: try the next base
                log.debug("profile trigger POST to host %d via %s "
                          "failed", h, base, exc_info=True)
        else:
            log.warning("profile trigger POST to host %d failed on "
                        "every endpoint", h)
    return armed


def list_bundles(run_dir: str) -> List[dict]:
    """Capture-bundle inventory of a run dir, oldest first: one summary
    dict per readable bundle (path, window, trigger provenance). The
    ``watch --once --json`` report embeds this; ``tpu-ddp-torch profile``
    renders the bundles themselves."""
    out: List[dict] = []
    pattern = os.path.join(run_dir, PROFILES_DIRNAME, "*", "meta.json")
    for meta_path in sorted(glob.glob(pattern)):
        meta = read_bundle_meta(os.path.dirname(meta_path))
        if meta is None:
            continue
        window = meta.get("window") or {}
        trigger = meta.get("trigger") or {}
        out.append({
            "path": os.path.dirname(meta_path),
            "process_index": meta.get("process_index"),
            "start_step": window.get("start_step"),
            "end_step": window.get("end_step"),
            "duration_s": window.get("duration_s"),
            "trigger": trigger.get("source"),
            "rule": trigger.get("rule"),
            "start_wall": window.get("start_wall"),
        })
    out.sort(key=lambda b: (b.get("start_wall") or 0, b["path"]))
    return out


def read_bundle_meta(bundle_dir: str) -> Optional[dict]:
    """Parse one bundle's ``meta.json``; None when absent/torn, raises
    on a future schema (same contract as every reader in-tree)."""
    try:
        with open(os.path.join(bundle_dir, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    version = meta.get("schema_version", 0)
    if version > PROFILE_SCHEMA_VERSION:
        raise ValueError(
            f"{bundle_dir}: profile schema_version {version} is newer "
            f"than this tool understands ({PROFILE_SCHEMA_VERSION})"
        )
    return meta
