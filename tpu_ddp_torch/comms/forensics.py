"""Stuck-collective forensics: name the collective that wedged.

Counterpart of ``tpu_ddp/comms/forensics.py``, record for record. A
watchdog hang (``telemetry/watchdog.py``) says THAT the step stopped; this
module says WHERE. The compressed gradient ring in
``parallel/collectives.py`` calls a hook once a hop
(``set_ring_hop_hook``); :class:`HopMonitor` rides it, keeping a small
per-rank health file current on disk:

    <run_dir>/comms-health-p<i>.json
        {comms_health_schema_version, updated_unix, step, axis_bw,
         in_flight, last_collective, ...}

``in_flight`` is written BEFORE any chaos fault hook runs, so when a hang
fires mid-collective the file already names the suspect. On a hang,
:func:`write_hang_bundle` joins that health file with the stack dump and
the heartbeat's last step into ``<run_dir>/hang-forensics-p<i>.json``
carrying ``suspect_collective``, which the goodput ledger's notes pick up
through :func:`suspect_from_files`, and which :func:`match_program_order`
checks against a program-order schedule.

The JAX hook is a host callback inside the traced ring, so it fires when
the device reaches the hop. The port's ring calls the hook from the host
as it issues the hop, with a probe read from the received message
(``collectives._hop_probe``): ``on_hop`` reads the probe, which waits for
the card to hold the hop's bytes, so the monitor times hops the card has
finished. On the card that read synchronises the stream once a hop.

:func:`join_schedule` rebuilds the recorded program's collective schedule
through the shared analyze path (``analysis/explain.py``: the step rebuilt
at the recorded config and run once, its collectives in program order);
torch loads there and only there. None when the program cannot be rebuilt,
as in JAX.

Stdlib-only otherwise: the supervisor, ledger and monitor side read these
files without torch.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

COMMS_HEALTH_SCHEMA_VERSION = 1
HANG_FORENSICS_SCHEMA_VERSION = 1

HEALTH_PREFIX = "comms-health"
FORENSICS_PREFIX = "hang-forensics"

#: explicit-ring kinds -> the HLO kind their hops lower to in the JAX
#: package (the program-order vocabulary)
_RING_LOWERS_TO = {
    "ring-all-reduce": "collective-permute",
    "ring-reduce-scatter": "collective-permute",
}

#: ring wire modes -> the dtype token (compression.py payload dtypes)
_MODE_DTYPE = {"f32": "f32", "bf16": "bf16", "int8": "s8"}

#: substrings in a stack dump that put a thread inside the ring path
_RING_FRAMES = ("ring_reduce_scatter", "ring_all_reduce",
                "parallel/collectives.py")


def _atomic_write(path: str, rec: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f, sort_keys=True)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


class HopMonitor:
    """Rides the ring hop hook; keeps ``comms-health-p<i>.json`` fresh.

    ``on_hop`` runs once a hop on each rank, so it is cheap, thread-safe,
    and raises only what the fault hook raises. Bytes land in a sliding
    window per axis; the measured axis bandwidth is window bytes over
    window span divided by ``n_devices`` (per link, not aggregate).
    ``fault_hook`` (the chaos ``comm_stall`` seam) runs AFTER the health
    write, so a stall that never returns still left the suspect on disk."""

    def __init__(self, run_dir: str, *, process_index: int = 0,
                 n_devices: int = 1,
                 fault_hook: Optional[Callable[[str, int], None]] = None,
                 telemetry=None,
                 window_s: float = 2.0,
                 min_write_interval_s: float = 0.2):
        self.run_dir = run_dir
        self.process_index = process_index
        self.n_devices = max(int(n_devices), 1)
        self.fault_hook = fault_hook
        self.telemetry = telemetry
        self.window_s = window_s
        self.min_write_interval_s = min_write_interval_s
        self.path = os.path.join(
            run_dir, f"{HEALTH_PREFIX}-p{process_index}.json")
        self._lock = threading.Lock()
        self._window: Dict[str, List[tuple]] = {}  # axis -> [(t, bytes)]
        self._in_flight: Optional[dict] = None
        self._last_collective: Optional[str] = None
        self._step: Optional[int] = None
        self._last_write = 0.0
        self._hops = 0

    def set_step(self, step: int) -> None:
        self._step = int(step)

    # -- the hook itself (installed through set_ring_hop_hook) ------------

    def on_hop(self, probe, *, kind: str, dtype: str, axis: str,
               hop: int, n_hops: int, wire_bytes: int) -> None:
        """This rank finished one ring hop. ``probe`` is a 0-d tensor read
        from the hop's received message; reading it waits for the hop's
        bytes on the card (module docstring), its value is irrelevant."""
        if probe is not None:
            float(probe)
        now = time.monotonic()
        key = f"{kind}/{dtype}/{axis}"
        with self._lock:
            self._hops += 1
            win = self._window.setdefault(axis, [])
            win.append((now, int(wire_bytes)))
            cutoff = now - self.window_s
            while win and win[0][0] < cutoff:
                win.pop(0)
            flight = {"key": key, "kind": kind, "dtype": dtype,
                      "axis": axis, "hop": int(hop),
                      "n_hops": int(n_hops)}
            if hop >= n_hops:  # final hop: the collective completed
                self._last_collective = key
                self._in_flight = None
                force = self._hops <= self.n_devices  # first completion
            else:
                force = (self._in_flight is None
                         or self._in_flight.get("key") != key)
                self._in_flight = flight
            rec = self._snapshot(now)
        self._write(rec, now, force=force)
        if self.fault_hook is not None:
            # chaos hooks sleep or raise on purpose (fault injection)
            self.fault_hook(axis, int(hop))

    # -- persistence ------------------------------------------------------

    def _snapshot(self, now: float) -> dict:
        axis_bw = {}
        axis_bytes = {}
        span = {}
        for axis, win in self._window.items():
            if not win:
                continue
            total = sum(b for _, b in win)
            dur = max(now - win[0][0], 1e-3)
            axis_bytes[axis] = total
            span[axis] = dur
            axis_bw[axis] = total / dur / self.n_devices
        return {
            "comms_health_schema_version": COMMS_HEALTH_SCHEMA_VERSION,
            "updated_unix": time.time(),
            "process_index": self.process_index,
            "n_devices": self.n_devices,
            "step": self._step,
            "hops": self._hops,
            "axis_bw": axis_bw,
            "axis_bytes_window": axis_bytes,
            "window_span_s": span,
            "in_flight": self._in_flight,
            "last_collective": self._last_collective,
        }

    def _write(self, rec: dict, now: float, force: bool = False) -> None:
        if not force and now - self._last_write < self.min_write_interval_s:
            return
        self._last_write = now
        try:
            _atomic_write(self.path, rec)
        except OSError:
            pass  # health files are best-effort; never fail the step

    def close(self) -> None:
        with self._lock:
            rec = self._snapshot(time.monotonic())
        try:
            _atomic_write(self.path, rec)
        except OSError:
            pass


# -- hang-side join --------------------------------------------------------


def read_health(run_dir: str) -> List[dict]:
    """Every rank's comms-health file in ``run_dir``, parsed; empty when
    the run had no hop monitor."""
    out = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return out
    for name in names:
        if name.startswith(f"{HEALTH_PREFIX}-p") and name.endswith(".json"):
            rec = _read_json(os.path.join(run_dir, name))
            if rec is not None:
                out.append(rec)
    return out


def _suspect_of(health: dict) -> Optional[dict]:
    flight = health.get("in_flight")
    if isinstance(flight, dict) and flight.get("key"):
        return {**flight, "source": "in_flight"}
    last = health.get("last_collective")
    if isinstance(last, str) and last:
        parts = last.split("/")
        return {
            "key": last,
            "kind": parts[0] if parts else None,
            "dtype": parts[1] if len(parts) > 2 else None,
            "axis": parts[-1] if len(parts) > 2 else None,
            "source": "last_collective",
        }
    return None


def write_hang_bundle(run_dir: str, *, process_index: int = 0,
                      dump_text: Optional[str] = None) -> dict:
    """Join the comms health files, the heartbeat's last step, the data
    path's suspect stage and the stack dump into
    ``hang-forensics-p<i>.json``. Returns the record (``suspect_collective``
    may be None: an honest "no ring evidence")."""
    from tpu_ddp_torch.datapath.stages import suspect_stage_from_files
    from tpu_ddp_torch.telemetry.watchdog import read_heartbeat

    healths = read_health(run_dir)
    own = [h for h in healths
           if h.get("process_index") == process_index]
    suspect = None
    for h in own + [h for h in healths if h not in own]:
        suspect = _suspect_of(h)
        if suspect is not None:
            break
    hb = read_heartbeat(
        os.path.join(run_dir, f"heartbeat-p{process_index}.json"))
    last_step = hb.get("step") if isinstance(hb, dict) else None
    stack_mentions_ring = bool(
        dump_text and any(s in dump_text for s in _RING_FRAMES))
    rec = {
        "hang_forensics_schema_version": HANG_FORENSICS_SCHEMA_VERSION,
        "process_index": process_index,
        "last_step": last_step,
        "suspect_collective": suspect,
        # the data-path mirror: the loader stage a stall wedged, from the
        # StageMonitor's in-flight marker (None: no staged-loader evidence)
        "suspect_stage": suspect_stage_from_files(run_dir),
        "stack_mentions_ring": stack_mentions_ring,
        "health_files": len(healths),
    }
    try:
        _atomic_write(
            os.path.join(run_dir,
                         f"{FORENSICS_PREFIX}-p{process_index}.json"),
            rec)
    except OSError:
        pass
    return rec


def suspect_from_files(run_dir: str) -> Optional[dict]:
    """The hang's suspect collective from whatever the dead run left
    behind: a hang-forensics bundle first, the raw health files as
    fallback."""
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return None
    for name in names:
        if name.startswith(f"{FORENSICS_PREFIX}-p") \
                and name.endswith(".json"):
            rec = _read_json(os.path.join(run_dir, name))
            if rec and isinstance(rec.get("suspect_collective"), dict):
                return rec["suspect_collective"]
    for health in read_health(run_dir):
        suspect = _suspect_of(health)
        if suspect is not None:
            return suspect
    return None


def match_program_order(suspect: Optional[dict],
                        program_order: List[str]) -> Optional[dict]:
    """Locate the suspect in a linearized collective schedule
    (``kind/dtype/axis/gN`` keys, program order). Explicit ring suspects
    are matched through their lowered kind (collective-permute) and wire
    dtype. Returns ``{"index", "entry"}``, or None when the schedule has
    no such collective: the suspect does NOT belong to that program."""
    if not suspect or not program_order:
        return None
    kind = suspect.get("kind")
    kind = _RING_LOWERS_TO.get(kind, kind)
    dtype = _MODE_DTYPE.get(suspect.get("dtype"), suspect.get("dtype"))
    axis = suspect.get("axis")
    best = None
    for i, entry in enumerate(program_order):
        parts = str(entry).split("/")
        if len(parts) < 4:
            continue
        e_kind, e_dtype, e_axis = parts[0], parts[1], parts[2]
        if e_kind != kind:
            continue
        score = 0
        if dtype and e_dtype == dtype:
            score += 2
        if axis and e_axis == axis:
            score += 1
        if best is None or score > best[0]:
            best = (score, i, entry)
    if best is None:
        return None
    return {"index": best[1], "entry": best[2]}


def join_schedule(run_dir: str, devices=None) -> Optional[List[str]]:
    """The recorded run's program-order collective schedule, rebuilt
    through the shared analyze path (torch loads here and only here), on
    the device the run recorded (``devices``: None, or that device). None
    when the program cannot be rebuilt here."""
    try:
        from tpu_ddp_torch.analysis.explain import anatomy_for_run_meta, read_run_meta

        meta = read_run_meta(run_dir)
        anatomy = anatomy_for_run_meta(meta, devices)
        return list(anatomy.program_order or [])
    except Exception:
        return None
