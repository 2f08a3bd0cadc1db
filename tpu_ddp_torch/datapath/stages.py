"""Staged input-pipeline attribution: the stage vocabulary and the live
per-rank ``data-health-p<i>.json`` writer.

Counterpart of ``tpu_ddp/datapath/stages.py`` (``STAGES``,
``StageMonitor`` :67-189, ``suspect_stage_from_files`` :206), record for
record. The loader runs five named host stages a batch and the trainer a
sixth:

==========  =============================================================
stage       what it times
==========  =============================================================
``index``   drawing the next (indices, mask) pair of the epoch's order
``gather``  the gather of images and labels (``native.gather_rows``)
``augment`` the optional ``host_augment`` hook (the trainer augments
            inside the step, ``data/augment.py``, so this is a
            passthrough unless a hook is installed, but it is still a
            named, benchable, chaos-targetable stage)
``collate`` the batch dict and its mask
``shard``   contiguous rows for the host-to-device copy
``h2d``     the host-to-device copy (the trainer's ``h2d`` span)
==========  =============================================================

The loader reports each stage it runs to an optional observer (its
``observer=``), :class:`StageMonitor` here, which keeps a sliding
per-stage throughput window and atomically rewrites
``data-health-p<i>.json`` so the fleet aggregator (and the DAT001
stage-throughput-collapse alert) see live per-stage rates, and so a wedged
stage is named on disk while it is stuck: the in-flight marker is written
at stage entry, before the chaos stall hook runs, as the comms
``HopMonitor`` leaves its suspect collective behind. On the native ring
(the default ``--prefetch-depth 2``) index and gather run in C++ and no
stage is reported, so the file holds no stage, as the JAX trainer's does on
its native ring.

Stdlib-only; safe to call from the staged prefetcher's thread.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_ddp_torch.comms.forensics import _atomic_write

log = logging.getLogger("tpu_ddp_torch.datapath")

#: every stage of the input pipeline, in per-batch order
STAGES: Tuple[str, ...] = ("index", "gather", "augment", "collate", "shard", "h2d")

#: the stages that run on the host inside the loader
HOST_STAGES: Tuple[str, ...] = STAGES[:-1]

#: bump on any breaking change to the data-health record shape
DATA_HEALTH_SCHEMA_VERSION = 1

HEALTH_PREFIX = "data-health"


def data_health_file(run_dir: str, process_index: int = 0) -> str:
    return os.path.join(run_dir, f"{HEALTH_PREFIX}-p{process_index}.json")


class StageMonitor:
    """Per-rank live data-path health: sliding-window per-stage rates, an
    in-flight marker, and a chaos stall seam.

    Implements the loader's observer protocol (``stage_enter`` /
    ``stage_exit``) plus the trainer's ``set_step``/``close``. The health
    file is rewritten atomically and throttled to ``min_write_interval_s``,
    except that entering a *different* stage than last written forces a
    write: a stall anywhere leaves the suspect stage on disk for
    :func:`suspect_stage_from_files`.
    """

    def __init__(
        self,
        run_dir: str,
        *,
        process_index: int = 0,
        stall_hook: Optional[Callable[[str], None]] = None,
        telemetry: Any = None,
        window_s: float = 5.0,
        min_write_interval_s: float = 0.2,
    ) -> None:
        self.path = data_health_file(run_dir, process_index)
        self.process_index = int(process_index)
        self._stall_hook = stall_hook
        self._telemetry = telemetry
        self.window_s = float(window_s)
        self.min_write_interval_s = float(min_write_interval_s)
        self._lock = threading.Lock()
        # stage -> list of (t_end, seconds, nbytes), pruned to window_s
        self._windows: Dict[str, List[Tuple[float, float, int]]] = {s: [] for s in STAGES}
        self._in_flight: Optional[Dict[str, Any]] = None
        self._last_written_stage: Optional[str] = None
        self._step: Optional[int] = None
        self._last_write = 0.0
        self._write({}, time.monotonic(), force=True)

    def set_step(self, step: int) -> None:
        with self._lock:
            self._step = int(step)

    # -- loader observer protocol ------------------------------------

    def stage_enter(self, stage: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._in_flight = {
                "stage": stage,
                "since_unix": time.time(),
                "step": self._step,
            }
            force = stage != self._last_written_stage
            rec = self._snapshot(now)
        self._write(rec, now, force=force)
        if force:
            self._last_written_stage = stage
        # the stall hook runs AFTER the health write: a fault that sleeps
        # here leaves the wedged stage named on disk while the watchdog
        # counts down
        if self._stall_hook is not None:
            self._stall_hook(stage)

    def stage_exit(self, stage: str, seconds: float, nbytes: int) -> None:
        now = time.monotonic()
        with self._lock:
            win = self._windows.setdefault(stage, [])
            win.append((now, float(seconds), int(nbytes)))
            cutoff = now - self.window_s
            while win and win[0][0] < cutoff:
                win.pop(0)
            if self._in_flight is not None and self._in_flight.get("stage") == stage:
                self._in_flight = None
            rec = self._snapshot(now)
        self._write(rec, now)
        tel = self._telemetry
        if tel is not None and win:
            span = max(now - win[0][0], 1e-9)
            tel.gauge(f"datapath/{stage}_batches_per_s").set(len(win) / span)
            tel.gauge(f"datapath/{stage}_s").set(float(seconds))

    # -- health record ------------------------------------------------

    def _snapshot(self, now: float) -> Dict[str, Any]:
        stages: Dict[str, Any] = {}
        for stage, win in self._windows.items():
            if not win:
                continue
            span = max(now - win[0][0], 1e-9)
            stages[stage] = {
                "batches_window": len(win),
                "bytes_window": int(sum(w[2] for w in win)),
                "busy_s_window": round(sum(w[1] for w in win), 6),
                "window_span_s": round(span, 3),
            }
        return {
            "data_health_schema_version": DATA_HEALTH_SCHEMA_VERSION,
            "updated_unix": time.time(),
            "process_index": self.process_index,
            "step": self._step,
            "stages": stages,
            "in_flight": dict(self._in_flight) if self._in_flight else None,
        }

    def _write(self, rec: Dict[str, Any], now: float, *, force: bool = False) -> None:
        if not force and now - self._last_write < self.min_write_interval_s:
            return
        if not rec:
            rec = self._snapshot(now)
        try:
            _atomic_write(self.path, rec)
            self._last_write = now
        except OSError as e:  # disk trouble must not kill training
            log.debug("data-health write failed: %s", e)

    def close(self) -> None:
        now = time.monotonic()
        with self._lock:
            rec = self._snapshot(now)
        self._write(rec, now, force=True)


# -- readers (forensics / aggregator side; no monitor required) --------


def read_data_health(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def data_health_files(run_dir: str) -> List[str]:
    pat = os.path.join(run_dir, f"{HEALTH_PREFIX}-p*.json")
    rx = re.compile(rf"{HEALTH_PREFIX}-p(\d+)\.json$")
    return sorted(p for p in glob.glob(pat) if rx.search(os.path.basename(p)))


def suspect_stage_from_files(run_dir: str) -> Optional[Dict[str, Any]]:
    """Name the stage most likely wedged, from the on-disk health files.

    Preference order: any rank's in-flight stage (stalls leave it behind:
    :meth:`StageMonitor.stage_enter`), else the slowest recently seen stage
    by busy share. ``None`` when no health files exist (no telemetry run
    dir) or none saw a stage.
    """
    best: Optional[Dict[str, Any]] = None
    for path in data_health_files(run_dir):
        rec = read_data_health(path)
        if rec is None:
            continue
        inf = rec.get("in_flight")
        if isinstance(inf, dict) and inf.get("stage"):
            return {
                "stage": inf["stage"],
                "process_index": rec.get("process_index"),
                "since_unix": inf.get("since_unix"),
                "source": "in_flight",
            }
        stages = rec.get("stages")
        if isinstance(stages, dict):
            for stage, view in stages.items():
                busy = float(view.get("busy_s_window", 0.0) or 0.0)
                if best is None or busy > best["_busy"]:
                    best = {
                        "stage": stage,
                        "process_index": rec.get("process_index"),
                        "since_unix": None,
                        "source": "slowest_window",
                        "_busy": busy,
                    }
    if best is not None:
        best.pop("_busy", None)
    return best
