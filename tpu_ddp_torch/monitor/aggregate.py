"""Fleet aggregator: per-host JSONL tails -> rolling ``FleetSnapshot``.

The port's copy of ``tpu_ddp/monitor/aggregate.py``. One
``FleetAggregator`` watches a run dir the way an operator would, by its
files, with no connection to the training processes:

- ``trace-p<i>.jsonl``: span records (the step phases, checkpoint spans)
  and counters snapshots, per rank, from the telemetry JSONL sink;
- ``health-p<i>.jsonl``: the numerics flight recorder's per-step
  loss/grad-norm stats and anomaly flags;
- ``heartbeat-p<i>.json``: the watchdog's liveness file (wall time + last
  completed step, ``telemetry/watchdog.py``).

A "host" is a process index: in the port one rank is one process, so a
host is a rank. Each ``poll()`` reads only the NEW complete lines of every
file (incremental tailing, torn-line safe) and folds them into per-host
rolling windows, then derives a schema-versioned :class:`FleetSnapshot`:
per-host current step, per-phase p50s, data-wait share, steps/sec,
heartbeat age, the memory gauges, and the two fleet verdicts:
**stragglers** (per-host ``compiled_step``/``data_wait`` p50 more than
``k × MAD`` above the fleet median) and **lost hosts** (stale heartbeat).

``comms_host_view`` and ``datapath_host_view`` read the
``comms-health-p<i>.json`` and ``data-health-p<i>.json`` files that the
comms hop monitor (``comms/forensics.py``, under ``--comms-monitor``) and
the data-path stage monitor (``datapath/stages.py``) write. Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import statistics
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from tpu_ddp_torch.telemetry.watchdog import (
    heartbeat_age_seconds,
    read_heartbeat,
)

#: bump on any breaking change to the FleetSnapshot JSON shape;
#: ``tpu-ddp-torch watch --json`` consumers key on this.
SNAPSHOT_SCHEMA_VERSION = 1

#: step-loop phases the per-host windows retain (the same set the
#: analyze join attributes; data_wait's share is the straggler-visible
#: input-pipeline signal)
LOOP_PHASES = ("data_wait", "h2d", "compiled_step", "device_sync")


@dataclasses.dataclass
class MonitorConfig:
    """Knobs for aggregation and the alert rules (docs/monitoring.md).

    ``straggler_mad_threshold`` is the ``k`` in ``median + k * MAD``:
    a host's phase p50 beyond that deviation from the fleet median is
    flagged (robust statistics, like the health spike detector — one
    straggler cannot drag the threshold the way mean/std would).
    """

    window: int = 256                      # samples retained per host/phase
    straggler_mad_threshold: float = 5.0   # k in median + k*MAD
    straggler_min_hosts: int = 3           # MAD needs a quorum
    straggler_persist_windows: int = 3     # STR001: consecutive flagged polls
    heartbeat_stale_seconds: float = 60.0  # FLT001: lost-host deadline
    steps_per_sec_collapse_frac: float = 0.5  # THR001: vs rolling baseline
    baseline_polls: int = 12               # THR001: rolling-baseline window
    data_wait_share_max: float = 0.5       # DWT001 threshold
    grad_norm_mad_threshold: float = 10.0  # NUM001: k over the norm window
    checkpoint_overdue_seconds: float = 0.0  # CKP001 (0 = rule disabled)
    mem_limit_frac: float = 0.92           # MEM001: a host's measured
                                           # HBM high-water above this
                                           # fraction of the device
                                           # limit fires (0 disables;
                                           # only fires where the
                                           # memory/* gauges exist, so
                                           # the default is safe on
                                           # stats-less backends)
    goodput_min_fraction: float = 0.0      # GDP001: fleet goodput gauge
                                           # below this fires (0 = rule
                                           # disabled — short runs are
                                           # legitimately compile-bound)
    loss_plateau_window: int = 0           # TRN001: recorded loss points
                                           # over which "no meaningful
                                           # improvement" fires (0 =
                                           # rule disabled — a converged
                                           # run legitimately plateaus;
                                           # opt in near the end of a
                                           # warmup or during an overlay
                                           # canary, docs/curves.md)
    loss_plateau_rel_delta: float = 0.01   # TRN001: the loss must have
                                           # improved by at least this
                                           # fraction of its level over
                                           # the window, else plateau
    webhook_url: Optional[str] = None      # alert webhook action target
    max_auto_profiles: int = 3             # capture_profile action: alert-
                                           # armed profiler captures per run
                                           # (edge-triggered; 0 disables)
    comms_baseline: Optional[str] = None   # COM001: path to a `comms
                                           # bench --json` artifact — the
                                           # calibrated per-axis bandwidth
                                           # the live comms-health files
                                           # are judged against (None
                                           # disables the rule; it only
                                           # fires where a run was started
                                           # with --comms-monitor)
    comms_collapse_frac: float = 0.25      # COM001: a host axis's
                                           # staleness-adjusted measured
                                           # bandwidth below this fraction
                                           # of its calibrated baseline
                                           # fires
    data_baseline: Optional[str] = None    # DAT001: path to a `data
                                           # bench --json` artifact — the
                                           # benched per-stage throughput
                                           # the live data-health files
                                           # are judged against (None
                                           # disables the rule; it only
                                           # fires where a run used the
                                           # staged pipeline,
                                           # --prefetch-batches N or
                                           # --prefetch-depth 0)
    data_collapse_frac: float = 0.25       # DAT001: a host stage's
                                           # staleness-adjusted live
                                           # batches/s below this fraction
                                           # of its benched baseline fires
    data_min_stage_s: float = 0.005        # DAT001 materiality floor: a
                                           # stage only alarms when its
                                           # live busy cost also exceeds
                                           # this many seconds per batch.
                                           # Micro-stages bench in the
                                           # sub-microsecond range, so
                                           # per-batch observer overhead
                                           # (span write + health
                                           # bookkeeping) alone would
                                           # mimic a ratio collapse there;
                                           # an immaterial stage cannot be
                                           # the input bottleneck. 0
                                           # disables the floor.

    def validate(self) -> "MonitorConfig":
        if self.window < 8:
            raise ValueError(f"window must be >= 8, got {self.window}")
        if self.straggler_mad_threshold <= 0:
            raise ValueError("straggler_mad_threshold must be > 0")
        if self.heartbeat_stale_seconds <= 0:
            raise ValueError("heartbeat_stale_seconds must be > 0")
        if self.straggler_persist_windows < 1:
            raise ValueError("straggler_persist_windows must be >= 1")
        if not 0.0 <= self.goodput_min_fraction < 1.0:
            raise ValueError(
                "goodput_min_fraction must be in [0, 1), got "
                f"{self.goodput_min_fraction}")
        if self.loss_plateau_window != 0 and self.loss_plateau_window < 8:
            raise ValueError(
                "loss_plateau_window must be 0 (disabled) or >= 8 "
                "(the verdict medians two window halves), got "
                f"{self.loss_plateau_window}")
        if self.loss_plateau_rel_delta < 0:
            raise ValueError(
                "loss_plateau_rel_delta must be >= 0, got "
                f"{self.loss_plateau_rel_delta}")
        if not 0.0 <= self.mem_limit_frac <= 1.0:
            raise ValueError(
                f"mem_limit_frac must be in [0, 1] (0 disables), got "
                f"{self.mem_limit_frac}")
        if self.max_auto_profiles < 0:
            raise ValueError(
                f"max_auto_profiles must be >= 0, got "
                f"{self.max_auto_profiles}")
        if not 0.0 < self.comms_collapse_frac <= 1.0:
            raise ValueError(
                f"comms_collapse_frac must be in (0, 1], got "
                f"{self.comms_collapse_frac}")
        if not 0.0 < self.data_collapse_frac <= 1.0:
            raise ValueError(
                f"data_collapse_frac must be in (0, 1], got "
                f"{self.data_collapse_frac}")
        if self.data_min_stage_s < 0:
            raise ValueError(
                f"data_min_stage_s must be >= 0 (0 disables the "
                f"materiality floor), got {self.data_min_stage_s}")
        return self


def _p50(values) -> Optional[float]:
    vals = [v for v in values if isinstance(v, (int, float))]
    return statistics.median(vals) if vals else None


def host_skew(p50_by_host: Dict[int, float]) -> Optional[dict]:
    """Max per-host p50 deviation from the fleet median — the one-line
    multihost skew summary ``trace summarize`` / ``tpu-ddp-torch health``
    print, and the building block of the straggler verdict. None with
    fewer than two reporting hosts."""
    vals = {h: v for h, v in p50_by_host.items()
            if isinstance(v, (int, float))}
    if len(vals) < 2:
        return None
    med = statistics.median(vals.values())
    worst = max(vals, key=lambda h: abs(vals[h] - med))
    return {
        "median": med,
        "max_delta": abs(vals[worst] - med),
        "host": worst,
        "value": vals[worst],
    }


def flag_stragglers(p50_by_host: Dict[int, float], *, k: float,
                    min_hosts: int = 3) -> List[int]:
    """Hosts whose p50 sits more than ``k × MAD`` ABOVE the fleet median
    (slow only: a host faster than the fleet is not a problem). The MAD
    is floored at a small fraction of the median so a perfectly uniform
    fleet (MAD ~ 0) doesn't flag ordinary jitter."""
    vals = {h: v for h, v in p50_by_host.items()
            if isinstance(v, (int, float))}
    if len(vals) < min_hosts:
        return []
    med = statistics.median(vals.values())
    mad = statistics.median(abs(v - med) for v in vals.values())
    floor = max(1e-3 * abs(med), 1e-9)
    cut = med + k * max(mad, floor)
    return sorted(h for h, v in vals.items() if v > cut)


class _JsonlTail:
    """Incremental reader of one growing JSONL file: each ``poll()``
    returns only the complete NEW records since the last poll. A torn
    trailing line (crash mid-write) stays buffered until its newline
    lands; a truncated/rewritten file restarts from zero."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._buf = ""

    def poll(self) -> List[dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._offset:  # file rewritten (new run in same dir)
            self._offset, self._buf = 0, ""
        if size == self._offset:
            return []
        with open(self.path) as f:
            f.seek(self._offset)
            chunk = f.read()
            self._offset = f.tell()
        lines = (self._buf + chunk).split("\n")
        self._buf = lines.pop()  # incomplete (or empty) tail
        records = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
        return records


@dataclasses.dataclass
class HostSnapshot:
    """One host's point-in-time view inside a :class:`FleetSnapshot`."""

    host: int
    step: Optional[int] = None
    steps_per_sec: Optional[float] = None
    phase_p50_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    data_wait_share: Optional[float] = None
    heartbeat_age_s: Optional[float] = None
    last_event_age_s: Optional[float] = None
    straggler: bool = False
    straggler_phases: List[str] = dataclasses.field(default_factory=list)
    lost: bool = False
    ended: bool = False   # clean shutdown (run_end marker): never "lost"
    health: Dict[str, object] = dataclasses.field(default_factory=dict)
    memory: Dict[str, object] = dataclasses.field(default_factory=dict)
    comms: Dict[str, object] = dataclasses.field(default_factory=dict)
    datapath: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetSnapshot:
    """Rolling cross-host aggregate; ``to_json()`` is the wire shape
    ``tpu-ddp-torch watch --json`` emits and the alert engine consumes."""

    wall_time: float
    run_dir: str
    run_id: Optional[str] = None
    strategy: Optional[str] = None
    mesh: Optional[dict] = None
    process_count: Optional[int] = None
    hosts: List[HostSnapshot] = dataclasses.field(default_factory=list)
    fleet: Dict[str, object] = dataclasses.field(default_factory=dict)
    stragglers: List[int] = dataclasses.field(default_factory=list)
    lost: List[int] = dataclasses.field(default_factory=list)
    loss_series: List[Optional[float]] = dataclasses.field(
        default_factory=list)

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["schema_version"] = SNAPSHOT_SCHEMA_VERSION
        return out


class _HostState:
    """Rolling per-host accumulation the tails feed."""

    def __init__(self, host: int, window: int):
        self.host = host
        self.epoch_unix: Optional[float] = None
        self.run_meta: Optional[dict] = None
        self.phases: Dict[str, deque] = {
            p: deque(maxlen=window) for p in LOOP_PHASES
        }
        # compiled_step durations UN-normalized (one raw entry per span):
        # the data-wait share is a wall-time ratio, so under scan fusion
        # it must weigh the whole K-step span, not the per-step p50 input
        self.compiled_raw: deque = deque(maxlen=window)
        # (span_end_ts_s, steps_in_span) for the steps/sec window
        self.step_rate: deque = deque(maxlen=window)
        self.ended = False  # saw the clean-shutdown run_end marker
        self.last_step: Optional[int] = None
        self.last_event_ts: Optional[float] = None
        self.gauges: Dict[str, float] = {}
        self.losses: deque = deque(maxlen=window)
        self.grad_norms: deque = deque(maxlen=window)
        self.nonfinite_steps = 0
        self.loss_spikes = 0
        self.last_anomaly: Optional[dict] = None
        self.last_checkpoint_wall: Optional[float] = None
        self.last_checkpoint_step: Optional[int] = None

    # -- ingestion --------------------------------------------------------

    def ingest_trace(self, rec: dict) -> None:
        kind = rec.get("type")
        ts = rec.get("ts_s")
        if isinstance(ts, (int, float)):
            end = ts + (rec.get("dur_s") or 0.0)
            if self.last_event_ts is None or end > self.last_event_ts:
                self.last_event_ts = end
        step = rec.get("step")
        if isinstance(step, int) and (self.last_step is None
                                      or step > self.last_step):
            self.last_step = step
        if kind == "header":
            if isinstance(rec.get("epoch_unix"), (int, float)):
                self.epoch_unix = rec["epoch_unix"]
            if rec.get("run_meta"):
                self.run_meta = rec["run_meta"]
            return
        if kind == "span":
            name, dur = rec.get("name"), rec.get("dur_s")
            if not isinstance(dur, (int, float)):
                return
            attrs = rec.get("attrs") or {}
            if name == "compiled_step":
                # scan-fused spans carry a ``steps`` attr: one span
                # covers K optimizer steps — normalize to per-step
                steps = max(int(attrs.get("steps", 1) or 1), 1)
                self.phases[name].append(dur / steps)
                self.compiled_raw.append(dur)
                if isinstance(ts, (int, float)):
                    self.step_rate.append((ts + dur, steps))
            elif name in self.phases:
                self.phases[name].append(dur)
            elif name == "checkpoint" and self.epoch_unix is not None:
                if isinstance(ts, (int, float)):
                    self.last_checkpoint_wall = self.epoch_unix + ts
                if isinstance(step, int):
                    self.last_checkpoint_step = step
            return
        if kind == "instant" and rec.get("name") == "run_end":
            self.ended = True
            return
        if kind == "counters":
            attrs = rec.get("attrs") or {}
            gauges = attrs.get("gauges")
            if isinstance(gauges, dict):
                self.gauges.update(
                    {k: v for k, v in gauges.items()
                     if isinstance(v, (int, float))}
                )

    def ingest_health(self, rec: dict) -> None:
        if rec.get("type") != "health":
            return
        loss, gn = rec.get("loss"), rec.get("grad_norm")
        self.losses.append(
            loss if isinstance(loss, (int, float)) else None)
        if isinstance(gn, (int, float)):
            self.grad_norms.append(gn)
        if rec.get("all_finite") is False:
            self.nonfinite_steps += 1
        anomaly = rec.get("anomaly")
        if anomaly:
            if anomaly == "loss_spike":
                self.loss_spikes += 1
            self.last_anomaly = {"step": rec.get("step"), "reason": anomaly}

    # -- derivation -------------------------------------------------------

    def steps_per_sec(self) -> Optional[float]:
        if len(self.step_rate) >= 2:
            first_end, _ = self.step_rate[0]
            last_end, _ = self.step_rate[-1]
            span = last_end - first_end
            if span > 0:
                # the first entry opens the interval; its steps predate it
                steps = sum(n for _, n in list(self.step_rate)[1:])
                return steps / span
        # fallback: the trainer's own epoch-boundary gauge from the last
        # counters snapshot (coarser, but survives sparse tracing)
        v = self.gauges.get("train/steps_per_sec")
        return float(v) if isinstance(v, (int, float)) else None

    def data_wait_share(self) -> Optional[float]:
        # wall-time ratio over the windowed loop: RAW compiled spans
        # (the per-step-normalized entries would understate compute by
        # steps_per_call and inflate the share on fused runs)
        total = sum(self.compiled_raw) + sum(
            sum(self.phases[p]) for p in LOOP_PHASES
            if p != "compiled_step"
        )
        if total <= 0:
            return None
        return sum(self.phases["data_wait"]) / total

    def grad_norm_spike(self, k: float) -> bool:
        vals = list(self.grad_norms)
        if len(vals) < 8:
            return False
        last, window = vals[-1], vals[:-1]
        med = statistics.median(window)
        mad = statistics.median(abs(v - med) for v in window)
        floor = max(1e-3 * abs(med), 1e-9)
        return last > med + k * max(mad, floor)


def _heartbeat_files(run_dir: str) -> Dict[int, str]:
    return _per_host(run_dir, "heartbeat-p*.json")


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def comms_host_view(rec: Optional[dict],
                    now: float) -> Dict[str, object]:
    """One host's ``comms-health-p<i>.json`` record (the hop monitor's
    live file, docs/comms.md) folded for the snapshot. The per-axis
    measured bandwidth is STALENESS-ADJUSTED while a collective is in
    flight: a wedged ring stops landing hops, so the last written
    bandwidth would stay flattering forever — charging the silent
    seconds since the last write to the open measurement window makes
    the figure decay toward zero while the hang persists, which is
    exactly the COM001 signal."""
    if not isinstance(rec, dict):
        return {}
    upd = rec.get("updated_unix")
    age = (max(now - upd, 0.0)
           if isinstance(upd, (int, float)) else None)
    n_dev = rec.get("n_devices")
    n_dev = int(n_dev) if isinstance(n_dev, int) and n_dev >= 1 else 1
    in_flight = rec.get("in_flight")
    bytes_win = rec.get("axis_bytes_window") or {}
    span = rec.get("window_span_s") or {}
    axis_bw: Dict[str, float] = {}
    for axis, bw in (rec.get("axis_bw") or {}).items():
        if not isinstance(bw, (int, float)):
            continue
        eff = float(bw)
        b, s = bytes_win.get(axis), span.get(axis)
        if (in_flight and age and isinstance(b, (int, float))
                and isinstance(s, (int, float))):
            eff = float(b) / ((float(s) + age) * n_dev)
        axis_bw[axis] = eff
    return {
        "axis_bw": axis_bw,
        "in_flight": in_flight,
        "last_collective": rec.get("last_collective"),
        "step": rec.get("step"),
        "age_s": age,
    }


def datapath_host_view(rec: Optional[dict],
                       now: float) -> Dict[str, object]:
    """One host's ``data-health-p<i>.json`` record (the StageMonitor's
    live file, docs/data.md) folded for the snapshot. The per-stage
    rate is BUSY-based — batches per second of time the stage actually
    ran — because that is the quantity ``data bench`` baselines: a
    demand-driven loader idles between batches while the device steps,
    so a wall-clock rate would sit far below any benched rate on every
    healthy run. A genuinely slow stage balloons its measured busy
    seconds (the chaos stall seam is inside the measured region) and
    the busy rate collapses — the DAT001 signal; the in-flight marker
    rides along to name a currently-wedged stage."""
    if not isinstance(rec, dict):
        return {}
    upd = rec.get("updated_unix")
    age = (max(now - upd, 0.0)
           if isinstance(upd, (int, float)) else None)
    in_flight = rec.get("in_flight")
    stage_rate: Dict[str, float] = {}
    for stage, win in (rec.get("stages") or {}).items():
        if not isinstance(win, dict):
            continue
        batches = win.get("batches_window")
        busy = win.get("busy_s_window")
        if not isinstance(batches, (int, float)) or not isinstance(
                busy, (int, float)):
            continue
        stage_rate[stage] = float(batches) / max(float(busy), 1e-9)
    if not stage_rate and not in_flight:
        return {}
    return {
        "stage_batches_per_s": stage_rate,
        "in_flight": in_flight,
        "step": rec.get("step"),
        "age_s": age,
    }


def _per_host(run_dir: str, pattern: str) -> Dict[int, str]:
    """{process_index: path} for a per-host file family in a run dir.

    Incarnation-stamped trace names (``trace-p0.i2.jsonl`` — a resumed
    run's next life; see docs/goodput.md) resolve to the NEWEST
    incarnation per host: the live monitor watches the life that is
    actually running, while `tpu-ddp-torch goodput` stitches all of them."""
    best: Dict[int, tuple] = {}
    for path in sorted(glob.glob(os.path.join(run_dir, pattern))):
        m = re.search(r"-p(\d+)(?:\.i(\d+))?\.", os.path.basename(path))
        if not m:
            continue
        pid, inc = int(m.group(1)), int(m.group(2) or 0)
        if pid not in best or inc > best[pid][0]:
            best[pid] = (inc, path)
    return {pid: path for pid, (_, path) in best.items()}


class FleetAggregator:
    """Tails one run dir's per-host files; ``poll()`` -> FleetSnapshot."""

    def __init__(self, run_dir: str,
                 config: Optional[MonitorConfig] = None):
        if not os.path.isdir(run_dir):
            raise FileNotFoundError(f"no run dir at {run_dir!r}")
        self.run_dir = run_dir
        self.config = (config or MonitorConfig()).validate()
        self._hosts: Dict[int, _HostState] = {}
        self._tails: Dict[Tuple[str, int], _JsonlTail] = {}

    def _host(self, pid: int) -> _HostState:
        if pid not in self._hosts:
            self._hosts[pid] = _HostState(pid, self.config.window)
        return self._hosts[pid]

    def _drain(self) -> None:
        for family, ingest in (
            ("trace-p*.jsonl", _HostState.ingest_trace),
            ("health-p*.jsonl", _HostState.ingest_health),
        ):
            for pid, path in _per_host(self.run_dir, family).items():
                state = self._host(pid)
                tail = self._tails.get((family, pid))
                if tail is None:
                    tail = self._tails[(family, pid)] = _JsonlTail(path)
                elif tail.path != path:
                    # a NEW incarnation appeared mid-watch (the run was
                    # resumed): drain the dead life's unread trailing
                    # records first (its drain instants / final counters
                    # would otherwise be lost), then follow the live
                    # file from its start with the previous life's
                    # clean-shutdown latch cleared
                    for rec in tail.poll():
                        ingest(state, rec)
                    tail = self._tails[(family, pid)] = _JsonlTail(path)
                    state.ended = False
                for rec in tail.poll():
                    ingest(state, rec)

    def poll(self, now: Optional[float] = None) -> FleetSnapshot:
        """Fold the files' new records in and derive a snapshot.
        ``now`` (unix seconds) is injectable for tests — heartbeat and
        last-event ages are measured against it."""
        now = time.time() if now is None else now
        self._drain()
        heartbeats = {}
        for pid, path in _heartbeat_files(self.run_dir).items():
            rec = read_heartbeat(path)
            if rec:
                heartbeats[pid] = rec
                self._host(pid)  # a heartbeat alone makes the host exist
        comms_views: Dict[int, Dict[str, object]] = {}
        for pid, path in _per_host(
                self.run_dir, "comms-health-p*.json").items():
            view = comms_host_view(_read_json(path), now)
            if view:
                comms_views[pid] = view
                self._host(pid)  # so is a comms-health file
        datapath_views: Dict[int, Dict[str, object]] = {}
        for pid, path in _per_host(
                self.run_dir, "data-health-p*.json").items():
            view = datapath_host_view(_read_json(path), now)
            if view:
                datapath_views[pid] = view
                self._host(pid)  # and a data-health file

        cfg = self.config
        hosts: List[HostSnapshot] = []
        for pid in sorted(self._hosts):
            st = self._hosts[pid]
            hb_age = heartbeat_age_seconds(heartbeats.get(pid), now=now)
            event_age = (
                now - (st.epoch_unix + st.last_event_ts)
                if st.epoch_unix is not None and st.last_event_ts is not None
                else None
            )
            hb = heartbeats.get(pid)
            step = st.last_step
            if hb and isinstance(hb.get("step"), int):
                step = max(step or 0, hb["step"])
            # liveness: the heartbeat is authoritative when present; a
            # heartbeat-less run falls back to trace-tail activity. A
            # host that recorded the clean-shutdown run_end marker ENDED
            # — staleness afterwards is expected, not a loss
            staleness = hb_age if hb_age is not None else event_age
            hosts.append(HostSnapshot(
                host=pid,
                step=step,
                steps_per_sec=st.steps_per_sec(),
                phase_p50_s={
                    p: p50 for p in LOOP_PHASES
                    if (p50 := _p50(st.phases[p])) is not None
                },
                data_wait_share=st.data_wait_share(),
                heartbeat_age_s=hb_age,
                last_event_age_s=event_age,
                ended=st.ended,
                lost=(not st.ended
                      and staleness is not None
                      and staleness > cfg.heartbeat_stale_seconds),
                health={
                    "last_loss": next(
                        (v for v in reversed(st.losses) if v is not None),
                        None),
                    "last_grad_norm": (
                        st.grad_norms[-1] if st.grad_norms else None),
                    "nonfinite_steps": st.nonfinite_steps,
                    "loss_spikes": st.loss_spikes,
                    "grad_norm_spike": st.grad_norm_spike(
                        cfg.grad_norm_mad_threshold),
                    "last_anomaly": st.last_anomaly,
                },
                # the live sampler's memory/* gauges as snapshotted into
                # the trace counters records (docs/memory.md) — MEM001's
                # input; absent keys mean the run never sampled (or the
                # backend reports no limit)
                memory={
                    key: st.gauges[gauge]
                    for key, gauge in (
                        ("high_water_bytes", "memory/high_water_bytes"),
                        ("bytes_in_use_max", "memory/bytes_in_use_max"),
                        ("bytes_limit", "memory/bytes_limit_per_device"),
                        ("high_water_frac", "memory/high_water_frac"),
                        ("fragmentation_bytes",
                         "memory/fragmentation_bytes"),
                        ("host_rss_bytes", "memory/host_rss_bytes"),
                    )
                    if isinstance(st.gauges.get(gauge), (int, float))
                },
                # the hop monitor's live per-axis achieved bandwidth
                # (staleness-adjusted, docs/comms.md) — COM001's input;
                # empty unless the run was started with --comms-monitor
                comms=comms_views.get(pid, {}),
                # the StageMonitor's live per-stage loader throughput
                # (staleness-adjusted, docs/data.md) — DAT001's input;
                # empty unless the run used the staged pipeline
                datapath=datapath_views.get(pid, {}),
            ))

        for phase in ("compiled_step", "data_wait"):
            flagged = flag_stragglers(
                {h.host: h.phase_p50_s.get(phase) for h in hosts},
                k=cfg.straggler_mad_threshold,
                min_hosts=cfg.straggler_min_hosts,
            )
            for h in hosts:
                if h.host in flagged:
                    h.straggler = True
                    h.straggler_phases.append(phase)

        meta = next(
            (self._hosts[p].run_meta for p in sorted(self._hosts)
             if self._hosts[p].run_meta),
            None,
        ) or {}
        rates = [h.steps_per_sec for h in hosts
                 if h.steps_per_sec is not None]
        steps = [h.step for h in hosts if h.step is not None]
        ckpt_walls = [
            (st.last_checkpoint_wall, st.last_checkpoint_step)
            for st in self._hosts.values()
            if st.last_checkpoint_wall is not None
        ]
        epochs = [st.epoch_unix for st in self._hosts.values()
                  if st.epoch_unix is not None]
        fleet: Dict[str, object] = {
            "n_hosts": len(hosts),
            # median, not sum: SPMD hosts advance the SAME global steps
            # in lockstep, so summing would inflate the rate by n_hosts
            "steps_per_sec": _p50(rates),
            "step_min": min(steps) if steps else None,
            "step_max": max(steps) if steps else None,
            "run_age_s": now - min(epochs) if epochs else None,
            "phase_p50_s": {
                p: med for p in LOOP_PHASES
                if (med := _p50(
                    [h.phase_p50_s.get(p) for h in hosts])) is not None
            },
            "data_wait_share": _p50(
                [h.data_wait_share for h in hosts]),
            # the trainers' live goodput gauge (productive fraction of
            # this incarnation's wall-clock, docs/goodput.md), median
            # across reporting hosts — the GDP001 input and the watch
            # dashboard's summary figure
            "goodput_fraction": _p50([
                st.gauges.get("goodput/fraction")
                for st in self._hosts.values()
            ]),
            # worst host's HBM high-water fraction: the fleet-level
            # headroom figure the watch dashboard prints (MEM001 fires
            # per host off the same gauge)
            "hbm_high_water_frac": max(
                (h.memory["high_water_frac"] for h in hosts
                 if isinstance(h.memory.get("high_water_frac"),
                               (int, float))),
                default=None),
        }
        if ckpt_walls:
            wall, step_at = max(ckpt_walls, key=lambda t: t[0])
            fleet["checkpoint_age_s"] = now - wall
            fleet["checkpoint_step"] = step_at
        loss_series = next(
            (list(self._hosts[p].losses)[-120:]
             for p in sorted(self._hosts) if self._hosts[p].losses),
            [],
        )
        return FleetSnapshot(
            wall_time=now,
            run_dir=self.run_dir,
            run_id=meta.get("run_id"),
            strategy=meta.get("strategy"),
            mesh=meta.get("mesh"),
            process_count=meta.get("process_count"),
            hosts=hosts,
            fleet=fleet,
            stragglers=sorted(h.host for h in hosts if h.straggler),
            lost=sorted(h.host for h in hosts if h.lost),
            loss_series=loss_series,
        )


def read_fleet_snapshot(run_dir: str,
                        config: Optional[MonitorConfig] = None,
                        now: Optional[float] = None) -> FleetSnapshot:
    """One-shot convenience: aggregate a run dir from scratch (the
    ``watch --once`` path; long-lived watchers keep a FleetAggregator)."""
    return FleetAggregator(run_dir, config).poll(now)
