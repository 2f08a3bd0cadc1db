"""Discover and load every incarnation of a logical run from a run dir.

The port's copy of ``tpu_ddp/ledger/stitch.py``. It still reads the
``jax/compile_seconds`` histogram, so a JAX run dir stitches as it does
there; a port run dir has none, so its compile seconds are 0.

An *incarnation* is one process lifetime of a logical run: the original
launch is incarnation 0, each ``--resume`` after a kill/preemption is the
next index. The telemetry sink stamps the index into its filenames
(``trace-p<i>.i<k>.jsonl``, legacy unstamped names = incarnation 0 — see
``telemetry.trace_file_name``), so stitching is pure file archaeology:
no registry, no sidecar state, and it works on a run dir scp'd off a
dead pod.

Host 0's trace is the timeline authority per incarnation: SPMD hosts
advance the same global steps in lockstep, so one host's span stream is
the run's wall-clock story (the fleet monitor covers per-host skew; the
ledger covers the run's lifetime). Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional

from tpu_ddp_torch.telemetry import parse_trace_name
from tpu_ddp_torch.telemetry.summarize import read_records
from tpu_ddp_torch.telemetry.watchdog import read_heartbeat

#: span name -> raw ledger bucket. ``step`` is the productive pool the
#: taxonomy later splits into productive / compile / replayed; every
#: depth-0 span not named here lands in host_overhead (attributed host
#: work is still host work).
SPAN_BUCKETS = {
    "data_wait": "data_wait",
    "h2d": "host_overhead",
    "epoch_metrics_fetch": "host_overhead",
    "compiled_step": "step",
    "device_sync": "step",
    "checkpoint": "checkpoint_save",
    "checkpoint_wait": "checkpoint_save",
    "checkpoint_restore": "checkpoint_restore",
    "eval": "eval",
}

#: drain/exit evidence instants -> exit classification (checked in
#: order; ``run_end`` alone means a clean finish, its absence a kill).
#: ``oom_abort`` (the Trainer's allocation-failure forensics,
#: docs/memory.md) wins REGARDLESS of run_end: the re-raise path
#: usually still flushes the sinks, but a runtime hard-killed mid-OOM
#: must classify as oom too.
_EXIT_INSTANTS = (
    ("preempt_drain", "preempted"),
    ("health_halt_drain", "health_halt"),
    ("oom_abort", "oom"),
)


@dataclasses.dataclass
class IncarnationRecord:
    """One process lifetime, reduced to what the taxonomy needs."""

    index: int
    files: Dict[int, str]                  # {process_index: trace path}
    run_meta: Optional[dict] = None
    start_wall: Optional[float] = None     # header epoch_unix (host 0)
    end_wall: Optional[float] = None       # newest evidence, wall clock
    last_span_end_wall: Optional[float] = None
    exit: str = "killed"                   # clean | preempted |
                                           # health_halt | hang | oom |
                                           # killed
    buckets: Dict[str, float] = dataclasses.field(default_factory=dict)
    first_step: Optional[int] = None       # step BEFORE the first
                                           # compiled_step span (= the
                                           # step resumed from)
    executed_through: Optional[int] = None  # global step count reached
    steps: int = 0                         # optimizer steps this life ran
    images: float = 0.0                    # train/images counter delta
    compile_seconds: float = 0.0           # jax/compile_seconds delta
    restore_seconds: float = 0.0           # checkpoint_restore span time
    checkpoints: List[dict] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def elapsed_s(self) -> float:
        if self.start_wall is None or self.end_wall is None:
            return 0.0
        return max(0.0, self.end_wall - self.start_wall)


@dataclasses.dataclass
class StitchedRun:
    """All incarnations of one run dir, in incarnation order."""

    run_dir: str
    incarnations: List[IncarnationRecord]
    run_meta: Optional[dict] = None        # incarnation 0's header meta

    @property
    def start_wall(self) -> Optional[float]:
        return self.incarnations[0].start_wall if self.incarnations else None

    @property
    def end_wall(self) -> Optional[float]:
        ends = [i.end_wall for i in self.incarnations
                if i.end_wall is not None]
        return max(ends) if ends else None


def discover_incarnations(run_dir: str) -> List[tuple]:
    """Sorted ``[(incarnation, {pid: path})]`` of the run dir's JSONL
    trace families (legacy unstamped names count as incarnation 0)."""
    by_inc: Dict[int, Dict[int, str]] = {}
    for path in glob.glob(os.path.join(run_dir, "trace-p*.jsonl")):
        parsed = parse_trace_name(os.path.basename(path))
        if parsed is None or parsed[2] != "jsonl":
            continue
        pid, inc, _ = parsed
        by_inc.setdefault(inc, {})[pid] = path
    return [(k, by_inc[k]) for k in sorted(by_inc)]


def _hist_sum(counters_attrs: Optional[dict], name: str) -> float:
    h = ((counters_attrs or {}).get("histograms") or {}).get(name) or {}
    v = h.get("sum")
    return float(v) if isinstance(v, (int, float)) else 0.0


def _counter(counters_attrs: Optional[dict], name: str) -> float:
    v = ((counters_attrs or {}).get("counters") or {}).get(name)
    return float(v) if isinstance(v, (int, float)) else 0.0


def load_incarnation(index: int, files: Dict[int, str]) -> IncarnationRecord:
    """Reduce one incarnation's host-0 trace to an IncarnationRecord."""
    rec = IncarnationRecord(index=index, files=dict(files))
    authority = files.get(0) or files[min(files)]
    if 0 not in files:
        rec.notes.append(
            f"incarnation {index}: no host-0 trace; using host "
            f"{min(files)} as the timeline authority")
    records = read_records([authority])
    epoch_unix: Optional[float] = None
    last_end = 0.0          # newest event end, trace-relative seconds
    last_span_end = 0.0
    saw_run_end = False
    saw_hang = False
    exit_override: Optional[str] = None
    baseline: Optional[dict] = None
    newest_counters: Optional[dict] = None
    for r in records:
        kind = r.get("type")
        ts = r.get("ts_s")
        if kind == "header":
            if isinstance(r.get("epoch_unix"), (int, float)):
                epoch_unix = r["epoch_unix"]
            if r.get("run_meta"):
                rec.run_meta = r["run_meta"]
            continue
        if isinstance(ts, (int, float)):
            last_end = max(last_end, ts + (r.get("dur_s") or 0.0))
        if kind == "span":
            name, dur = r.get("name"), r.get("dur_s")
            if not isinstance(dur, (int, float)) or r.get("depth", 0) != 0:
                continue
            if isinstance(ts, (int, float)):
                last_span_end = max(last_span_end, ts + dur)
            bucket = SPAN_BUCKETS.get(name, "host_overhead")
            rec.buckets[bucket] = rec.buckets.get(bucket, 0.0) + dur
            attrs = r.get("attrs") or {}
            step = r.get("step")
            if name == "compiled_step":
                n = max(int(attrs.get("steps", 1) or 1), 1)
                rec.steps += n
                if isinstance(step, int):
                    if rec.first_step is None or step < rec.first_step:
                        rec.first_step = step
                    through = step + n
                    if (rec.executed_through is None
                            or through > rec.executed_through):
                        rec.executed_through = through
            elif name == "checkpoint" and isinstance(ts, (int, float)):
                rec.checkpoints.append({
                    "step": step if isinstance(step, int) else None,
                    "ts_s": ts,
                    "dur_s": dur,
                })
            elif name == "checkpoint_restore":
                rec.restore_seconds += dur
        elif kind == "instant":
            name = r.get("name")
            if name == "run_end":
                saw_run_end = True
            elif name == "watchdog_hang":
                saw_hang = True
            elif name == "checkpoint_save_failed":
                # a cadence save lost past its retry budget: the run
                # kept going, but its replay window is now wider than
                # the cadence promised — say so where the replay cost
                # is accounted
                attrs = r.get("attrs") or {}
                rec.notes.append(
                    f"incarnation {index}: checkpoint save at step "
                    f"{r.get('step')} FAILED after "
                    f"{attrs.get('attempts', '?')} attempts "
                    f"({str(attrs.get('error', ''))[:80]}) — the replay "
                    "window behind this life is wider than the cadence")
            else:
                for instant, klass in _EXIT_INSTANTS:
                    if name == instant:
                        exit_override = klass
        elif kind == "counters":
            if r.get("name") == "counters_baseline" and baseline is None:
                baseline = r.get("attrs") or {}
            newest_counters = r.get("attrs") or {}
    if epoch_unix is None:
        rec.notes.append(
            f"incarnation {index}: trace has no wall-clock anchor "
            "(pre-header run?) — excluded from the timeline")
        return rec
    rec.start_wall = epoch_unix
    rec.end_wall = epoch_unix + last_end
    rec.last_span_end_wall = epoch_unix + last_span_end
    for ck in rec.checkpoints:
        ck["wall"] = epoch_unix + ck.pop("ts_s")
    # counter deltas against the run-start baseline: the registry is
    # process-global, so an in-process resume (tests) would otherwise
    # charge incarnation k with every previous life's compile seconds
    rec.compile_seconds = max(
        0.0, _hist_sum(newest_counters, "jax/compile_seconds")
        - _hist_sum(baseline, "jax/compile_seconds"))
    rec.images = max(
        0.0, _counter(newest_counters, "train/images")
        - _counter(baseline, "train/images"))
    if exit_override == "oom":
        rec.exit = "oom"  # evidence instant written before the re-raise
    elif saw_run_end:
        rec.exit = exit_override or "clean"
    else:
        rec.exit = "hang" if saw_hang else "killed"
    return rec


def stitch_run(run_dir: str) -> StitchedRun:
    """Stitch a run dir's incarnations into one timeline.

    Raises FileNotFoundError with a pointed message when the dir holds
    no JSONL traces, ValueError when none of them carries the wall-clock
    header the stitch needs (anonymous/hand-rolled traces)."""
    if not os.path.isdir(run_dir):
        raise FileNotFoundError(f"no run dir at {run_dir!r}")
    families = discover_incarnations(run_dir)
    if not families:
        raise FileNotFoundError(
            f"no JSONL trace under {run_dir!r} (expected "
            "trace-p*[.i<k>].jsonl — run with --telemetry-dir)")
    incs = [load_incarnation(idx, files) for idx, files in families]
    anchored = [i for i in incs if i.start_wall is not None]
    if not anchored:
        raise ValueError(
            f"{run_dir}: no trace carries a wall-clock header anchor; "
            "the ledger cannot place incarnations on a shared timeline")
    anchored.sort(key=lambda i: i.start_wall)
    # heartbeat files are overwritten by each new life, so the one on
    # disk belongs to the LAST incarnation whose window contains its
    # stamp — extending that life's evidence tail (the stall a hung
    # process left behind after its final span)
    for path in glob.glob(os.path.join(run_dir, "heartbeat-p*.json")):
        hb = read_heartbeat(path)
        wall = (hb or {}).get("wall_time")
        if not isinstance(wall, (int, float)):
            continue
        owner = None
        for inc in anchored:
            if inc.start_wall <= wall:
                owner = inc
        if owner is not None and wall > (owner.end_wall or 0.0):
            owner.end_wall = wall
    # a hang incarnation carries its stuck-collective evidence when the
    # run had --comms-monitor: the hang-forensics bundle (or the raw comms
    # health files) name the ring that wedged, and the note surfaces in
    # the goodput report beside the badput that hang caused
    hangs = [i for i in anchored if i.exit == "hang"]
    if hangs:
        from tpu_ddp_torch.comms.forensics import suspect_from_files

        try:
            suspect = suspect_from_files(run_dir)
        except Exception:
            suspect = None
        if suspect:
            # forensics files are overwritten a life, so like the
            # heartbeat they belong to the NEWEST hang incarnation
            hangs[-1].notes.append(
                f"incarnation {hangs[-1].index}: hang forensics suspect "
                f"collective {suspect.get('key')} "
                f"(evidence: {suspect.get('source')})")
    meta = next((i.run_meta for i in anchored if i.run_meta), None)
    return StitchedRun(run_dir=run_dir, incarnations=anchored,
                       run_meta=meta)
