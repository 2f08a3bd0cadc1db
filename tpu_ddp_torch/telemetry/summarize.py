"""Aggregate a JSONL trace into per-phase percentiles.

Counterpart of ``tpu_ddp/telemetry/summarize.py``; backs ``python -m
tpu_ddp_torch.cli.main trace summarize DIR [--json]``. Reads the
schema-versioned JSONL trace(s) a run wrote (``trace-p*.jsonl``), buckets
span durations by phase name, and renders the same table the terminal
summary sink prints live. ``--json`` emits the same aggregation as a
schema-versioned machine artifact (:func:`summarize_json`). The comms
section reads ``comms-exposure.json`` and ``comms-health-p<i>.json`` and
the data section the loader's stage spans (``datapath/report.py``); each is
skipped quietly when its evidence is absent. ``run_label`` prints the
run's torch version where the JAX one prints its jax version.
Stdlib-only so it runs anywhere the trace files land.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterable, List, Optional

from tpu_ddp_torch.telemetry.events import SCHEMA_VERSION, SPAN
from tpu_ddp_torch.telemetry.registry import Histogram
from tpu_ddp_torch.telemetry.sinks import format_phase_table

#: bump on any breaking change to the ``summarize --json`` shape
TRACE_SUMMARY_SCHEMA_VERSION = 1

#: the measured comms evidence's files (the JAX ``comms/exposure.py``
#: ``EXPOSURE_FILENAME`` and ``comms/forensics.py`` ``HEALTH_PREFIX``)
EXPOSURE_FILENAME = "comms-exposure.json"
HEALTH_PREFIX = "comms-health"


def find_trace_files(path: str) -> List[str]:
    """Resolve a summarize target: a trace file itself, or a run dir
    holding ``trace-p*.jsonl`` (one per host; all incarnations, ordered
    host-major then incarnation-ascending — lexical sorting would put
    ``trace-p0.i1.jsonl`` BEFORE ``trace-p0.jsonl`` and break every
    later-record-wins merge over the concatenated stream)."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        from tpu_ddp_torch.telemetry import parse_trace_name

        def order(p: str):
            parsed = parse_trace_name(os.path.basename(p))
            return parsed[:2] if parsed else (1 << 30, 0)

        hits = sorted(glob.glob(os.path.join(path, "trace-p*.jsonl")),
                      key=lambda p: (order(p), p))
        if hits:
            return hits
        # tolerate a bare trace.jsonl (hand-rolled runs)
        flat = os.path.join(path, "trace.jsonl")
        if os.path.isfile(flat):
            return [flat]
    raise FileNotFoundError(
        f"no JSONL trace under {path!r} (expected trace-p*.jsonl)"
    )


def read_records(paths: Iterable[str], *,
                 schema_version: int = SCHEMA_VERSION,
                 kind: str = "trace") -> List[dict]:
    """Parse JSONL records, skipping torn trailing lines (a crash mid-write
    leaves at most one) and refusing records from a future schema.

    ``schema_version``/``kind`` let the other schema-versioned JSONL
    consumers (the health summarizer) share this loop instead of forking
    the torn-line/future-schema handling."""
    records: List[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line from a crash — expected
                version = rec.get("schema_version")
                if version is not None and version > schema_version:
                    raise ValueError(
                        f"{path}: {kind} schema_version {version} is newer "
                        f"than this tool understands ({schema_version})"
                    )
                records.append(rec)
    return records


def aggregate_phases(records: Iterable[dict]) -> Dict[str, Histogram]:
    """Span records -> {phase: Histogram of durations (seconds)}."""
    phases: Dict[str, Histogram] = {}
    for rec in records:
        if rec.get("type") != SPAN:
            continue
        name = rec.get("name")
        dur = rec.get("dur_s")
        if not isinstance(name, str) or not isinstance(dur, (int, float)):
            continue
        phases.setdefault(name, Histogram()).record(dur)
    return phases


def last_counters(records: Iterable[dict]) -> Dict[int, dict]:
    """Newest counters snapshot PER HOST ({pid: attrs}): counters are
    per-process registries, so a multihost run dir has one final snapshot
    per trace file — showing only one would silently drop the rest.

    "Newest" rather than "final" deliberately: a killed/preempted run
    never writes its clean-shutdown snapshot, but the Trainer's periodic
    ``counters_snapshot`` cadence (``telemetry_snapshot_steps``) leaves
    a usable tail — the attrs carry ``_step``/``_name`` metadata so the
    summary can say which kind it is showing."""
    snaps: Dict[int, dict] = {}
    for rec in records:
        if rec.get("type") == "counters" and rec.get("attrs") is not None:
            snaps[rec.get("pid", 0)] = {
                "_step": rec.get("step"),
                "_name": rec.get("name"),
                **rec["attrs"],
            }
    return snaps


def per_host_phase_p50(records: Iterable[dict],
                       phase: str) -> Dict[int, float]:
    """{pid: p50 seconds} of one phase's span durations — the input of
    the multi-rank skew line (``monitor/aggregate.py::host_skew``)."""
    by_host: Dict[int, Histogram] = {}
    for rec in records:
        if rec.get("type") != SPAN or rec.get("name") != phase:
            continue
        dur = rec.get("dur_s")
        if isinstance(dur, (int, float)):
            by_host.setdefault(rec.get("pid", 0), Histogram()).record(dur)
    return {pid: h.percentile(50) for pid, h in by_host.items()
            if h.count}


def find_run_meta(records: Iterable[dict]) -> Optional[dict]:
    """The raw run-metadata header dict the sinks wrote (first header
    record wins); None for anonymous (pre-header) traces."""
    for rec in records:
        if rec.get("type") == "header" and isinstance(
                rec.get("run_meta"), dict):
            return rec["run_meta"]
    return None


def run_label(records: Iterable[dict]) -> Optional[str]:
    """One-line run identity from the metadata header the sinks write
    (strategy / model / device / mesh / torch version); None for anonymous
    (pre-header) traces."""
    for rec in records:
        if rec.get("type") == "header" and rec.get("run_meta"):
            m = rec["run_meta"]
            cfg = m.get("config") or {}
            mesh = ",".join(f"{a}={s}" for a, s in (m.get("mesh") or {}).items()
                            if s != 1)
            parts = [
                f"strategy={m.get('strategy', '?')}",
                f"model={cfg.get('model', '?')}",
                f"device={m.get('device_kind', '?')} "
                f"x{m.get('n_devices', '?')}",
            ]
            if mesh:
                parts.append(f"mesh={mesh}")
            if m.get("torch_version"):
                parts.append(f"torch={m['torch_version']}")
            return "run: " + "  ".join(parts)
    return None


def eval_points(records: Iterable[dict]) -> List[dict]:
    """The run's eval HISTORY: every schema-versioned ``eval`` instant
    the Trainer emitted (one per evaluation), merged
    later-record-wins per anchor so a resumed run's replayed epochs
    keep exactly one point each. Callers feeding several incarnations
    must concatenate their records in incarnation order. Refuses points
    from a future eval schema (the trace schema gate can't see nested
    attrs)."""
    from tpu_ddp_torch.telemetry.events import EVAL_POINT_SCHEMA_VERSION

    merged: Dict[tuple, dict] = {}
    for rec in records:
        if rec.get("type") != "instant" or rec.get("name") != "eval":
            continue
        attrs = rec.get("attrs") or {}
        version = attrs.get("eval_schema_version")
        if isinstance(version, int) and version > EVAL_POINT_SCHEMA_VERSION:
            raise ValueError(
                f"eval point schema_version {version} is newer than this "
                f"tool understands ({EVAL_POINT_SCHEMA_VERSION})"
            )
        point = {
            "step": rec.get("step"),
            "epoch": attrs.get("epoch"),
            "final": bool(attrs.get("final")),
            "test_loss": attrs.get("test_loss"),
            "test_accuracy": attrs.get("test_accuracy"),
        }
        key = (("final",) if point["final"]
               else ("epoch", point["epoch"])
               if point["epoch"] is not None
               else ("step", point["step"]))
        merged[key] = point
    return sorted(
        merged.values(),
        key=lambda p: (p["step"] if isinstance(p["step"], int) else -1,
                       p["final"]),
    )


def format_eval_series(points: List[dict]) -> List[str]:
    """The eval-history block ``trace summarize`` renders — one line per
    recorded eval point. Empty when the run never evaluated (no
    --eval-each-epoch and no final eval)."""
    if not points:
        return []
    lines = [f"eval history ({len(points)} point(s)):"]
    for p in points:
        anchor = ("final" if p["final"]
                  else f"epoch {p['epoch']}" if p["epoch"] is not None
                  else "?")
        bits = [f"  {anchor:<9}"]
        if p["step"] is not None:
            bits.append(f"step {p['step']:<6}")
        if isinstance(p["test_loss"], (int, float)):
            bits.append(f"loss {p['test_loss']:.4f}")
        if isinstance(p["test_accuracy"], (int, float)):
            bits.append(f"acc {p['test_accuracy']:.4f}")
        lines.append(" ".join(bits))
    return lines


def _human_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TB"


def format_comms(counters: dict) -> List[str]:
    """The --grad-compress comms section: bytes-on-wire vs the
    uncompressed (f32-ring) equivalent and the effective ratio, from the
    ``comm/*`` counters the Trainer accumulates per step
    (parallel/compression.py accounting). These are ACCOUNTED numbers —
    static wire-byte bookkeeping, not measurement (the measured
    counterpart is :func:`format_comms_measured`). Empty when the run
    never compressed a gradient collective."""
    wire = counters.get("comm/grad_bytes_on_wire")
    base = counters.get("comm/grad_bytes_uncompressed")
    if not wire:
        return []
    lines = [
        "comms (gradient collectives, accounted):",
        f"  bytes on wire        = {_human_bytes(wire)} (accounted)",
    ]
    if base:
        lines.append(f"  uncompressed (f32)   = {_human_bytes(base)} "
                     "(accounted)")
        lines.append(f"  compression ratio    = {base / wire:.2f}x")
    return lines


def comms_measured(path: str) -> dict:
    """The run dir's MEASURED comms evidence: the exposed-comm record and
    the hop monitor's per-rank health files, as the JAX package's comms
    tools write them. Empty dict when the target is a bare trace file or
    the run left no comms evidence (the port writes none yet)."""
    out: dict = {}
    if not os.path.isdir(path):
        return out
    exp = _read_json(os.path.join(path, EXPOSURE_FILENAME))
    if exp is not None and "comms_exposure_schema_version" in exp:
        out["exposure"] = exp
    health = [rec for name in sorted(os.listdir(path))
              if name.startswith(f"{HEALTH_PREFIX}-p") and name.endswith(".json")
              for rec in [_read_json(os.path.join(path, name))] if rec is not None]
    if health:
        out["health"] = health
    return out


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def format_comms_measured(measured: dict) -> List[str]:
    """The measured comms block: exposed (non-overlapped) comm share vs
    the comm-stripped twin, plus each host's last-window achieved
    per-axis wire bandwidth from the hop monitor. Empty when the run
    left no measured comms evidence."""
    lines: List[str] = []
    exp = measured.get("exposure")
    if isinstance(exp, dict):
        lines.append("comms (measured):")
        share = exp.get("measured_comm_share")
        exposed = exp.get("exposed_comm_s")
        if share is not None and isinstance(exposed, (int, float)):
            lines.append(
                f"  exposed comm share   = {share:.1%} of the step "
                f"({exposed * 1e3:.2f} ms vs the comm-stripped twin)"
            )
        if isinstance(exp.get("t_full_s"), (int, float)):
            lines.append(
                f"  full / stripped step = {exp['t_full_s'] * 1e3:.2f} / "
                f"{exp.get('t_stripped_s', 0) * 1e3:.2f} ms"
            )
    for h in measured.get("health") or []:
        axis_bw = h.get("axis_bw") or {}
        if axis_bw and not lines:
            lines.append("comms (measured):")
        for axis, bw in sorted(axis_bw.items()):
            if isinstance(bw, (int, float)):
                lines.append(
                    f"  axis {axis:<14} = {_human_bytes(bw)}/s achieved "
                    f"on wire (host {h.get('process_index', '?')}, "
                    "hop-monitor window)"
                )
        last = h.get("last_collective")
        if last:
            lines.append(
                f"  last collective      = {last} "
                f"(host {h.get('process_index', '?')})"
            )
    return lines


def format_profiler(counters: dict) -> List[str]:
    """The anomaly-profiler section: how many capture windows ran and
    how much wall time sat inside them, from the ``profiler/*`` counters
    the capture manager bumps per bundle. Empty when
    the run never captured."""
    n = counters.get("profiler/captures_total")
    if not n:
        return []
    secs = counters.get("profiler/capture_seconds")
    line = f"profiler: {int(n)} capture window(s)"
    if isinstance(secs, (int, float)):
        line += f", {secs:.2f}s inside windows"
    line += " — bundles under <run_dir>/profiles/"
    return [line]


def summarize(path: str) -> str:
    """Human-readable summary of a run dir / trace file."""
    files = find_trace_files(path)
    records = read_records(files)
    phases = aggregate_phases(records)
    if not phases:
        return f"no span records in {', '.join(files)}"
    lines = [f"trace: {', '.join(files)}"]
    label = run_label(records)
    if label:
        lines.append(label)
    lines += ["", format_phase_table(phases)]
    # several ranks: one skew line per loop phase with >= 2 reporting
    # ranks — the post-hoc twin of the live monitor's straggler verdict
    from tpu_ddp_torch.monitor.aggregate import host_skew

    for phase in ("compiled_step", "data_wait"):
        skew = host_skew(per_host_phase_p50(records, phase))
        if skew:
            lines.append(
                f"per-host skew: {phase} p50 max delta "
                f"{1e3 * skew['max_delta']:.2f}ms vs fleet median "
                f"{1e3 * skew['median']:.2f}ms (host {skew['host']} at "
                f"{1e3 * skew['value']:.2f}ms)"
            )
    evals = format_eval_series(eval_points(records))
    if evals:
        lines.append("")
        lines.extend(evals)
    snaps = last_counters(records)
    for pid in sorted(snaps):
        counters = snaps[pid]
        flat = dict(counters.get("counters", {}))
        flat.update(counters.get("gauges", {}))
        if not flat:
            continue
        lines.append("")
        # a periodic mid-run snapshot as the newest record means the run
        # never shut down cleanly (killed/preempted) — say so instead of
        # presenting a stale tail as final
        kind = (
            "final snapshot" if counters.get("_name") != "counters_snapshot"
            else "last periodic snapshot"
            + (f" @ step {counters['_step']}"
               if counters.get("_step") is not None else "")
            + " — run did not shut down cleanly"
        )
        label = (
            f"counters/gauges ({kind}):" if len(snaps) == 1
            else f"counters/gauges ({kind}, host {pid}):"
        )
        lines.append(label)
        for k in sorted(flat):
            v = flat[k]
            shown = f"{v:.6g}" if isinstance(v, float) else str(v)
            lines.append(f"  {k} = {shown}")
        comms = format_comms(flat)
        if comms:
            lines.append("")
            lines.extend(comms)
        profiler = format_profiler(flat)
        if profiler:
            lines.append("")
            lines.extend(profiler)
    measured = format_comms_measured(comms_measured(path))
    if measured:
        lines.append("")
        lines.extend(measured)
    from tpu_ddp_torch.datapath.report import (
        datapath_measured,
        format_datapath_measured,
    )

    data_block = format_datapath_measured(datapath_measured(path))
    if data_block:
        lines.append("")
        lines.extend(data_block)
    return "\n".join(lines)


def summarize_json(path: str) -> dict:
    """Machine-readable twin of :func:`summarize`: the per-phase
    percentile table, the newest per-host counters/gauges, and the run
    identity (header run_meta + a provenance stamp), schema-versioned so
    the perf registry can record a run summary like any other artifact.
    Phase seconds are MEASURED wall clock, comparable only on one card."""
    from tpu_ddp_torch.telemetry.provenance import artifact_provenance

    files = find_trace_files(path)
    records = read_records(files)
    phases = aggregate_phases(records)
    meta = find_run_meta(records)
    counters: Dict[str, dict] = {}
    for pid, snap in last_counters(records).items():
        flat = dict(snap.get("counters", {}))
        flat.update(snap.get("gauges", {}))
        counters[str(pid)] = {
            "step": snap.get("_step"),
            "snapshot_kind": snap.get("_name"),
            "values": flat,
        }
    meta = meta or {}
    return {
        "trace_summary_schema_version": TRACE_SUMMARY_SCHEMA_VERSION,
        "type": "trace_summary",
        "files": [os.path.basename(f) for f in files],
        "run_meta": meta or None,
        "provenance": artifact_provenance(
            run_id=meta.get("run_id"),
            quality_digest=meta.get("quality_digest"),
            descriptor={"artifact": "trace_summary",
                        "strategy": meta.get("strategy"),
                        "mesh": meta.get("mesh")},
            device_kind=meta.get("device_kind"),
            torch_version=meta.get("torch_version"),
            strategy=meta.get("strategy"),
            mesh=meta.get("mesh"),
        ),
        "eval_points": eval_points(records),
        "phases": {
            name: {
                "count": h.count,
                "p50_s": h.percentile(50),
                "p95_s": h.percentile(95),
                "max_s": h.max,
                "total_s": h.sum,
            }
            for name, h in sorted(phases.items())
        },
        "counters": counters,
        # measured comms evidence (exposure record + hop-monitor health;
        # None when the run left none
        "comms": comms_measured(path) or None,
        # measured data-path evidence (staged data/<stage> spans +
        # prefetch queue counters) — None when the run
        # never ran the staged pipeline
        "datapath": _datapath_measured(path) or None,
    }


def _datapath_measured(path: str) -> dict:
    from tpu_ddp_torch.datapath.report import datapath_measured

    return datapath_measured(path)
