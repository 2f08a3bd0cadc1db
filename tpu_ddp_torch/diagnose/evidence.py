"""Evidence gathering for ``tpu-ddp-torch diagnose``.

The port's copy of ``tpu_ddp/diagnose/evidence.py``: the eleven loaders
read the port's readers of the same names, and refuse in the JAX words.

One loader per artifact family; each returns a :class:`Source` whose
``data`` is the normalized extract the rules consume and whose
``citations`` name exactly where each datum came from (artifact path +
field). When a family left nothing behind the source is a NAMED refusal
(``ok=False`` with a reason) — the rules must treat that as "cannot
know", never as "fine". Nothing here invents evidence.

Future-schema artifacts are a different animal: a file this tool
*found* but cannot read must abort the whole diagnosis (the house
exit-2 convention), so any ``ValueError`` carrying the shared
"newer than this tool understands" marker propagates to the caller
instead of degrading into a refusal.

Stdlib-only: importable from the elastic supervisor and the watch
dashboard with neither torch nor numpy loaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

#: bump on any breaking change to the diagnose artifact shape
DIAG_SCHEMA_VERSION = 1

#: the marker ``read_records``-style loaders put in their future-schema
#: refusals — these must abort the diagnosis, not soften into a refusal
_FUTURE_MARKER = "newer than this tool understands"

#: every family ``gather_evidence`` accounts for, in load order
SOURCE_NAMES = (
    "trace", "ledger", "health", "mem", "datapath", "comms",
    "elastic", "alerts", "profiles", "artifacts", "registry",
)


def cite(path: str, field: str) -> Dict[str, str]:
    """One citation: the artifact file + the field within it."""
    return {"path": path, "field": field}


@dataclasses.dataclass
class Source:
    """One evidence family: loaded data + citations, or a named refusal."""

    name: str
    ok: bool
    data: Any = None
    citations: List[dict] = dataclasses.field(default_factory=list)
    reason: Optional[str] = None  # set iff ok is False

    def to_json(self) -> dict:
        return {
            "ok": self.ok,
            "reason": self.reason,
            "citations": list(self.citations),
        }


@dataclasses.dataclass
class Evidence:
    """The normalized cross-observatory evidence table for one run dir."""

    run_dir: str
    sources: Dict[str, Source]
    registry_dir: Optional[str] = None

    def source(self, name: str) -> Source:
        return self.sources[name]

    def data(self, name: str) -> Any:
        """The family's data, or None when it refused."""
        src = self.sources.get(name)
        return src.data if src is not None and src.ok else None

    @property
    def refusals(self) -> List[dict]:
        return [{"source": s.name, "reason": s.reason}
                for s in self.sources.values() if not s.ok]

    @property
    def run_meta(self) -> Optional[dict]:
        trace = self.data("trace")
        return (trace or {}).get("run_meta")


def _refuse(name: str, reason: str) -> Source:
    return Source(name=name, ok=False, reason=reason)


def _hist_row(h) -> Dict[str, float]:
    return {"count": h.count, "p50_s": h.percentile(50),
            "p95_s": h.percentile(95), "total_s": h.sum}


# -- per-family loaders ----------------------------------------------------


def _load_trace(run_dir: str) -> Source:
    from tpu_ddp_torch.telemetry.summarize import (
        aggregate_phases,
        find_run_meta,
        find_trace_files,
        last_counters,
        per_host_phase_p50,
        read_records,
    )

    try:
        files = find_trace_files(run_dir)
    except FileNotFoundError as e:
        return _refuse("trace", str(e))
    records = read_records(files)  # future schema raises (exit 2)
    phases = {name: _hist_row(h)
              for name, h in aggregate_phases(records).items()}
    counters = last_counters(records)
    data = {
        "files": list(files),
        "phases": phases,
        "per_host_compiled_p50":
            per_host_phase_p50(records, "compiled_step"),
        "per_host_data_wait_p50":
            per_host_phase_p50(records, "data_wait"),
        "counters": counters,
        "run_meta": find_run_meta(records),
    }
    cites = [cite(f, "span/*") for f in files]
    return Source("trace", True, data, cites)


def _load_ledger(run_dir: str) -> Source:
    from tpu_ddp_torch.ledger.stitch import stitch_run
    from tpu_ddp_torch.ledger.taxonomy import build_ledger

    try:
        ledger = build_ledger(stitch_run(run_dir))
    except FileNotFoundError as e:
        return _refuse("ledger", str(e))
    except ValueError as e:
        if _FUTURE_MARKER in str(e):
            raise
        return _refuse("ledger", str(e))
    data = {
        "elapsed_s": ledger.elapsed_s,
        "goodput_fraction": ledger.goodput_fraction,
        "category_seconds": dict(ledger.categories),
        "category_presence": ledger.category_presence,
        "exit_counts": ledger.exit_counts,
        "n_incarnations": len(ledger.incarnations),
        "n_failures": ledger.n_failures,
        "incarnations": [e.to_json() for e in ledger.incarnations],
        "recommendation": ledger.recommendation,
        "run_id": ledger.run_id,
        "strategy": ledger.strategy,
        "device_kind": ledger.device_kind,
    }
    cites = [cite(run_dir, "ledger.category_seconds"),
             cite(run_dir, "ledger.exit_counts")]
    return Source("ledger", True, data, cites)


def _load_health(run_dir: str) -> Source:
    from tpu_ddp_torch.health.summarize import (
        find_health_files,
        list_anomalies,
        read_health_records,
    )

    try:
        files = find_health_files(run_dir)
    except FileNotFoundError as e:
        return _refuse("health", str(e))
    records = read_health_records(files)  # future schema raises
    nonfinite = [
        {"step": r.get("step"), "pid": r.get("pid"),
         "anomaly": r.get("anomaly") or "nonfinite"}
        for r in records
        if r.get("type") == "health"
        and (r.get("all_finite") is False or r.get("anomaly"))
    ]
    anomalies = [
        {"step": m.get("step"), "reason": m.get("reason"),
         "policy": m.get("policy"), "dir": m.get("_dir")}
        for m in list_anomalies(run_dir)
    ]
    data = {"files": list(files), "n_records": len(records),
            "nonfinite": nonfinite, "anomalies": anomalies}
    cites = [cite(f, "health.all_finite") for f in files]
    cites += [cite(os.path.join(a["dir"], "meta.json"), "reason")
              for a in anomalies if a.get("dir")]
    return Source("health", True, data, cites)


def _load_mem(run_dir: str) -> Source:
    from tpu_ddp_torch.memtrack.report import mem_json

    try:
        art = mem_json(run_dir, with_plan=False)
    except FileNotFoundError as e:
        return _refuse("mem", str(e))
    except ValueError as e:
        if _FUTURE_MARKER in str(e):
            raise
        return _refuse("mem", str(e))
    mem = art.get("mem") or {}
    data = {k: mem.get(k) for k in
            ("oom_count", "high_water_frac", "high_water_bytes",
             "fragmentation_bytes", "n_hosts", "run_id")}
    data["oom"] = art.get("oom") or []
    path = os.path.join(run_dir, "mem-p*.jsonl")
    cites = [cite(path, "mem.oom_count"),
             cite(path, "mem.high_water_frac")]
    return Source("mem", True, data, cites)


def _load_datapath(run_dir: str) -> Source:
    from tpu_ddp_torch.datapath.report import datapath_measured
    from tpu_ddp_torch.datapath.stages import (
        DATA_HEALTH_SCHEMA_VERSION,
        data_health_files,
        read_data_health,
        suspect_stage_from_files,
    )

    files = data_health_files(run_dir)
    for path in files:
        rec = read_data_health(path) or {}
        version = rec.get("data_health_schema_version", 0)
        if isinstance(version, int) \
                and version > DATA_HEALTH_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: data_health_schema_version {version} is "
                f"{_FUTURE_MARKER} ({DATA_HEALTH_SCHEMA_VERSION})")
    try:
        measured = datapath_measured(run_dir)
    except ValueError:
        raise  # trace-side future schema
    suspect = suspect_stage_from_files(run_dir)
    if not measured and not files:
        return _refuse(
            "datapath",
            f"no staged data-path evidence in {run_dir} (no stage "
            "spans, prefetch counters, or data-health-p*.json — run "
            "with --prefetch-batches or --prefetch-depth 0)")
    data = {"measured": measured or None, "suspect_stage": suspect,
            "health_files": list(files)}
    cites = [cite(f, "stages") for f in files]
    if measured:
        cites.append(cite(run_dir, "datapath.stages"))
    return Source("datapath", True, data, cites)


def _load_comms(run_dir: str) -> Source:
    from tpu_ddp_torch.comms.exposure import EXPOSURE_FILENAME, read_exposure
    from tpu_ddp_torch.comms.forensics import (
        COMMS_HEALTH_SCHEMA_VERSION,
        read_health,
        suspect_from_files,
    )

    healths = read_health(run_dir)
    for rec in healths:
        version = rec.get("comms_health_schema_version", 0)
        if isinstance(version, int) \
                and version > COMMS_HEALTH_SCHEMA_VERSION:
            raise ValueError(
                f"{run_dir}: comms_health_schema_version {version} is "
                f"{_FUTURE_MARKER} ({COMMS_HEALTH_SCHEMA_VERSION})")
    exposure = read_exposure(run_dir)
    if not healths and exposure is None:
        return _refuse(
            "comms",
            f"no comms evidence in {run_dir} (no comms-health-p*.json "
            "or comms-exposure.json — run with --comms-monitor)")
    suspect = suspect_from_files(run_dir)
    in_flight = next(
        (h["in_flight"] for h in healths
         if isinstance(h.get("in_flight"), dict)), None)
    data = {"exposure": exposure, "suspect": suspect,
            "in_flight": in_flight, "n_health_files": len(healths)}
    cites = []
    if healths:
        cites.append(cite(os.path.join(run_dir, "comms-health-p*.json"),
                          "in_flight"))
    if exposure is not None:
        cites.append(cite(os.path.join(run_dir, EXPOSURE_FILENAME),
                          "measured_comm_share"))
    return Source("comms", True, data, cites)


def _load_elastic(run_dir: str) -> Source:
    from tpu_ddp_torch.elastic.recovery import elastic_log_path, read_decisions

    path = elastic_log_path(run_dir)
    if not os.path.exists(path):
        return _refuse(
            "elastic",
            f"no {os.path.basename(path)} in {run_dir} (the run was "
            "not supervised by tpu-ddp-torch elastic)")
    decisions = read_decisions(run_dir)
    cites = [cite(path, "event")]
    return Source("elastic", True, {"decisions": decisions}, cites)


def _load_alerts(run_dir: str) -> Source:
    from tpu_ddp_torch.monitor.alerts import alert_history, read_alerts

    path = os.path.join(run_dir, "alerts.jsonl")
    if not os.path.exists(path):
        return _refuse(
            "alerts",
            f"no alerts.jsonl in {run_dir} (no watcher ran against "
            "this run dir)")
    episodes = alert_history(read_alerts(run_dir))  # future raises
    return Source("alerts", True, {"episodes": episodes},
                  [cite(path, "rule")])


def _load_profiles(run_dir: str) -> Source:
    from tpu_ddp_torch.profiler.capture import list_bundles

    bundles = list_bundles(run_dir)
    if not bundles:
        return _refuse(
            "profiles",
            f"no capture bundles under {run_dir}/profiles/ (nothing "
            "triggered or armed a profiler capture)")
    cites = [cite(os.path.join(b["path"], "meta.json"), "trigger")
             for b in bundles]
    return Source("profiles", True, {"bundles": bundles}, cites)


#: top-level run-dir ``*.json`` sniffers for dropped-in analysis
#: artifacts (key -> artifact family)
_ARTIFACT_SNIFF = (
    ("lint_schema_version", "lint"),
    ("curves_schema_version", "curves"),
    ("curve", "curves"),
    ("anatomy", "analyze"),
    ("programs", "analyze"),
)


def _load_artifacts(run_dir: str) -> Source:
    """Lint/analyze/curves artifacts dropped into the run dir (the
    ``--json`` outputs operators park beside the telemetry)."""
    found: Dict[str, dict] = {}
    cites: List[dict] = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError as e:
        return _refuse("artifacts", f"cannot list {run_dir}: {e}")
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(run_dir, name)
        try:
            with open(path) as f:
                art = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(art, dict):
            continue
        for key, family in _ARTIFACT_SNIFF:
            if key in art and family not in found:
                entry: Dict[str, Any] = {"path": path}
                counts: Dict[str, int] = {}
                for rec in (art.get("programs") or {}).values():
                    if isinstance(rec, dict):
                        for rule, n in (rec.get("rule_counts")
                                        or {}).items():
                            counts[rule] = counts.get(rule, 0) + int(n)
                if isinstance(art.get("curve"), dict):
                    for rule, n in (art["curve"].get("rule_counts")
                                    or {}).items():
                        counts[rule] = counts.get(rule, 0) + int(n)
                entry["rule_counts"] = counts
                found[family] = entry
                cites.append(cite(path, "rule_counts"))
                break
    if not found:
        return _refuse(
            "artifacts",
            f"no lint/analyze/curves --json artifacts in {run_dir}")
    return Source("artifacts", True, found, cites)


def _load_registry(registry_dir: Optional[str]) -> Source:
    if not registry_dir:
        return _refuse("registry", "no --against registry given")
    from tpu_ddp_torch.registry.store import read_entries

    try:
        entries = read_entries(registry_dir)  # future schema raises
    except FileNotFoundError as e:
        return _refuse("registry", str(e))
    kinds: Dict[str, int] = {}
    for e in entries:
        kinds[e.artifact_kind] = kinds.get(e.artifact_kind, 0) + 1
    data = {"dir": registry_dir, "n_entries": len(entries),
            "kinds": kinds}
    return Source("registry", True, data,
                  [cite(registry_dir, "entries")])


# -- the gather ------------------------------------------------------------


def gather_evidence(run_dir: str,
                    registry_dir: Optional[str] = None) -> Evidence:
    """Load every family. Raises ``FileNotFoundError`` when ``run_dir``
    is not a directory, ``ValueError`` when any found artifact is from
    a future schema; everything else lands as a named refusal."""
    if not os.path.isdir(run_dir):
        raise FileNotFoundError(f"{run_dir}: not a directory")
    sources: Dict[str, Source] = {}
    loaders = {
        "trace": lambda: _load_trace(run_dir),
        "ledger": lambda: _load_ledger(run_dir),
        "health": lambda: _load_health(run_dir),
        "mem": lambda: _load_mem(run_dir),
        "datapath": lambda: _load_datapath(run_dir),
        "comms": lambda: _load_comms(run_dir),
        "elastic": lambda: _load_elastic(run_dir),
        "alerts": lambda: _load_alerts(run_dir),
        "profiles": lambda: _load_profiles(run_dir),
        "artifacts": lambda: _load_artifacts(run_dir),
        "registry": lambda: _load_registry(registry_dir),
    }
    for name in SOURCE_NAMES:
        sources[name] = loaders[name]()
    return Evidence(run_dir=run_dir, sources=sources,
                    registry_dir=registry_dir)
