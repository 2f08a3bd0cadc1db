"""Render a run dir's numerics-health record: ``python -m tpu_ddp_torch.cli.main health DIR``.

Counterpart of ``tpu_ddp/health/summarize.py`` (the JAX CLI's ``tpu-ddp
health``, ``tpu_ddp/cli/main.py:19``). Reads the ``health-p*.jsonl`` files
a monitored run wrote (``health/monitor.py``) and the ``anomalies/`` dump
directory, and renders the health timeline: per-metric percentiles, a
loss/grad-norm sparkline over steps, and every recorded anomaly with its
dump location. The records are those of the JAX package (schema version
1), so either package's summary reads either package's run dir.

Stdlib only, like the JAX module. The JAX module borrows its record loop
(``telemetry/summarize.py::read_records``), its percentiles
(``telemetry/registry.py::Histogram``) and its skew line
(``monitor/aggregate.py::host_skew``) from other JAX modules; it takes the
skew line from the port's ``monitor/aggregate.py`` and keeps its own
copies of the other two (``read_records``, ``_Percentiles``).
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Dict, Iterable, List, Optional

#: Version of the health-record JSONL schema (the JAX package's).
HEALTH_SCHEMA_VERSION = 1

#: Scalar series the summary table reports, in display order.
SERIES = ("loss", "grad_norm", "param_norm", "update_norm", "update_ratio")

_BARS = "▁▂▃▄▅▆▇█"


def find_health_files(path: str) -> List[str]:
    """A health JSONL itself, or a run dir holding ``health-p*.jsonl``."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        hits = sorted(glob.glob(os.path.join(path, "health-p*.jsonl")))
        if hits:
            return hits
    raise FileNotFoundError(
        f"no health record under {path!r} (expected health-p*.jsonl — "
        "was the run started with --health on?)"
    )


def read_records(paths: Iterable[str], *, schema_version: int = HEALTH_SCHEMA_VERSION,
                 kind: str = "health") -> List[dict]:
    """Parse JSONL records, skipping torn lines (a crash mid-write leaves at
    most one) and refusing records of a newer schema."""
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


class _Percentiles:
    """count, min, max and nearest-rank percentiles of the values recorded
    (the JAX ``Histogram``'s, without its lock and window)."""

    def __init__(self) -> None:
        self._values: List[float] = []
        self.min = math.inf
        self.max = -math.inf

    @property
    def count(self) -> int:
        return len(self._values)

    def record(self, v: float) -> None:
        v = float(v)
        self._values.append(v)
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def percentile(self, p: float) -> Optional[float]:
        vals = sorted(self._values)
        if not vals:
            return None
        rank = max(0, min(len(vals) - 1, math.ceil(p / 100.0 * len(vals)) - 1))
        return vals[rank]


def read_health_records(paths: Iterable[str]) -> List[dict]:
    return read_records(paths, schema_version=HEALTH_SCHEMA_VERSION, kind="health")


def sparkline(values: List[Optional[float]], width: int = 60) -> str:
    """Bucketed unicode sparkline; non-finite buckets render as ``!``."""
    if not values:
        return ""
    n_buckets = min(width, len(values))
    per = len(values) / n_buckets
    out = []
    finite = [v for v in values if v is not None and math.isfinite(v)]
    lo = min(finite) if finite else 0.0
    hi = max(finite) if finite else 1.0
    span = (hi - lo) or 1.0
    for b in range(n_buckets):
        chunk = values[int(b * per):max(int((b + 1) * per), int(b * per) + 1)]
        good = [v for v in chunk if v is not None and math.isfinite(v)]
        if len(good) < len(chunk):
            out.append("!")  # a non-finite step lives in this bucket
        elif not good:
            out.append(" ")
        else:
            mean = sum(good) / len(good)
            idx = int((mean - lo) / span * (len(_BARS) - 1))
            out.append(_BARS[max(0, min(len(_BARS) - 1, idx))])
    return "".join(out)


def list_anomalies(run_dir: str) -> List[dict]:
    """Read ``anomalies/*/meta.json`` dumps under a run dir."""
    out = []
    for meta_path in sorted(glob.glob(os.path.join(run_dir, "anomalies", "*", "meta.json"))):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        meta["_dir"] = os.path.dirname(meta_path)
        out.append(meta)
    return out


def summarize_health(path: str) -> str:
    """Human-readable health timeline for a run dir or a health file."""
    files = find_health_files(path)
    records = read_health_records(files)
    steps = [r for r in records if r.get("type") == "health"]
    lines = [f"health: {', '.join(files)}", ""]
    if not steps:
        lines.append("no health step records")
        return "\n".join(lines)
    steps.sort(key=lambda r: (r.get("step", 0), r.get("pid", 0)))
    # one row per step for the timeline: ranks report identical global
    # stats, so collapse duplicates on the step id
    by_step: Dict[int, dict] = {}
    for r in steps:
        by_step.setdefault(r.get("step", 0), r)
    ordered = [by_step[s] for s in sorted(by_step)]

    # before the collapse: per-host grad-norm p50 skew (the stats are
    # replicated globals, so any real delta means a rank diverged)
    per_host: Dict[int, _Percentiles] = {}
    for r in steps:
        v = r.get("grad_norm")
        if isinstance(v, (int, float)) and math.isfinite(v):
            per_host.setdefault(r.get("pid", 0), _Percentiles()).record(v)
    from tpu_ddp_torch.monitor.aggregate import host_skew

    skew = host_skew({pid: h.percentile(50) for pid, h in per_host.items() if h.count})
    if skew:
        lines.append(
            f"per-host skew: grad_norm p50 max delta {skew['max_delta']:.3g}"
            f" vs fleet median {skew['median']:.3g} (host {skew['host']})"
        )

    nonfinite = [r["step"] for r in ordered if not r.get("all_finite", True)]
    spikes = [r["step"] for r in ordered if r.get("anomaly") == "loss_spike"]
    lines.append(
        f"steps: {len(ordered)} "
        f"(step {ordered[0].get('step')}..{ordered[-1].get('step')})   "
        f"non-finite: {len(nonfinite)}   loss spikes: {len(spikes)}"
    )
    lines.append("")

    header = f"{'metric':<14} {'min':>12} {'p50':>12} {'p95':>12} {'max':>12}"
    lines.append(header)
    lines.append("-" * len(header))
    for key in SERIES:
        hist = _Percentiles()
        for r in ordered:
            v = r.get(key)
            if isinstance(v, (int, float)) and math.isfinite(v):
                hist.record(v)
        if not hist.count:
            continue
        lines.append(
            f"{key:<14} {hist.min:>12.5g} {hist.percentile(50):>12.5g} "
            f"{hist.percentile(95):>12.5g} {hist.max:>12.5g}"
        )
    lines.append("")
    for key in ("loss", "grad_norm"):
        series = [r.get(key) for r in ordered]
        lines.append(f"{key:<10} |{sparkline(series)}|")
    if nonfinite:
        shown = ", ".join(str(s) for s in nonfinite[:10])
        more = "" if len(nonfinite) <= 10 else f" (+{len(nonfinite) - 10} more)"
        lines.append("")
        lines.append(f"non-finite steps: {shown}{more}")
    if spikes:
        shown = ", ".join(str(s) for s in spikes[:10])
        more = "" if len(spikes) <= 10 else f" (+{len(spikes) - 10} more)"
        lines.append(f"loss-spike steps: {shown}{more}")

    run_dir = path if os.path.isdir(path) else os.path.dirname(path)
    anomalies = list_anomalies(run_dir) if run_dir else []
    if anomalies:
        lines.append("")
        lines.append("anomaly dumps:")
        for meta in anomalies:
            lines.append(
                f"  step {meta.get('step')}: {meta.get('reason')} "
                f"(policy {meta.get('policy')}) -> {meta.get('_dir')}"
            )
    return "\n".join(lines)
