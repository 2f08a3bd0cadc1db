"""Drift detection over the registry's cross-run metric series.

Entries sharing a (config digest, device kind) pair form a time series
per metric — "the same thing, measured on the same chip, across
commits". Each point is judged against the rolling median + k×MAD of
the window preceding it: the same robust estimator the health spike
detector and the monitor's straggler verdict use (one bad commit cannot
drag the threshold the way mean/std would). The MAD is floored at a
fraction of |median| so a series that has plateaued (MAD ≈ 0) doesn't
flag build-to-build jitter — with the default floor and threshold, a
drift must exceed ~5% of the median to fire, and the ISSUE's canonical
10% throughput regression always does.

Finding ids follow the lint-``RULES`` pattern (stable id + severity +
fix hint; ``TREND_RULES`` is the single source behind the findings and
the docs/registry.md table):

- REG001 — a higher-is-better metric (throughput, MFU, goodput) fell
- REG002 — a lower-is-better metric (bytes, flops, measured seconds)
  grew
- REG003 — an exact count (collective inventory, lint findings, badput
  category presence) increased vs the previous entry: never noise
- REG004 — a series entry carries no commit identity (null/dirty git),
  so a drift there cannot be bisected

Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple

from tpu_ddp_torch.registry.store import RegistryEntry

#: rule registry: id -> (title, severity, fix hint) — the single source
#: behind findings and the docs/registry.md table
TREND_RULES: Dict[str, Dict[str, str]] = {
    "REG001": {
        "title": "measured-rate drift (higher-is-better metric fell)",
        "severity": "critical",
        "fix": "a throughput/MFU/goodput series dropped > k*MAD below "
               "its rolling median: `tpu-ddp-torch registry diff` the flagged "
               "entry against the last good one, then bisect the "
               "commits between their provenance stamps",
    },
    "REG002": {
        "title": "cost growth (lower-is-better metric rose)",
        "severity": "warning",
        "fix": "bytes/flops/measured step seconds grew > k*MAD above "
               "the rolling median: check the flagged commit for a "
               "layout change (`tpu-ddp-torch analyze`), a lost fusion, or a "
               "fatter input pipeline",
    },
    "REG003": {
        "title": "exact-count increase (collectives / lint findings)",
        "severity": "critical",
        "fix": "a collective-inventory or lint-finding count rose vs "
               "the previous entry of this series — an extra collective "
               "is a layout change, never noise; `tpu-ddp-torch registry "
               "diff` the two entries for the full structured diff",
    },
    "REG004": {
        "title": "unattributable entry in a gated series",
        "severity": "info",
        "fix": "an entry in this series has no clean commit identity "
               "(recorded outside git or from a dirty tree): drift "
               "through it cannot be bisected — re-record from a clean "
               "checkout",
    },
}


@dataclasses.dataclass
class TrendConfig:
    """Estimator knobs (mirrors the health ``SpikeDetector`` shape)."""

    window: int = 8          # rolling history per judgment
    threshold: float = 5.0   # k of the k*MAD band
    min_history: int = 4     # points required before judging
    rel_floor: float = 0.01  # MAD floor as a fraction of |median|


@dataclasses.dataclass
class TrendFinding:
    """One drift verdict on one series point."""

    rule: str
    severity: str
    metric: str
    config_digest: Optional[str]
    device_kind: str
    entry_id: str
    git_commit: Optional[str]
    value: Optional[float]
    baseline: Optional[float]
    message: str

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["title"] = TREND_RULES[self.rule]["title"]
        rec["fix"] = TREND_RULES[self.rule]["fix"]
        return rec

    def render(self) -> str:
        commit = (self.git_commit[:9] if isinstance(self.git_commit, str)
                  else "-")
        return (f"{self.rule} [{self.severity}] "
                f"{self.device_kind} cfg={self.config_digest or '-'} "
                f"{self.metric}: {self.message} "
                f"(entry {self.entry_id}, commit {commit})")


def _series(entries: List[RegistryEntry]) -> Dict[
        Tuple[Optional[str], str, str],
        List[Tuple[RegistryEntry, float]]]:
    """{(config_digest, device_kind, metric): [(entry, value), ...]}
    oldest-first (``read_entries`` already sorted by recorded_at).

    Exact-count metrics get UNION-OF-KEYS semantics within their
    (digest, chip, artifact kind) group, missing values defaulting to
    0 — exactly how ``regress.compare`` reads counts — so a count's
    FIRST appearance (a fresh badput category, a lint rule firing for
    the first time, a new collective-inventory key) registers as
    0 -> N drift instead of silently starting a new one-point series.
    Measured/size metrics keep presence-only series: an entry that
    simply didn't record a rate is not a zero rate. The kind is part
    of the count-group key because one run records several artifact
    kinds under one digest, and a goodput entry genuinely has no
    inventory counts."""
    out: Dict[Tuple[Optional[str], str, str],
              List[Tuple[RegistryEntry, float]]] = {}
    groups: Dict[Tuple[Optional[str], str, str],
                 List[RegistryEntry]] = {}
    for e in entries:
        groups.setdefault(
            (e.config_digest, e.device_kind, e.artifact_kind), []
        ).append(e)
        for metric, value in (e.metrics or {}).items():
            if _direction(metric) != "exact" and isinstance(
                    value, (int, float)):
                out.setdefault(
                    (e.config_digest, e.device_kind, metric), []
                ).append((e, float(value)))
    for (digest, chip, _kind), group in groups.items():
        count_metrics = sorted({
            m for e in group for m in (e.metrics or {})
            if _direction(m) == "exact"})
        for metric in count_metrics:
            series = out.setdefault((digest, chip, metric), [])
            series.extend(
                (e, float((e.metrics or {}).get(metric, 0.0)))
                for e in group)
            series.sort(key=lambda ev: ev[0].recorded_at)
    return out


def _direction(metric: str) -> Optional[str]:
    """'higher' | 'lower' | 'exact' from the metric-class segment the
    store embedded in the name (first class segment wins — bench
    ``rows/<name>/measured/...`` metrics nest it deeper than position
    1); None = not trended."""
    for cls in metric.split("/")[1:]:
        if cls in ("measured", "quality"):
            return "higher"
        if cls in ("size", "wall"):
            return "lower"
        if cls == "count":
            return "exact"
    return None


def _mad_band(values: List[float], cfg: TrendConfig) -> Tuple[float, float]:
    med = statistics.median(values)
    mad = statistics.median(abs(v - med) for v in values)
    floor = max(cfg.rel_floor * abs(med), 1e-12)
    return med, cfg.threshold * max(mad, floor)


def trend_findings(
    entries: List[RegistryEntry],
    config: Optional[TrendConfig] = None,
    *,
    metric_filter: Optional[str] = None,
) -> List[TrendFinding]:
    """Judge every series point against its preceding rolling window.
    ``metric_filter`` (substring) narrows to matching metric names."""
    cfg = config or TrendConfig()
    findings: List[TrendFinding] = []
    flagged_identity: set = set()
    for (digest, chip, metric), points in sorted(_series(entries).items()):
        if metric_filter and metric_filter not in metric:
            continue
        direction = _direction(metric)
        if direction is None:
            continue
        if direction == "exact":
            for (prev_e, prev_v), (e, v) in zip(points, points[1:]):
                if v > prev_v:
                    findings.append(TrendFinding(
                        rule="REG003",
                        severity=TREND_RULES["REG003"]["severity"],
                        metric=metric, config_digest=digest,
                        device_kind=chip, entry_id=e.entry_id,
                        git_commit=e.provenance.get("git_commit"),
                        value=v, baseline=prev_v,
                        message=f"{prev_v:g} -> {v:g} vs previous entry "
                                f"{prev_e.entry_id}",
                    ))
            continue
        for i, (e, v) in enumerate(points):
            history = [pv for _, pv in
                       points[max(0, i - cfg.window):i]]
            if len(history) < cfg.min_history:
                continue
            med, band = _mad_band(history, cfg)
            drifted = (v < med - band if direction == "higher"
                       else v > med + band)
            if not drifted:
                continue
            rule = "REG001" if direction == "higher" else "REG002"
            delta = (v - med) / med if med else 0.0
            findings.append(TrendFinding(
                rule=rule, severity=TREND_RULES[rule]["severity"],
                metric=metric, config_digest=digest, device_kind=chip,
                entry_id=e.entry_id,
                git_commit=e.provenance.get("git_commit"),
                value=v, baseline=med,
                message=f"{v:g} vs rolling median {med:g} "
                        f"({delta:+.1%}, band ±{band:g} over "
                        f"{len(history)} entries)",
            ))
            # one REG004 per unattributable entry that drifted: the
            # drift exists but cannot be pinned to a commit
            if not e.clean and e.entry_id not in flagged_identity:
                flagged_identity.add(e.entry_id)
                why = ("dirty working tree"
                       if e.provenance.get("git_dirty")
                       else "no git identity")
                findings.append(TrendFinding(
                    rule="REG004",
                    severity=TREND_RULES["REG004"]["severity"],
                    metric=metric, config_digest=digest,
                    device_kind=chip, entry_id=e.entry_id,
                    git_commit=e.provenance.get("git_commit"),
                    value=None, baseline=None,
                    message=f"drifting entry recorded with {why} — "
                            "cannot be bisected",
                ))
    order = {"critical": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: (order.get(f.severity, 3), f.rule,
                                 f.metric))
    return findings
