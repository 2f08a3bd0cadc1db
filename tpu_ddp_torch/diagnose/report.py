"""Incident-report rendering + the diagnose ``--json`` artifact.

The port's copy of ``tpu_ddp/diagnose/report.py``.

The artifact shape (``diagnose_schema_version`` 1) is a first-class
registry citizen: ``registry record`` classifies it as kind
``"diagnose"`` and ``tpu-ddp-torch bench compare`` gates its per-rule
``rule_counts`` exactly — a committed baseline with no suspects
regresses the moment a fresh suspect class appears.
"""

from __future__ import annotations

from typing import List, Optional

from tpu_ddp_torch.diagnose.evidence import DIAG_SCHEMA_VERSION, Evidence
from tpu_ddp_torch.diagnose.rules import Verdict, rule_counts


def build_artifact(ev: Evidence, verdicts: List[Verdict]) -> dict:
    from tpu_ddp_torch.telemetry.provenance import artifact_provenance

    ledger = ev.data("ledger") or {}
    meta = ev.run_meta or {}
    run_id = ledger.get("run_id") or meta.get("run_id")
    device_kind = ledger.get("device_kind") or meta.get("device_kind")
    strategy = ledger.get("strategy") or meta.get("strategy")
    return {
        "diagnose_schema_version": DIAG_SCHEMA_VERSION,
        "diagnose": {
            "run_dir": ev.run_dir,
            "run_id": run_id,
            "strategy": strategy,
            "device_kind": device_kind,
            "elapsed_s": ledger.get("elapsed_s"),
            "goodput_fraction": ledger.get("goodput_fraction"),
            "verdicts": [v.to_json() for v in verdicts],
            "rule_counts": rule_counts(verdicts),
            "sources": {name: src.to_json()
                        for name, src in ev.sources.items()},
            "refusals": ev.refusals,
        },
        "provenance": artifact_provenance(
            descriptor={"tool": "diagnose", "run_dir": ev.run_dir},
            run_id=run_id,
            device_kind=device_kind,
            strategy=strategy,
        ),
    }


def render_report(ev: Evidence, verdicts: List[Verdict]) -> str:
    lines: List[str] = []
    ledger = ev.data("ledger") or {}
    label = [f"diagnose: {ev.run_dir}"]
    if ledger.get("run_id"):
        label.append(f"run_id={ledger['run_id']}")
    if ledger.get("strategy"):
        label.append(f"strategy={ledger['strategy']}")
    gp = ledger.get("goodput_fraction")
    if isinstance(gp, (int, float)):
        label.append(f"goodput={gp:.1%}")
    lines.append("  ".join(label))
    lines.append("")
    if verdicts:
        lines.append(f"{len(verdicts)} suspect(s), ranked by goodput "
                     "cost:")
        for v in verdicts:
            lines.append(v.render())
    else:
        lines.append("no suspect: every loaded observatory reads clean")
    loaded = [n for n, s in ev.sources.items() if s.ok]
    lines.append("")
    lines.append(f"evidence: {len(loaded)} source(s) loaded "
                 f"({', '.join(loaded)})")
    for refusal in ev.refusals:
        lines.append(f"  cannot judge {refusal['source']}: "
                     f"{refusal['reason']}")
    return "\n".join(lines)


def render_likely_cause(cause: Optional[dict]) -> str:
    """The one-line row ``tpu-ddp-torch watch --once`` appends."""
    if not cause:
        return "likely cause: none (no suspect from the diagnose rules)"
    return (f"likely cause: {cause['rule']} {cause['title']} — "
            f"{cause['message']}")
