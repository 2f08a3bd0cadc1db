"""``tpu-ddp-torch goodput <run_dir>`` — render the cross-incarnation ledger.

The port's copy of ``tpu_ddp/ledger/report.py``: the same text and the
same ``--json`` artifact, with ``torch_version`` for ``jax_version``.

Text mode is the operator surface: goodput %, the badput breakdown
table (whose total row re-derives the elapsed wall-clock — the sum
identity is printed, not asserted in private), the per-incarnation
timeline with exit classifications, effective vs raw throughput,
measured MTBF, and the Young–Daly checkpoint-interval recommendation.

``--json`` emits the schema-versioned artifact ``tpu-ddp-torch bench
compare`` gates on: category *presence* and the goodput fraction gate
(a fresh ``restart_gap`` category or a goodput drop is a regression),
wall-clock totals are report-only. Stdlib-only.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from tpu_ddp_torch.ledger.stitch import stitch_run
from tpu_ddp_torch.ledger.taxonomy import CATEGORIES, RunLedger, build_ledger

#: bump on any breaking change to the ``--json`` artifact shape
LEDGER_SCHEMA_VERSION = 1


def elastic_decisions(run_dir: str) -> List[dict]:
    """The elastic supervisor's decision log for this run dir (empty
    when the run was not supervised) — the join that attributes each
    ``restart_gap`` second to a *decision* (fault class -> action ->
    backoff -> new mesh -> resume step) instead of merely observing it
    (docs/resilience.md)."""
    from tpu_ddp_torch.elastic.recovery import read_decisions

    return read_decisions(run_dir)


def ledger_json(ledger: RunLedger,
                decisions: Optional[List[dict]] = None) -> dict:
    """The ``--json`` artifact: ``{"schema_version", "ledger": {...}}``
    (``bench compare``'s ``load_artifact`` understands this shape)."""
    if decisions is None:
        decisions = elastic_decisions(ledger.run_dir)
    extra = {"elastic": {"decisions": decisions}} if decisions else {}
    if ledger.categories.get("stall", 0.0) > 1e-9:
        cause = _stall_attribution(ledger.run_dir)
        if cause is not None:
            extra["stall_attribution"] = {
                "rule": cause["rule"],
                "title": cause["title"],
                "message": cause["message"],
            }
    return {
        "schema_version": LEDGER_SCHEMA_VERSION,
        "type": "goodput_ledger",
        "ledger": {
            "run_dir": ledger.run_dir,
            "run_id": ledger.run_id,
            "strategy": ledger.strategy,
            "device_kind": ledger.device_kind,
            "torch_version": ledger.torch_version,
            "git_commit": ledger.git_commit,
            "git_dirty": ledger.git_dirty,
            "elapsed_s": ledger.elapsed_s,
            "goodput_fraction": ledger.goodput_fraction,
            "category_seconds": dict(ledger.categories),
            "category_presence": ledger.category_presence,
            "exit_counts": ledger.exit_counts,
            "incarnations": [e.to_json() for e in ledger.incarnations],
            "total_steps": ledger.total_steps,
            "replayed_steps": ledger.replayed_steps,
            "throughput": {
                "total_images": ledger.total_images,
                "replayed_images": ledger.replayed_images,
                "raw_images_per_sec": ledger.raw_images_per_sec,
                "effective_images_per_sec":
                    ledger.effective_images_per_sec,
            },
            "n_failures": ledger.n_failures,
            "mtbf_s": ledger.mtbf_s,
            "checkpoint": {
                "count": ledger.checkpoint_count,
                "median_cost_s": ledger.checkpoint_cost_s,
            },
            "recommendation": ledger.recommendation,
            "notes": list(ledger.notes),
            **extra,
        },
    }


def _stall_attribution(run_dir: str) -> Optional[dict]:
    """The ``stall`` bucket's cause: the top diagnose verdict (DIA rule
    registry, docs/diagnose.md) when one exists. Report-only — the
    taxonomy's sum-to-elapsed identity is untouched; this merely NAMES
    what the already-booked stall seconds were."""
    try:
        from tpu_ddp_torch.diagnose.rules import likely_cause

        return likely_cause(run_dir)
    except Exception:
        return None


def _data_wait_note(run_dir: str) -> str:
    """The ``data_wait`` row's pointer from *how much* input wait to
    *which stage* to fix: when the run carries staged datapath spans
    (docs/data.md), name the dominant stage inline so the badput table
    hands off straight to ``tpu-ddp-torch data report``."""
    try:
        from tpu_ddp_torch.datapath.report import datapath_measured

        measured = datapath_measured(run_dir)
    except (FileNotFoundError, ValueError, OSError):
        return ""
    stage = (measured or {}).get("dominant_stage")
    if not stage:
        return ""
    return f"  <- dominant stage: {stage} (tpu-ddp-torch data report)"


def _fmt_s(v: Optional[float]) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    if v >= 120:
        return f"{v / 60:.1f}m"
    return f"{v:.1f}s"


def _render_decision(record: dict) -> str:
    event = record.get("event")
    inc = record.get("incarnation")
    if event == "launch":
        plan = record.get("plan") or {}
        devices = plan.get("n_devices") or "all"
        return f"launch incarnation {inc}: {devices} device(s)"
    if event == "exit":
        return (f"incarnation {inc} exited "
                f"{record.get('exit_class')}: supervision complete")
    if event == "stop":
        return (f"STOP after incarnation {inc} "
                f"({record.get('exit_class', '-')}): "
                f"{record.get('reason')}")
    if event == "restart":
        plan = record.get("plan") or {}
        recovery = record.get("recovery") or {}
        mesh = plan.get("mesh")
        mesh_text = (
            " mesh " + ",".join(f"{k}={v}" for k, v in mesh.items())
            if mesh else "")
        parts = [
            f"restart -> incarnation {inc}: after "
            f"{record.get('exit_class')!r} "
            f"(attempt {record.get('attempt')}), backoff "
            f"{record.get('backoff_s', 0):.2f}s, re-mesh -> "
            f"{plan.get('n_devices') or 'all'} device(s)"
            f"{mesh_text}, resume step {recovery.get('resume_step')}"
        ]
        if plan.get("candidate_name"):
            parts.append(
                f"fallback candidate {plan['candidate_name']!r}")
        if record.get("remesh_refusal"):
            parts.append(f"shrink refused: {record['remesh_refusal']}")
        for refusal in recovery.get("refused") or []:
            parts.append(
                f"checkpoint step {refusal.get('step')} refused by "
                "manifest")
        return "; ".join(parts)
    return f"{event}: {json.dumps(record, sort_keys=True)[:120]}"


def render_ledger(ledger: RunLedger,
                  decisions: Optional[List[dict]] = None) -> str:
    lines: List[str] = []
    label = [f"goodput: {ledger.run_dir}"]
    if ledger.run_id:
        label.append(f"run_id={ledger.run_id}")
    if ledger.strategy:
        label.append(f"strategy={ledger.strategy}")
    label.append(f"incarnations={len(ledger.incarnations)}")
    lines.append("  ".join(label))
    prod = ledger.categories.get("productive", 0.0)
    lines.append(
        f"goodput {ledger.goodput_fraction:.1%} — {prod:.1f}s productive "
        f"of {ledger.elapsed_s:.1f}s elapsed wall-clock")
    lines.append("")

    header = (f"{'inc':>4} {'start':>8} {'wall':>8} {'steps':>12} "
              f"{'exit':<12} {'gap_before':>10} {'replayed':>9}")
    lines += ["incarnation timeline:", header, "-" * len(header)]
    for e in ledger.incarnations:
        span = ("-" if e.first_step is None
                else f"{e.first_step}..{e.executed_through}")
        lines.append(
            f"{e.index:>4} {'+' + _fmt_s(e.start_offset_s):>8} "
            f"{_fmt_s(e.elapsed_s):>8} {span:>12} {e.exit:<12} "
            f"{_fmt_s(e.restart_gap_before_s) if e.index else '-':>10} "
            f"{e.replayed_steps if e.replayed_steps else '-':>9}")
    lines.append("")

    header = f"{'category':<38} {'seconds':>9} {'share':>7}"
    lines += ["badput breakdown (sums to elapsed):", header,
              "-" * len(header)]
    total = 0.0
    for cat in CATEGORIES:
        secs = ledger.categories.get(cat.name, 0.0)
        total += secs
        if secs <= 1e-9 and cat.name != "productive":
            continue
        share = secs / ledger.elapsed_s if ledger.elapsed_s else 0.0
        note = (_data_wait_note(ledger.run_dir)
                if cat.name == "data_wait" and secs > 1e-9 else "")
        if cat.name == "stall" and secs > 1e-9:
            cause = _stall_attribution(ledger.run_dir)
            if cause is not None:
                note = (f"  <- {cause['rule']}: {cause['message']} "
                        "(tpu-ddp-torch diagnose)")
        lines.append(f"{cat.title:<38} {secs:>9.2f} {share:>7.1%}{note}")
    lines.append("-" * len(header))
    total_share = total / ledger.elapsed_s if ledger.elapsed_s else 0.0
    lines.append(f"{'total (= elapsed wall-clock)':<38} {total:>9.2f} "
                 f"{total_share:>7.1%}")
    lines.append("")

    if ledger.raw_images_per_sec is not None:
        eff = ledger.effective_images_per_sec
        lines.append(
            f"throughput: raw {ledger.raw_images_per_sec:.1f} img/s, "
            f"effective {eff:.1f} img/s"
            + (f" (discounting {ledger.replayed_steps} replayed "
               f"step(s) / {ledger.replayed_images:.0f} images)"
               if ledger.replayed_steps else " (nothing replayed)"))
    if ledger.mtbf_s is not None:
        lines.append(
            f"MTBF: {_fmt_s(ledger.mtbf_s)} over "
            f"{ledger.n_failures} failure(s)")
    else:
        lines.append("MTBF: not measurable (no failed incarnation)")

    rec = ledger.recommendation
    if rec:
        lines.append(
            f"checkpoint advisor (Young–Daly): save cost "
            f"{rec['checkpoint_cost_s']:.2f}s, MTBF "
            f"{_fmt_s(rec['mtbf_s'])} -> optimal interval "
            f"~{_fmt_s(rec['optimal_interval_s'])}"
            + (f" (~--checkpoint-steps "
               f"{rec['optimal_interval_steps']})"
               if rec.get("optimal_interval_steps") else ""))
        if rec.get("current_interval_s"):
            lines.append(
                f"  current cadence ~{_fmt_s(rec['current_interval_s'])}"
                f": {rec['verdict']}")
        else:
            lines.append(f"  {rec['verdict']}")
    else:
        missing = ("no checkpoint observed"
                   if not ledger.checkpoint_cost_s
                   else "no failure observed")
        lines.append(
            f"checkpoint advisor: no recommendation ({missing} — both "
            "a measured save cost and a measured MTBF are required)")
    if decisions is None:
        decisions = elastic_decisions(ledger.run_dir)
    if decisions:
        lines.append("")
        lines.append("elastic decisions (elastic.jsonl — every "
                     "restart_gap above is one of these):")
        for record in decisions:
            lines.append(f"  {_render_decision(record)}")
    for note in ledger.notes:
        lines.append(f"note: {note}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch goodput",
        description="cross-incarnation goodput/badput ledger over a run "
                    "dir's telemetry artifacts (docs/goodput.md)",
    )
    ap.add_argument("path", help="run dir (the --telemetry-dir of the "
                                 "logical run, any number of "
                                 "incarnations)")
    ap.add_argument("--json", action="store_true",
                    help="emit the schema-versioned ledger artifact "
                         "(gate it with `tpu-ddp-torch bench compare`)")
    args = ap.parse_args(list(argv) if argv is not None else None)
    try:
        ledger = build_ledger(stitch_run(args.path))
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch goodput: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(ledger_json(ledger), indent=1))
    else:
        print(render_ledger(ledger))
    return 0


if __name__ == "__main__":
    sys.exit(main())
