"""Reduce a run dir into one schema-versioned learning-curve record.

The port's copy of ``tpu_ddp/curves/extract.py``: the same record, with
``torch_version`` for ``jax_version``.

The evidence already exists — PR 2's health sinks record per-step
loss/grad-norm, PR 13's eval instants anchor every evaluation in the
trace, and the run-metadata header carries provenance — but it is
scattered across per-incarnation files and dies unaggregated. This
module is the one reducer:

- **health** (``health-p0[.i<k>].jsonl``, host 0 — the stats are
  replicated, so one host is the fleet's trajectory): per-step loss /
  grad-norm / finiteness, merged across incarnations with
  later-life-wins per step (a resume REPLAYS steps from its checkpoint;
  the surviving trajectory is the one that kept training), then sampled
  at a configurable stride.
- **trace** (``trace-p0[.i<k>].jsonl``): the run-metadata header
  (run_id, the seed-invariant ``quality_digest``, seed, strategy, chip,
  commit) and the ``eval`` instants (merged later-wins per epoch, same
  replay discipline).

The output record is the unit everything downstream shares: the band
builder consumes it, ``tpu-ddp-torch curves --json`` wraps it into the
artifact the perf registry classifies as kind "curves", and ``bench
compare`` gates its ``final_eval_*`` / ``time_to_target_steps`` /
CRV-count fields. Stdlib-only.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

from tpu_ddp_torch.health.summarize import HEALTH_SCHEMA_VERSION
from tpu_ddp_torch.telemetry import parse_sink_name
from tpu_ddp_torch.telemetry.provenance import artifact_provenance
from tpu_ddp_torch.telemetry.summarize import eval_points, read_records

#: bump on any breaking change to the LearningCurve record shape;
#: ``load_curve`` refuses artifacts from the future
CURVES_SCHEMA_VERSION = 1


def _sink_files(run_dir: str, prefix: str,
                process_index: int = 0) -> List[Tuple[int, str]]:
    """Sorted ``[(incarnation, path)]`` of one host's sink family —
    every life of the run, oldest first (the merge order later-wins
    depends on)."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(run_dir):
        return out
    for name in os.listdir(run_dir):
        parsed = parse_sink_name(name, prefix=prefix)
        if parsed is None or parsed[3] != "jsonl":
            continue
        _, pid, inc, _ = parsed
        if pid == process_index:
            out.append((inc, os.path.join(run_dir, name)))
    return sorted(out)


def extract_curve(run_dir: str, *, stride: int = 1,
                  process_index: int = 0) -> dict:
    """The run dir's learning curve as a plain JSON-ready record.

    Raises ``FileNotFoundError`` with a pointed message when the run
    recorded no health sinks (the per-step loss source), ``ValueError``
    on a bad stride or a future health/trace schema.
    """
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    health_files = _sink_files(run_dir, "health", process_index)
    if not health_files:
        raise FileNotFoundError(
            f"no health record under {run_dir!r} (expected "
            "health-p*.jsonl — learning curves need the per-step loss "
            "the numerics flight recorder writes; run with --health on)"
        )

    # later-incarnation-wins per step: replayed steps are overwritten by
    # the life that actually kept their updates
    by_step: Dict[int, dict] = {}
    nonfinite = 0
    for _, path in health_files:
        for rec in read_records([path],
                                schema_version=HEALTH_SCHEMA_VERSION,
                                kind="health"):
            if rec.get("type") != "health":
                continue
            step = rec.get("step")
            if not isinstance(step, int):
                continue
            prev = by_step.get(step)
            if prev is not None and prev.get("all_finite", True) is False:
                nonfinite -= 1  # replaced by the replaying life's record
            if rec.get("all_finite", True) is False:
                nonfinite += 1
            by_step[step] = rec

    steps_all = sorted(by_step)
    # sampled at the stride, but the LAST step always rides along: the
    # final loss is the one point every downstream judgment needs
    idx = list(range(0, len(steps_all), stride))
    if idx and idx[-1] != len(steps_all) - 1:
        idx.append(len(steps_all) - 1)
    sampled = [steps_all[i] for i in idx]

    def _num(v) -> Optional[float]:
        return float(v) if isinstance(v, (int, float)) else None

    loss = [_num(by_step[s].get("loss")) for s in sampled]
    grad_norm = [_num(by_step[s].get("grad_norm")) for s in sampled]

    # trace side: provenance header + eval history, all incarnations in
    # order (the eval merge is later-wins per epoch, like the steps)
    run_meta: Optional[dict] = None
    trace_records: List[dict] = []
    trace_files = _sink_files(run_dir, "trace", process_index)
    for _, path in trace_files:
        trace_records.extend(read_records([path]))
    for rec in trace_records:
        if rec.get("type") == "header" and isinstance(
                rec.get("run_meta"), dict):
            run_meta = rec["run_meta"]
            break
    evals = eval_points(trace_records)

    notes: List[str] = []
    if run_meta is None:
        notes.append(
            "no run-metadata header in the trace (anonymous run): the "
            "curve carries no run_id/quality_digest and cannot join a "
            "seed band")
    meta = run_meta or {}
    cfg = meta.get("config") or {}

    def _last_eval(key: str) -> Optional[float]:
        # newest point carrying the metric: the final-eval instant may
        # record accuracy only (bce runs: loss only), while the last
        # epoch point has the other — each metric falls back separately
        ordered = sorted(
            evals, key=lambda p: ((p.get("step")
                                   if isinstance(p.get("step"), int)
                                   else -1), p.get("final") or False))
        for p in reversed(ordered):
            v = p.get(key)
            if isinstance(v, (int, float)) and math.isfinite(v):
                return float(v)
        return None

    finite_losses = [v for v in loss
                     if isinstance(v, (int, float)) and math.isfinite(v)]

    curve = {
        "curves_schema_version": CURVES_SCHEMA_VERSION,
        "run_dir": os.path.abspath(run_dir),
        "run_id": meta.get("run_id"),
        "quality_digest": meta.get("quality_digest"),
        "seed": cfg.get("seed"),
        "strategy": meta.get("strategy"),
        "device_kind": meta.get("device_kind"),
        "torch_version": meta.get("torch_version"),
        "git_commit": meta.get("git_commit"),
        "git_dirty": meta.get("git_dirty"),
        "stride": stride,
        "incarnations": len(health_files),
        "total_steps": len(steps_all),
        "steps": sampled,
        "loss": loss,
        "grad_norm": grad_norm,
        "nonfinite_steps": nonfinite,
        "eval_points": evals,
        "final_train_loss": finite_losses[-1] if finite_losses else None,
        "final_eval_loss": _last_eval("test_loss"),
        "final_eval_accuracy": _last_eval("test_accuracy"),
        # set by a band judgment (bands.judge_curve) or --target-loss:
        "target_loss": None,
        "time_to_target_steps": None,
        "notes": notes,
    }
    return curve


def curve_artifact(curve: dict) -> dict:
    """Wrap a curve record into the ``--json`` artifact shape the perf
    registry records and ``bench compare`` normalizes.

    The embedded provenance deliberately sets ``config_digest`` to the
    QUALITY digest (falling back to run_id): the registry series/
    baseline key for the curves family is the seed-invariant recipe, so
    N seeded runs of one recipe pool into ONE band series instead of N
    singleton series keyed by their seed-folding run_ids."""
    prov = artifact_provenance(
        run_id=curve.get("run_id"),
        quality_digest=curve.get("quality_digest"),
        device_kind=curve.get("device_kind"),
        torch_version=curve.get("torch_version"),
        strategy=curve.get("strategy"),
    )
    if curve.get("quality_digest"):
        prov["config_digest"] = curve["quality_digest"]
    # the curve was extracted from a recorded run: its commit identity
    # is the RUN's, not the probing tool's
    if curve.get("git_commit") is not None:
        prov["git_commit"] = curve["git_commit"]
        prov["git_dirty"] = curve.get("git_dirty")
    return {
        "curves_schema_version": CURVES_SCHEMA_VERSION,
        "type": "learning_curve",
        "curve": curve,
        "provenance": prov,
    }


def load_curve(path: str) -> dict:
    """Read a ``tpu-ddp-torch curves --json`` artifact back into its curve
    record; refuses artifacts from a future schema so an old tool can't
    silently misjudge new fields."""
    with open(path) as f:
        art = json.load(f)
    if not isinstance(art, dict) or not isinstance(art.get("curve"), dict):
        raise ValueError(
            f"{path}: not a learning-curve artifact (expected a "
            "'curve' object — `tpu-ddp-torch curves <run_dir> --json`)")
    version = art.get("curves_schema_version")
    if isinstance(version, int) and version > CURVES_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: curves_schema_version {version} is newer than "
            f"this tool understands ({CURVES_SCHEMA_VERSION})")
    return art["curve"]
