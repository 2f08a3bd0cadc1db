"""``tpu-ddp-torch curves`` — render, judge, and diff learning curves.

Two forms, house exit semantics throughout (0 clean / 1 findings or
drift / 2 unusable-or-refused):

- ``tpu-ddp-torch curves <run_dir> [--against <registry>] [--json]`` —
  extract the run's curve (sparkline, eval history); with ``--against``
  build the seed band from archived kind-"curves" registry entries
  sharing the run's quality digest and judge it (CRV findings with fix
  hints, exit 1 on any). ``--json`` emits the schema-versioned artifact
  the perf registry records and ``bench compare`` gates.
- ``tpu-ddp-torch curves diff <A> <B> [--tolerance]`` — step-aligned A/B
  parity verdict; each side is a run dir or a ``--json`` artifact.

Stdlib-only end to end, like every read-back CLI in-tree.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional, Sequence

from tpu_ddp_torch.curves.bands import BandConfig, band_from_registry, judge_curve
from tpu_ddp_torch.curves.diff import diff_curves, render_diff
from tpu_ddp_torch.curves.extract import curve_artifact, extract_curve, load_curve


def _load_side(path: str, stride: int) -> dict:
    """A diff operand: a run dir (extracted live) or an artifact file."""
    if os.path.isdir(path):
        return extract_curve(path, stride=stride)
    return load_curve(path)


def render_curve(curve: dict) -> List[str]:
    """The human-readable curve block (shared by the judged and
    unjudged renders)."""
    from tpu_ddp_torch.health.summarize import sparkline
    from tpu_ddp_torch.telemetry.summarize import format_eval_series

    label = [f"curves: {curve.get('run_dir')}"]
    if curve.get("run_id"):
        label.append(f"run_id={curve['run_id']}")
    if curve.get("quality_digest"):
        label.append(f"quality={curve['quality_digest']}")
    if curve.get("seed") is not None:
        label.append(f"seed={curve['seed']}")
    if curve.get("strategy"):
        label.append(f"strategy={curve['strategy']}")
    lines = ["  ".join(label)]
    steps = curve.get("steps") or []
    lines.append(
        f"steps: {curve.get('total_steps', 0)} total, {len(steps)} "
        f"sampled (stride {curve.get('stride', 1)})   incarnations: "
        f"{curve.get('incarnations', 1)}   non-finite: "
        f"{curve.get('nonfinite_steps', 0)}")
    loss = curve.get("loss") or []
    finite = [v for v in loss
              if isinstance(v, (int, float)) and math.isfinite(v)]
    if finite:
        lines.append(
            f"loss      |{sparkline(loss)}|  first {finite[0]:.4f} -> "
            f"final {finite[-1]:.4f} (min {min(finite):.4f})")
    gn = curve.get("grad_norm") or []
    if any(isinstance(v, (int, float)) for v in gn):
        lines.append(f"grad_norm |{sparkline(gn)}|")
    if curve.get("target_loss") is not None:
        ttt = curve.get("time_to_target_steps")
        lines.append(
            f"target loss {curve['target_loss']:.4f}: "
            + (f"reached at step {ttt}" if ttt is not None
               else "never reached"))
    lines.extend(format_eval_series(curve.get("eval_points") or []))
    for note in curve.get("notes") or []:
        lines.append(f"note: {note}")
    return lines


def _run_judge(args) -> int:
    try:
        curve = extract_curve(args.path, stride=args.stride)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch curves: {e}", file=sys.stderr)
        return 2
    findings = []
    band = None
    cfg = BandConfig(k=args.k, exit_window=args.window,
                     min_runs=args.min_runs)
    try:
        cfg.validate()
    except ValueError as e:
        print(f"tpu-ddp-torch curves: {e}", file=sys.stderr)
        return 2
    if args.against:
        band_key = args.band_quality or curve.get("quality_digest")
        band, refusal = band_from_registry(
            args.against,
            quality_digest=band_key,
            device_kind=curve.get("device_kind"),
            config=cfg,
            exclude_run_id=curve.get("run_id"),
            allow_dirty=args.allow_dirty,
        )
        if band is None:
            print(f"tpu-ddp-torch curves: no seed band: {refusal}",
                  file=sys.stderr)
            return 2
        if args.band_quality and \
                args.band_quality != curve.get("quality_digest"):
            curve.setdefault("notes", []).append(
                f"judged against the {args.band_quality} band by "
                "explicit --band-quality: the candidate's own recipe "
                f"digest is {curve.get('quality_digest')} (deliberate "
                "cross-recipe canary)")
        findings = judge_curve(curve, band, cfg)

    if args.json:
        art = curve_artifact(curve)
        if band is not None:
            art["findings"] = [f.to_json() for f in findings]
            art["band"] = {
                "quality_digest": band.quality_digest,
                "n_runs": band.n_runs,
                "run_ids": band.run_ids,
                "k": cfg.k,
                "exit_window": cfg.exit_window,
            }
        print(json.dumps(art, indent=1))
    else:
        lines = render_curve(curve)
        if band is not None:
            lines.append("")
            lines.append(
                f"seed band: {band.n_runs} baseline run(s), quality "
                f"{band.quality_digest}, device "
                f"{band.device_kind or '?'}")
            for note in band.notes:
                lines.append(f"  note: {note}")
            if findings:
                lines.append(f"findings ({len(findings)}):")
                for f in findings:
                    lines.append("  " + f.render().replace("\n", "\n  "))
                lines.append("verdict: FAIL (trajectory regressed vs "
                             "the seed band)")
            else:
                lines.append("verdict: PASS (within the seed band)")
        print("\n".join(lines))
    return 1 if findings else 0


def _run_diff(args) -> int:
    try:
        a = _load_side(args.a, args.stride)
        b = _load_side(args.b, args.stride)
        result = diff_curves(a, b, tolerance=args.tolerance,
                             eval_tolerance=args.eval_tolerance,
                             smooth_window=args.smooth_window)
    except (FileNotFoundError, ValueError, json.JSONDecodeError) as e:
        print(f"tpu-ddp-torch curves diff: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        print(render_diff(result, args.a, args.b))
    return 1 if result["verdict"] == "fail" else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["diff"]:
        ap = argparse.ArgumentParser(
            prog="tpu-ddp-torch curves diff",
            description="step-aligned A/B learning-curve parity verdict "
                        "(docs/curves.md); exits 1 on drift beyond "
                        "tolerance",
        )
        ap.add_argument("a", help="baseline run dir or curves --json "
                                  "artifact")
        ap.add_argument("b", help="candidate run dir or artifact")
        ap.add_argument("--tolerance", type=float, default=0.05,
                        help="max absolute SMOOTHED train-loss "
                             "trajectory drift (default 0.05)")
        ap.add_argument("--eval-tolerance", type=float, default=None,
                        help="max final eval-loss drift (default 3x "
                             "--tolerance: one eval point carries more "
                             "variance than the smoothed curve)")
        ap.add_argument("--smooth-window", type=int, default=5,
                        help="rolling-mean window (sampled points) the "
                             "trajectory gate smooths over")
        ap.add_argument("--stride", type=int, default=1,
                        help="sampling stride when extracting run dirs")
        ap.add_argument("--json", action="store_true",
                        help="emit the verdict as JSON")
        return _run_diff(ap.parse_args(argv[1:]))

    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch curves",
        description="learning-curve extraction and seed-band trajectory "
                    "gating over a run dir's health + trace records "
                    "(docs/curves.md). Also: tpu-ddp-torch curves diff A B",
    )
    ap.add_argument("path", help="run dir (needs --health on records; "
                                 "--telemetry-dir for provenance/evals)")
    ap.add_argument("--against", default=None, metavar="REGISTRY_DIR",
                    help="judge against the seed band built from "
                         "archived kind-'curves' registry entries "
                         "sharing this run's quality digest (exit 1 on "
                         "any CRV finding, 2 with a named refusal when "
                         "no band can be built)")
    ap.add_argument("--allow-dirty", action="store_true",
                    help="with --against: accept baselines recorded "
                         "from a dirty working tree")
    ap.add_argument("--band-quality", default=None, metavar="DIGEST",
                    help="with --against: judge against THIS recipe's "
                         "band instead of the candidate's own quality "
                         "digest — the deliberate cross-recipe canary "
                         "('how far outside the production band is "
                         "this lr/schedule change?'); the mismatch is "
                         "noted in the report")
    ap.add_argument("--stride", type=int, default=1,
                    help="sample every Nth recorded step (the last "
                         "step always rides along)")
    ap.add_argument("--k", type=float, default=6.0,
                    help="seed-envelope half-width in (floored) MADs")
    ap.add_argument("--window", type=int, default=3, metavar="W",
                    help="CRV002: consecutive sampled points outside "
                         "the envelope before the loss-exit rule fires")
    ap.add_argument("--min-runs", type=int, default=3,
                    help="baseline runs required to build a band")
    ap.add_argument("--json", action="store_true",
                    help="emit the schema-versioned curve artifact "
                         "(registry-recordable; bench-compare-gateable)")
    return _run_judge(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
