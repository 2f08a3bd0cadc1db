"""``tpu-ddp-torch registry`` — record / list / show / trend / diff.

The operator surface of the perf registry (docs/registry.md):

- ``record <artifact.json>`` — ingest one artifact (bench/AOT/analyze/
  lint/goodput/watch/trace-summary JSON) with a provenance stamp.
- ``list`` — one line per entry (id, when, kind, commit, config
  digest, chip).
- ``show <entry>`` — the full entry (``#N``/``#-1`` index or entry-id
  prefix).
- ``trend`` — run the REG-rule drift detector over every series; exit 1
  when any non-info finding fires ("did this commit regress? run
  `registry trend` before you bisect").
- ``diff <old> <new>`` — structured diff of two ARCHIVED entries
  through ``analysis/regress.compare`` — the exact gating semantics
  ``tpu-ddp-torch bench compare`` applies to files, with its exit codes
  (0 clean / 1 regression / 2 usage).

Every subcommand takes ``--registry DIR`` (default: $TPU_DDP_REGISTRY,
then ``./perf_registry``). Stdlib-only end to end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

from tpu_ddp_torch.registry.store import (
    default_registry_dir,
    find_entry,
    read_entries,
    record_artifact,
)
from tpu_ddp_torch.registry.trend import TrendConfig, trend_findings


def _cmd_record(args) -> int:
    try:
        entry = record_artifact(args.registry, args.artifact,
                                note=args.note)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"tpu-ddp-torch registry record: {e}", file=sys.stderr)
        return 2
    print(f"tpu-ddp-torch registry: recorded {entry.label()} "
          f"({len(entry.metrics)} metrics) -> {args.registry}")
    return 0


def _cmd_list(args) -> int:
    entries = read_entries(args.registry)
    if args.json:
        print(json.dumps({
            "registry": args.registry,
            "entries": [e.to_record() if args.full else {
                "entry_id": e.entry_id,
                "recorded_at": e.recorded_at,
                "artifact_kind": e.artifact_kind,
                "config_digest": e.config_digest,
                "device_kind": e.device_kind,
                "git_commit": e.provenance.get("git_commit"),
                "git_dirty": e.provenance.get("git_dirty"),
                "n_metrics": len(e.metrics or {}),
            } for e in entries],
        }, indent=1))
        return 0
    if not entries:
        print(f"registry {args.registry}: empty")
        return 0
    print(f"registry {args.registry}: {len(entries)} entr"
          f"{'y' if len(entries) == 1 else 'ies'}")
    for i, e in enumerate(entries):
        when = time.strftime("%Y-%m-%d %H:%M",
                             time.localtime(e.recorded_at))
        print(f"  #{i:<3} {when}  {e.label()}")
    return 0


def _cmd_show(args) -> int:
    entries = read_entries(args.registry)
    entry = find_entry(entries, args.entry)
    if entry is None:
        print(f"tpu-ddp-torch registry show: no entry matches {args.entry!r} "
              f"in {args.registry} (try `tpu-ddp-torch registry list`)",
              file=sys.stderr)
        return 2
    print(json.dumps(entry.to_record(), indent=1))
    return 0


def _cmd_trend(args) -> int:
    entries = read_entries(args.registry)
    cfg = TrendConfig(window=args.window, threshold=args.threshold,
                      min_history=args.min_history)
    findings = trend_findings(entries, cfg, metric_filter=args.metric)
    gating = [f for f in findings if f.severity != "info"]
    if args.json:
        print(json.dumps({
            "registry": args.registry,
            "n_entries": len(entries),
            "findings": [f.to_json() for f in findings],
        }, indent=1))
        return 1 if gating else 0
    print(f"registry trend: {args.registry} ({len(entries)} entries)")
    if not findings:
        print("no drift findings")
        return 0
    for f in findings:
        print(f"  {f.render()}")
    print(f"{len(gating)} gating finding(s), "
          f"{len(findings) - len(gating)} informational")
    return 1 if gating else 0


def _cmd_diff(args) -> int:
    from tpu_ddp_torch.analysis.regress import compare, render

    entries = read_entries(args.registry)
    old = find_entry(entries, args.old)
    new = find_entry(entries, args.new)
    missing = [ref for ref, e in ((args.old, old), (args.new, new))
               if e is None]
    if missing:
        print("tpu-ddp-torch registry diff: no entry matches "
              + ", ".join(repr(m) for m in missing)
              + f" in {args.registry}", file=sys.stderr)
        return 2
    result = compare(old.programs, new.programs,
                     tolerance=args.tolerance)
    print(render(result, f"registry:{old.entry_id}",
                 f"registry:{new.entry_id}"))
    return 1 if result["regressions"] else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch registry",
        description="cross-run perf results archive: record artifacts "
                    "with provenance, trend-detect drift, diff any two "
                    "entries (docs/registry.md)",
    )
    ap.add_argument("--registry", default=None,
                    help="workspace dir (default: $TPU_DDP_REGISTRY, "
                         "then ./perf_registry)")
    sub = ap.add_subparsers(dest="command", required=True)

    rec = sub.add_parser("record",
                         help="ingest one artifact JSON with a "
                              "provenance stamp")
    rec.add_argument("artifact", help="bench/AOT/analyze/lint/goodput/"
                                      "watch/trace-summary JSON file")
    rec.add_argument("--note", default=None,
                     help="free-form annotation stored on the entry")
    rec.set_defaults(func=_cmd_record)

    ls = sub.add_parser("list", help="one line per archived entry")
    ls.add_argument("--json", action="store_true")
    ls.add_argument("--full", action="store_true",
                    help="with --json: full entries, not the summary")
    ls.set_defaults(func=_cmd_list)

    show = sub.add_parser("show", help="print one full entry")
    show.add_argument("entry", help="entry-id prefix or #N / #-1 index")
    show.set_defaults(func=_cmd_show)

    trend = sub.add_parser(
        "trend",
        help="REG-rule drift detection over every (metric x config x "
             "chip) series; exit 1 on any gating finding")
    trend.add_argument("--metric", default=None,
                       help="only series whose metric name contains "
                            "this substring")
    trend.add_argument("--window", type=int, default=8,
                       help="rolling-window size (default 8)")
    trend.add_argument("--threshold", type=float, default=5.0,
                       help="k of the k*MAD drift band (default 5)")
    trend.add_argument("--min-history", type=int, default=4,
                       help="entries required before judging (default 4)")
    trend.add_argument("--json", action="store_true")
    trend.set_defaults(func=_cmd_trend)

    diff = sub.add_parser(
        "diff",
        help="regress.compare two archived entries (bench-compare exit "
             "semantics: 0 clean / 1 regression / 2 usage)")
    diff.add_argument("old", help="baseline entry (id prefix or #N)")
    diff.add_argument("new", help="candidate entry (id prefix or #N)")
    diff.add_argument("--tolerance", type=float, default=0.05,
                      help="relative growth allowed on sized metrics "
                           "(default 0.05)")
    diff.set_defaults(func=_cmd_diff)

    args = ap.parse_args(list(argv) if argv is not None else None)
    args.registry = default_registry_dir(args.registry)
    try:
        return args.func(args)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        # e.g. a future registry_schema_version refusal from
        # read_entries: a usage/environment error (exit 2), NEVER a
        # finding — `trend`'s exit 1 must mean drift, nothing else
        print(f"tpu-ddp-torch registry {args.command}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
