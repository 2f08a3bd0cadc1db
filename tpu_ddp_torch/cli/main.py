"""``tpu-ddp-torch`` — the port's umbrella CLI
(``python -m tpu_ddp_torch.cli.main``).

The port's copy of ``tpu_ddp/cli/main.py`` (``tpu-ddp``), with the
subcommands whose modules the port has:

- ``tpu-ddp-torch train ...``   — the training CLI (``tpu_ddp_torch.cli.train``)
- ``tpu-ddp-torch launch ...``  — the multi-process launcher
  (``tpu_ddp_torch.cli.launch``)
- ``tpu-ddp-torch trace summarize <run_dir>`` — aggregate a telemetry JSONL
  trace into per-phase percentiles (p50/p95/max) and the final
  counters/gauges snapshot.
- ``tpu-ddp-torch health <run_dir>`` — render a monitored run's numerics
  timeline (loss/grad-norm percentiles + sparkline, non-finite and
  loss-spike steps) and any anomaly dumps.
- ``tpu-ddp-torch goodput <run_dir>`` — cross-incarnation goodput ledger:
  stitches every kill→``--resume`` life of a logical run into one
  timeline, classifies every wall-clock second into the badput taxonomy
  (restart gaps, replayed steps, stalls, checkpoint/data-wait costs), and
  recommends a Young–Daly checkpoint interval from measured save cost +
  MTBF.
- ``tpu-ddp-torch curves <run_dir>`` — the run's learning curve (per-step
  loss/grad-norm from the health sinks across every incarnation, the eval
  history from the trace); ``--against <registry>`` judges it against the
  seed band of archived runs sharing its quality digest (CRV001-004,
  exit 1 on any); ``curves diff A B`` is the step-aligned overlay-parity
  verdict.
- ``tpu-ddp-torch registry record|list|show|trend|diff`` — the cross-run
  perf results archive (one ``registry.jsonl`` either package can write
  and read).
- ``tpu-ddp-torch bench compare old.json new.json`` — structured diff of
  two artifacts; exits 1 on regressions. ``--against <registry>``
  auto-selects the baseline from the perf registry.
- ``tpu-ddp-torch watch <run_dir>`` — the live fleet monitor over a run
  dir's per-rank files: per-rank steps/sec and phase p50s, straggler and
  lost-host flags, the alert rules; ``--once --json`` for scripts (exit 1
  while an alert fires).
- ``tpu-ddp-torch profile <run_dir>`` — the capture bundles under
  ``profiles/``: trigger provenance, host top stacks, the straggler diff.
- ``tpu-ddp-torch mem <run_dir>`` — the memory record: timeline, measured
  high-water against the limit, OOM postmortems (exit 1 when one exists);
  ``--json`` is the registry's ``memtrack`` artifact.
- ``tpu-ddp-torch comms bench|calibrate|exposure|forensics`` — the comms
  observatory: the collective microbenchmarks over the ranks and their
  α-β link model, a hung run's suspect collective (``exposure`` refuses by
  name in the port).
- ``tpu-ddp-torch data bench|audit|report`` — the data-path observatory:
  the per-stage loader microbenchmarks, the cross-life batch digest
  audit, a run's per-stage ``data_wait`` verdict.

The JAX CLI's ``elastic``, ``diagnose``, ``analyze``, ``lint``, ``tune`` and
``ops`` come with their modules (ROADMAP.md, section 1).

Every subcommand but ``train``, ``launch``, ``comms bench`` and ``data
bench`` is stdlib-only end to end: it imports neither torch nor numpy, so a
run dir is read on any host, one without CUDA or torch included. The four
import lazily.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def _trace_summarize(args) -> int:
    from tpu_ddp_torch.telemetry.summarize import summarize, summarize_json

    try:
        if getattr(args, "json", False):
            import json as _json

            print(_json.dumps(summarize_json(args.path), indent=1))
        else:
            print(summarize(args.path))
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch trace summarize: {e}", file=sys.stderr)
        return 2
    return 0


def _health_summarize(args) -> int:
    from tpu_ddp_torch.health.summarize import summarize_health

    try:
        print(summarize_health(args.path))
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch health: {e}", file=sys.stderr)
        return 2
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # train/launch own their argparse surface: hand the remainder through
    # untouched so `tpu-ddp-torch train --help` shows the full trainer surface
    if argv[:1] == ["train"]:
        from tpu_ddp_torch.cli.train import main as train_main

        train_main(argv[1:])
        return 0
    if argv[:1] == ["launch"]:
        from tpu_ddp_torch.cli.launch import main as launch_main

        return launch_main(argv[1:])
    # watch, profile and mem own their argparse surfaces and are
    # stdlib-only (the joins the JAX ones make through jax are notes here)
    if argv[:1] == ["watch"]:
        from tpu_ddp_torch.monitor.watch import main as watch_main

        return watch_main(argv[1:])
    if argv[:1] == ["profile"]:
        from tpu_ddp_torch.profiler.report import main as profile_main

        return profile_main(argv[1:])
    if argv[:1] == ["mem"]:
        from tpu_ddp_torch.memtrack.report import main as mem_main

        return mem_main(argv[1:])
    # goodput is stdlib-only end to end (pure file archaeology)
    if argv[:1] == ["goodput"]:
        from tpu_ddp_torch.ledger.report import main as goodput_main

        return goodput_main(argv[1:])
    # curves is stdlib-only end to end (file archaeology + band math)
    if argv[:1] == ["curves"]:
        from tpu_ddp_torch.curves.report import main as curves_main

        return curves_main(argv[1:])
    # registry is stdlib-only too (record/list/show/trend/diff)
    if argv[:1] == ["registry"]:
        from tpu_ddp_torch.registry.cli import main as registry_main

        return registry_main(argv[1:])
    # comms and data own their argparse surfaces; their bench commands
    # import torch lazily, the rest are stdlib-only
    if argv[:1] == ["comms"]:
        from tpu_ddp_torch.comms.cli import main as comms_main

        return comms_main(argv[1:])
    if argv[:1] == ["data"]:
        from tpu_ddp_torch.datapath.cli import main as data_main

        return data_main(argv[1:])
    if argv[:2] == ["bench", "compare"]:
        from tpu_ddp_torch.analysis.regress import main as compare_main

        return compare_main(argv[2:])

    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch",
        description="tpu_ddp_torch umbrella CLI (train / launch / trace)",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    sub.add_parser("train", help="run the trainer (tpu-ddp-torch train --help)")
    sub.add_parser("launch", help="multi-process launcher "
                                  "(tpu-ddp-torch launch --help)")
    trace = sub.add_parser("trace", help="telemetry trace tools")
    trace_sub = trace.add_subparsers(dest="trace_command", required=True)
    summ = trace_sub.add_parser(
        "summarize",
        help="per-phase p50/p95 table from a run dir's JSONL trace",
    )
    summ.add_argument("path", help="run dir (holding trace-p*.jsonl) or a "
                                   "trace file")
    summ.add_argument("--json", action="store_true",
                      help="emit the schema-versioned machine summary "
                           "(perf-registry-recordable)")
    summ.set_defaults(func=_trace_summarize)
    health = sub.add_parser(
        "health",
        help="numerics timeline + anomalies from a run dir's health "
             "record (see --health on tpu-ddp-torch train)",
    )
    health.add_argument("path", help="run dir (holding health-p*.jsonl) "
                                     "or a health file")
    health.set_defaults(func=_health_summarize)
    sub.add_parser(
        "watch",
        help="live fleet monitor over a run dir: per-host steps/sec + "
             "phase p50s, straggler/lost-host flags, alert rules "
             "(tpu-ddp-torch watch --help)",
    )
    sub.add_parser(
        "profile",
        help="render anomaly-profiler capture bundles: host top stacks, "
             "per-op attribution, straggler diff "
             "(tpu-ddp-torch profile --help)",
    )
    sub.add_parser(
        "goodput",
        help="cross-incarnation goodput/badput ledger + Young–Daly "
             "checkpoint-interval advisor over a run dir "
             "(tpu-ddp-torch goodput --help)",
    )
    sub.add_parser(
        "mem",
        help="memory truth loop over a run dir: live device-memory "
             "timeline, measured-vs-planned reconciliation, OOM "
             "postmortems (tpu-ddp-torch mem --help)",
    )
    sub.add_parser(
        "curves",
        help="learning-curve extraction + seed-band trajectory gating "
             "over a run dir; `curves diff A B` for overlay parity "
             "(tpu-ddp-torch curves --help)",
    )
    sub.add_parser(
        "registry",
        help="cross-run perf results archive: record artifacts with "
             "provenance, trend-detect drift, diff entries "
             "(tpu-ddp-torch registry --help)",
    )
    sub.add_parser(
        "comms",
        help="measured collective microbenchmarks, alpha-beta link "
             "calibration and stuck-collective forensics "
             "(tpu-ddp-torch comms --help)",
    )
    sub.add_parser(
        "data",
        help="per-stage loader microbenchmarks, batch-provenance audit "
             "and measured input-pipeline attribution "
             "(tpu-ddp-torch data --help)",
    )
    bench = sub.add_parser("bench", help="bench artifact tools")
    bench_sub = bench.add_subparsers(dest="bench_command", required=True)
    bench_sub.add_parser(
        "compare",
        help="diff two bench/AOT/analyze JSON artifacts; exit 1 on "
             "regression (tpu-ddp-torch bench compare --help)",
    )
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
