"""``tpu-ddp-torch data`` — bench / audit / report.

Counterpart of ``tpu_ddp/datapath/cli.py``, with its arguments, output and
exit codes (0, 1 a finding, 2 a refusal):

- ``bench`` — microbenchmark each loader stage standalone over a synthetic
  CIFAR-shaped dataset and emit the schema-versioned data artifact
  (``--json``; ``registry record`` classifies it as kind ``"data"``,
  ``bench compare`` gates its per-stage throughput, the DAT001 alert reads
  it as its baseline). ``--device`` (default ``cuda``, the port's flag)
  is the h2d stage's target; ``--device cpu`` skips that stage.
- ``audit`` — the cross-incarnation batch-provenance verdict for a run
  dir: every step two lives both recorded must carry the same content
  digest; fail-closed naming the first diverging step (exit 1), exit 2
  when there is nothing to audit.
- ``report`` — decompose a run's measured ``data_wait`` into the
  per-stage verdict (exit 2 when the run left no staged evidence).

``audit`` and ``report`` import neither torch nor numpy.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def _cmd_bench(args) -> int:
    from tpu_ddp_torch.datapath.microbench import (
        bench_artifact,
        format_bench,
        run_stage_bench,
    )

    if args.n < 1 or args.batch < 1 or args.reps < 1 or args.world_size < 1:
        print("tpu-ddp-torch data bench: --n/--batch/--reps/--world-size must be "
              "positive", file=sys.stderr)
        return 2
    progress = None
    if not args.json:
        def progress(stage, seconds):
            print(f"  {stage}: {seconds * 1e3:.3f} ms/batch", flush=True)
    stages, skipped, headline = run_stage_bench(
        n=args.n,
        world_size=args.world_size,
        per_shard_batch=args.batch,
        reps=args.reps,
        seed=args.seed,
        h2d=not args.no_h2d,
        device=args.device,
        progress=progress,
    )
    art = bench_artifact(
        stages, skipped, headline,
        n=args.n, world_size=args.world_size,
        per_shard_batch=args.batch, reps=args.reps,
    )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=2, sort_keys=True)
    if args.json:
        print(json.dumps(art, indent=2, sort_keys=True))
        return 0
    print(format_bench(art))
    if args.out:
        print(f"artifact -> {args.out}")
    return 0


def _cmd_audit(args) -> int:
    from tpu_ddp_torch.datapath.audit import audit_digests, format_audit

    verdict = audit_digests(args.run_dir)
    if args.json:
        print(json.dumps(verdict, indent=2, sort_keys=True))
    else:
        print(format_audit(verdict))
    if verdict["ok"] is None:
        return 2
    return 0 if verdict["ok"] else 1


def _cmd_report(args) -> int:
    from tpu_ddp_torch.datapath.report import format_datapath_measured, report_run

    try:
        rec = report_run(args.run_dir)
    except (FileNotFoundError, ValueError) as e:
        # future-schema trace artifacts and unreadable run dirs are
        # refusals, not findings
        print(f"tpu-ddp-torch data report: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(rec, indent=2, sort_keys=True))
        return 0 if rec["ok"] else 2
    if not rec["ok"]:
        print(f"tpu-ddp-torch data report: {rec['error']}", file=sys.stderr)
        return 2
    print(f"data report: {args.run_dir}")
    for line in format_datapath_measured(rec):
        print(line)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch data",
        description="per-stage loader microbenchmarks, batch-provenance "
                    "determinism audit, and measured input-pipeline "
                    "attribution",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser(
        "bench", help="microbenchmark each loader stage standalone and "
                      "emit the kind-'data' baseline artifact")
    b.add_argument("--n", type=int, default=4096,
                   help="synthetic dataset size (samples)")
    b.add_argument("--batch", type=int, default=256,
                   help="per-shard batch size")
    b.add_argument("--world-size", type=int, default=1,
                   help="sampler world size (devices)")
    b.add_argument("--reps", type=int, default=20,
                   help="timed repetitions per stage (min wins)")
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--no-h2d", action="store_true",
                   help="skip the host-to-device stage")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the h2d stage's device (default cuda: a GPU is "
                        "required unless --device cpu, which skips the "
                        "stage)")
    b.add_argument("--json", action="store_true",
                   help="emit the full artifact JSON on stdout")
    b.add_argument("--out", default=None, metavar="PATH",
                   help="also write the artifact to PATH")
    b.set_defaults(fn=_cmd_bench)

    a = sub.add_parser(
        "audit", help="verify replayed steps across incarnations saw "
                      "identical batches (fail-closed by digest)")
    a.add_argument("run_dir", help="run dir holding data-p*.jsonl digest "
                                   "sinks")
    a.add_argument("--json", action="store_true")
    a.set_defaults(fn=_cmd_audit)

    r = sub.add_parser(
        "report", help="decompose a run's measured data_wait into the "
                       "per-stage verdict")
    r.add_argument("run_dir", help="telemetry run dir")
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=_cmd_report)

    args = ap.parse_args(list(argv) if argv is not None else None)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
