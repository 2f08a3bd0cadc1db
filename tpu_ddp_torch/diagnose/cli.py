"""``tpu-ddp-torch diagnose <run_dir>`` — the cross-observatory root-cause CLI.

Exit codes follow the house convention: 0 no suspect, 1 at least one
verdict (a finding), 2 refusal — the run dir is missing, an artifact
is from a future schema, or no evidence family loaded at all.
Stdlib-only (neither torch nor numpy imports).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch diagnose",
        description="join every observatory's artifacts for a run dir "
                    "into one root-cause verdict with citations "
                    "(docs/diagnose.md)",
    )
    ap.add_argument("run_dir", help="the run's --telemetry-dir")
    ap.add_argument("--against", default=None, metavar="REGISTRY",
                    help="perf-registry workspace to count as an "
                         "evidence source (docs/registry.md)")
    ap.add_argument("--json", action="store_true",
                    help="emit the schema-versioned diagnose artifact "
                         "on stdout (registry record ingests it as "
                         "kind 'diagnose'; bench compare gates its "
                         "suspect classes)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the artifact to PATH")
    args = ap.parse_args(list(argv) if argv is not None else None)

    from tpu_ddp_torch.diagnose.evidence import gather_evidence
    from tpu_ddp_torch.diagnose.report import build_artifact, render_report
    from tpu_ddp_torch.diagnose.rules import diagnose

    try:
        ev = gather_evidence(args.run_dir, registry_dir=args.against)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch diagnose: {e}", file=sys.stderr)
        return 2
    if not any(s.ok for s in ev.sources.values()):
        print(f"tpu-ddp-torch diagnose: no evidence family loaded from "
              f"{args.run_dir}:", file=sys.stderr)
        for refusal in ev.refusals:
            print(f"  {refusal['source']}: {refusal['reason']}",
                  file=sys.stderr)
        return 2
    verdicts = diagnose(ev)
    art = build_artifact(ev, verdicts)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
    if args.json:
        print(json.dumps(art, indent=1, sort_keys=True))
    else:
        print(render_report(ev, verdicts))
    return 1 if verdicts else 0


if __name__ == "__main__":
    sys.exit(main())
