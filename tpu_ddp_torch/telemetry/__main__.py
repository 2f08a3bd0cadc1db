"""``python -m tpu_ddp_torch.telemetry summarize DIR [--json]``: the per-phase
table, eval history and last counters of a run dir's traces (the JAX CLI's
``tpu-ddp trace summarize``, ``tpu_ddp/cli/main.py:128``). Exits 2 when the
dir holds no trace or one of a newer schema."""

import argparse
import json
import sys

from tpu_ddp_torch.telemetry.summarize import summarize, summarize_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_ddp_torch.telemetry",
                                 description="read a telemetry run dir")
    sub = ap.add_subparsers(dest="command", required=True)
    summ = sub.add_parser("summarize", help="per-phase percentiles of a run's traces")
    summ.add_argument("path", help="run dir (trace-p*.jsonl) or one trace JSONL")
    summ.add_argument("--json", action="store_true",
                      help="the schema-versioned machine record instead of text")
    args = ap.parse_args(argv)
    try:
        if args.json:
            print(json.dumps(summarize_json(args.path), indent=1))
        else:
            print(summarize(args.path))
    except (FileNotFoundError, ValueError) as e:
        print(f"python -m tpu_ddp_torch.telemetry summarize: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
