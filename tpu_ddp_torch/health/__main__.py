"""``python -m tpu_ddp_torch.health DIR``: print a run dir's health timeline
(the JAX CLI's ``tpu-ddp health DIR``, ``tpu_ddp/cli/main.py:19``). Exits
2 when the dir holds no health record or one of a newer schema."""

import argparse
import sys

from tpu_ddp_torch.health.summarize import summarize_health


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_ddp_torch.health",
                                 description="render a run's numerics-health record")
    ap.add_argument("path", help="run dir (health-p*.jsonl + anomalies/) or one health JSONL")
    args = ap.parse_args(argv)
    try:
        print(summarize_health(args.path))
    except (FileNotFoundError, ValueError) as e:
        print(f"python -m tpu_ddp_torch.health: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
