"""One-command real CIFAR-10 pathway: download, verify, train, gate.

The port's copy of ``tpu_ddp/tools/real_data.py`` (``make real-data``):

1. fetch, MD5-verify and atomically extract the canonical CIFAR-10 tarball
   (``data/download.py``);
2. train the documented 93% recipe through the port's CLI (ResNet-18,
   random crop and flip, momentum 0.9, cosine decay, weight decay 5e-4,
   label smoothing, global batch 512, bfloat16 compute on the card);
3. gate on the final test accuracy: exit 0 with a JSON summary when it
   reaches ``--target`` (0.93), 3 on a miss, 4 when training was drained
   (re-running resumes), 2 when the fetch or the extraction failed.

Without network access step 1 fails with a message that says so. The tests
run the whole flow against a fake tarball served over ``file://``.

    python -m tpu_ddp_torch.tools.real_data [--device cpu] [--epochs N]
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="download -> verify -> train the 93% CIFAR-10 recipe -> accuracy gate")
    p.add_argument("--data-dir", default="data/CIFAR-10")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (the target; refuses to start without a GPU) or "
                        "cpu (smoke/testing)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--target", type=float, default=0.93,
                   help="final-test-accuracy gate")
    p.add_argument("--global-batch-size", type=int, default=512)
    p.add_argument("--checkpoint-dir", default="ckpt_real_data")
    p.add_argument("--out", default="real_data_summary.json")
    p.add_argument("--url", default=None,
                   help="override the canonical tarball URL (mirrors, offline tests)")
    p.add_argument("--md5", default=None, help="override with --url")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra flags appended to the training CLI verbatim "
                        "(after '--extra')")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from tpu_ddp_torch.data.download import ensure_dataset

    try:
        ensure_dataset(args.data_dir, "cifar10", download=True, url=args.url, md5=args.md5)
    except urllib.error.HTTPError as e:
        # a server that answered (404, 403, 500) is a source fault, not egress
        print(f"real-data: CIFAR-10 fetch/prepare failed after download was "
              f"attempted: {e}\nFix the source (--url/--md5 for a mirror) or "
              "local disk and re-run.", file=sys.stderr)
        return 2
    except urllib.error.URLError as e:
        print(f"real-data: could not fetch CIFAR-10 ({e}).\nThis machine has no "
              "network egress. Re-run where it has, or place "
              "cifar-10-python.tar.gz under the data dir and re-run; every later "
              "step is unattended.", file=sys.stderr)
        return 2
    except (TimeoutError, OSError) as e:
        print(f"real-data: CIFAR-10 fetch/prepare failed after download was "
              f"attempted: {e}\nFix the source (--url/--md5 for a mirror) or "
              "local disk and re-run.", file=sys.stderr)
        return 2

    from tpu_ddp_torch.cli.train import main as train_main

    cli = [
        "--device", args.device,
        "--data-dir", args.data_dir,
        "--model", "resnet18",
        "--augment", "--momentum", "0.9",
        "--schedule", "cosine", "--weight-decay", "5e-4",
        "--global-batch-size", str(args.global_batch_size),
        "--lr", "0.2",
        "--epochs", str(args.epochs),
        "--eval-each-epoch", "--label-smoothing", "0.1",
        "--checkpoint-dir", args.checkpoint_dir, "--keep-best",
        # a re-run after a drain continues from the saved step
        "--resume",
        "--jsonl", f"{args.checkpoint_dir}/metrics.jsonl",
    ]
    if args.device == "cuda":
        cli += ["--compute-dtype", "bfloat16"]
    cli += list(args.extra)
    metrics = train_main(cli)

    if metrics.get("preempted"):
        print("real-data: training was preempted; checkpoint saved under "
              f"{args.checkpoint_dir}. Re-run to resume from the saved step.",
              file=sys.stderr)
        return 4

    acc = float(metrics.get("test_accuracy", float("nan")))
    summary = {
        "recipe": "resnet18 + augment + momentum/cosine/wd + label smoothing",
        "epochs": args.epochs,
        "final_test_accuracy": acc,
        "target": args.target,
        "passed": bool(acc >= args.target),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    if not summary["passed"]:
        print(f"real-data: FINAL ACCURACY {acc:.4f} < target {args.target}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
