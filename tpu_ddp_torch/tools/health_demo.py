"""End-to-end proof of the numerics flight recorder:
``python -m tpu_ddp_torch.tools.health_demo --dir DIR [--device cpu]``.

Counterpart of ``tpu_ddp/tools/health_demo.py`` (``make health-demo``).
Trains a short run (NetResDeep, 8 channels, 2 blocks, ``--kernels``,
unshuffled) on the card, or on the CPU with ``--device cpu``, whose data
holds ONE all-NaN batch, with the recorder on and the ``skip_step``
policy:

1. the step's sentinels flag the non-finite gradients at the step the
   poison arrives, and the guard discards that update;
2. the monitor writes the one-shot anomaly dump (``DIR/anomalies/step_*/``
   with the stats, the history and the offending batch) and training goes
   on: the later steps are finite again;
3. the run dir renders with ``python -m tpu_ddp_torch.health DIR``.

Exits non-zero if any of those is missing.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="numerics health demo")
    ap.add_argument("--dir", required=True, help="run dir for the health records")
    ap.add_argument("--poison-batch", type=int, default=3,
                    help="0-based index of the batch to fill with NaNs")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
    from tpu_ddp_torch.health.summarize import summarize_health
    from tpu_ddp_torch.train.trainer import TrainConfig, Trainer

    batch, n_batches = 16, 8
    config = TrainConfig(
        device=args.device, synthetic_data=True, epochs=1, per_shard_batch=batch,
        lr=1e-2, momentum=0.9, n_chans1=8, n_blocks=2, kernels=True,
        shuffle=False,  # the poison lands where it was put
        log_every_epochs=1, health="on", health_policy="skip_step",
        health_per_layer_stride=1, health_dir=args.dir)
    images, labels = synthetic_cifar10(batch * n_batches, 10, seed=0)
    images = np.array(images)
    # unshuffled, one rank: batch b is rows [b * batch, (b + 1) * batch)
    images[args.poison_batch * batch:(args.poison_batch + 1) * batch] = np.nan
    print(f"[health-demo] {n_batches} batches of {batch} on {args.device}; batch "
          f"{args.poison_batch} poisoned with NaNs (policy skip_step)")

    trainer = Trainer(config, train_data=(images, labels))
    try:
        trainer.run()
    finally:
        trainer.close()
    finite = all(bool(torch.isfinite(p).all()) for p in trainer.state.params().values())
    monitor = trainer.health_monitor
    ok = True
    if not finite:
        print("[health-demo] FAIL: final params are not finite — the skip-step "
              "guard did not hold", file=sys.stderr)
        ok = False
    if monitor.nonfinite_steps != 1:
        print(f"[health-demo] FAIL: {monitor.nonfinite_steps} non-finite steps "
              "detected, not 1", file=sys.stderr)
        ok = False
    dumps = sorted(glob.glob(os.path.join(args.dir, "anomalies", "*", "meta.json")))
    if not dumps:
        print("[health-demo] FAIL: no anomaly dump was written", file=sys.stderr)
        ok = False
    else:
        with open(dumps[0]) as f:
            meta = json.load(f)
        dump_dir = os.path.dirname(dumps[0])
        print(f"[health-demo] anomaly dump at {dump_dir} (step {meta['step']}, "
              f"reason {meta['reason']}): {sorted(os.listdir(dump_dir))}")
        if meta["step"] != args.poison_batch:
            print(f"[health-demo] FAIL: the dump is of step {meta['step']}, not "
                  f"{args.poison_batch}", file=sys.stderr)
            ok = False
    summary = summarize_health(args.dir)
    print(summary)
    if "non-finite: 1" not in summary:
        print("[health-demo] FAIL: the summary does not show the non-finite step",
              file=sys.stderr)
        ok = False
    if ok:
        print(f"[health-demo] OK: NaN batch detected and skipped, training "
              f"recovered with finite params; inspect with: python -m "
              f"tpu_ddp_torch.health {args.dir}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
