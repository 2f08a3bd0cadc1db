"""End-to-end proof of the graph lint gate:
``python -m tpu_ddp_torch.tools.lint_demo --dir DIR [--device cpu]``.

Counterpart of ``tpu_ddp/tools/lint_demo.py`` (``make lint-demo``), on the
card by default (``--device cpu`` runs the kernels' plain versions), as
rank 0 of a fake group of eight, as ``lint`` runs, in three acts:

1. ``tpu-ddp-torch lint --strategy all --json`` must exit 0: every
   strategy's program (the zero1 / zero3 / grad-compress layouts included)
   and the RCP001 AST tier come back clean;
2. two injected violations must trip exactly their rule ids: a step whose
   update leaves the new state in fresh tensors (an out-of-place update,
   ``train/strategy.py::StepProgram``'s ``in_place=False``) trips
   **DON001**, and a step with an ``.item()`` planted in its loss trips
   **XFR001**;
3. the lint artifact must gate through ``tpu-ddp-torch bench compare``: a
   clean self-compare passes, and a copy with one new finding count fails.

Exits non-zero if any outcome is missing.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys


def chatty_loss(logits, labels, mask=None):
    """The JAX demo's ``jax.debug.print`` in the loss, as eager PyTorch
    writes it: a host read of a device value inside the step."""
    from tpu_ddp_torch.train.losses import cross_entropy_loss

    print(f"loss input sum={logits.sum().item():.4f}", flush=True)
    return cross_entropy_loss(logits, labels, mask)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="graph lint demo")
    ap.add_argument("--dir", required=True, help="artifact dir")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="ranks of each program (rank 0 against a fake group)")
    args = ap.parse_args(argv)

    from tpu_ddp_torch.analysis.lint import lint_strategy
    from tpu_ddp_torch.analysis.lint import main as lint_main
    from tpu_ddp_torch.analysis.regress import main as compare_main

    os.makedirs(args.dir, exist_ok=True)
    ok = True
    where = dict(device=args.device, n_devices=args.n_devices)

    # -- 1. the full lint must pass clean ---------------------------------
    artifact = os.path.join(args.dir, "lint.json")
    print(f"[lint-demo] tpu-ddp-torch lint --strategy all on {args.device}, "
          f"{args.n_devices} ranks", flush=True)
    rc = lint_main(["--strategy", "all", "--json", artifact, "--device", args.device,
                    "--n-devices", str(args.n_devices)])
    if rc != 0:
        print(f"[lint-demo] FAIL: tpu-ddp-torch lint exited {rc} on the clean "
              "tree", file=sys.stderr)
        ok = False

    # -- 2. injected violations must trip their rules ---------------------
    # (a) an out-of-place update: the new state in fresh tensors, the old
    # held through the step — DON001
    findings, _ = lint_strategy("dp", in_place=False, **where)
    rules = sorted({f.rule for f in findings})
    if rules != ["DON001"]:
        print(f"[lint-demo] FAIL: an out-of-place update tripped {rules}, "
              "not exactly DON001", file=sys.stderr)
        ok = False
    else:
        print(f"[lint-demo] injected out-of-place update -> {rules} OK", flush=True)

    # (b) a planted host read: .item() inside the loss is a device->host
    # round trip per step — XFR001
    findings, _ = lint_strategy("dp", loss_fn=chatty_loss, **where)
    rules = sorted({f.rule for f in findings})
    if rules != ["XFR001"]:
        print(f"[lint-demo] FAIL: a planted .item() tripped {rules}, "
              "not exactly XFR001", file=sys.stderr)
        ok = False
    else:
        print(f"[lint-demo] injected host read -> {rules} OK", flush=True)

    # -- 3. the artifact must gate through bench compare ------------------
    if not os.path.exists(artifact):
        print("[lint-demo] FAIL: lint wrote no artifact; compare gate "
              "not exercised", file=sys.stderr)
        return 1
    if compare_main([artifact, artifact]) != 0:
        print("[lint-demo] FAIL: lint artifact self-compare regressed",
              file=sys.stderr)
        ok = False
    with open(artifact) as f:
        base = json.load(f)
    poisoned = copy.deepcopy(base)
    prog = poisoned["programs"]["dp"]
    prog["rule_counts"] = dict(prog.get("rule_counts") or {})
    prog["rule_counts"]["DON001"] = prog["rule_counts"].get("DON001", 0) + 1
    poisoned_path = os.path.join(args.dir, "lint_poisoned.json")
    with open(poisoned_path, "w") as f:
        json.dump(poisoned, f)
    if compare_main([artifact, poisoned_path]) != 1:
        print("[lint-demo] FAIL: bench compare did not flag a new lint "
              "finding", file=sys.stderr)
        ok = False

    if ok:
        print("[lint-demo] OK: all strategy programs + source tier clean, "
              "injected DON001/XFR001 violations trip their rules, and a "
              "new finding in the committed artifact fails bench compare")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
