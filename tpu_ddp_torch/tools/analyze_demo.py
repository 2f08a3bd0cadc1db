"""End-to-end proof of the step anatomy:
``python -m tpu_ddp_torch.tools.analyze_demo --dir DIR [--device cpu]``.

Counterpart of ``tpu_ddp/tools/analyze_demo.py`` (``make analyze-demo``),
on the card by default (``--device cpu`` runs the kernels' plain versions
over gloo ranks), in four acts:

1. a short training run with telemetry on, over two gloo ranks through the
   port's launcher (NetResDeep, 8 channels, 2 blocks, the int8 ring with
   ``--kernels``), so the run dir carries the run-metadata header, the
   measured per-phase spans and a collective inventory (one JAX process
   drives its eight devices; a port rank is a process);
2. ``tpu-ddp-torch analyze <run_dir>`` must rebuild the run's program from
   the header on the device it recorded, classify the roofline bound,
   render the collective inventory and join the measured phases; the
   run's ``diagnose`` must not refuse the dir;
3. every strategy's step must match its pinned collective fingerprint
   (rank 0 of a fake group of ``--n-devices``);
4. the ``bench compare`` gate must gate: a self-compare passes, and a copy
   of the analyze artifact with an injected extra all-gather, and one with
   a payload widened to f32, each exit nonzero.

Exits non-zero if any outcome is missing.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

#: act 1's run: steps of the epoch a rank, the ranks
STEPS, RANKS = 4, 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="step-time anatomy demo")
    ap.add_argument("--dir", required=True, help="run dir for telemetry")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--chip", default="h100",
                    help="chip spec to classify the bound against")
    ap.add_argument("--n-devices", type=int, default=8,
                    help="ranks of act 3's static programs")
    args = ap.parse_args(argv)

    from tpu_ddp_torch.analysis.explain import (
        STRATEGIES,
        anatomy_for_strategy,
        check_fingerprint,
    )
    from tpu_ddp_torch.analysis.explain import main as analyze_main
    from tpu_ddp_torch.analysis.regress import main as compare_main
    from tpu_ddp_torch.diagnose.cli import main as diagnose_main

    ok = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))

    # -- 1. a real (tiny) training run with telemetry ---------------------
    cmd = [sys.executable, "-m", "tpu_ddp_torch.cli.launch", "--nproc-per-node",
           str(RANKS), "--", sys.executable, "-m", "tpu_ddp_torch.cli.train",
           "--device", args.device, "--dist-backend", "gloo", "--synthetic-data",
           "--synthetic-size", str(RANKS * 8 * STEPS), "--epochs", "1",
           "--batch-size", "8", "--n-chans1", "8", "--n-blocks", "2",
           "--n-devices", str(RANKS), "--prefetch-depth", "0", "--kernels",
           "--grad-compress", "int8", "--log-every-epochs", "1",
           "--telemetry-dir", args.dir]
    print(f"[analyze-demo] training 1 epoch on {RANKS} gloo ranks, {args.device} "
          f"(telemetry -> {args.dir})", flush=True)
    rc = subprocess.run(cmd, env=env, cwd=root).returncode
    if rc != 0:
        print(f"[analyze-demo] FAIL: the training run exited {rc}", file=sys.stderr)
        return 1

    # -- 2. analyze the run dir (metadata header -> rebuild -> join) ------
    artifact = os.path.join(args.dir, "analyze.json")
    rc = analyze_main([args.dir, "--chip", args.chip, "--json", artifact])
    if rc != 0:
        print(f"[analyze-demo] FAIL: tpu-ddp-torch analyze exited {rc}",
              file=sys.stderr)
        ok = False
    else:
        with open(artifact) as f:
            payload = json.load(f)
        bound = payload["roofline"]["bound"]
        inventory = payload["anatomy"]["inventory"]
        measured = payload.get("measured", {})
        if bound not in ("compute", "hbm", "ici"):
            print(f"[analyze-demo] FAIL: bound not classified ({bound!r})",
                  file=sys.stderr)
            ok = False
        if not inventory:
            print("[analyze-demo] FAIL: empty collective inventory", file=sys.stderr)
            ok = False
        if not measured.get("step_p50_s"):
            print("[analyze-demo] FAIL: telemetry join produced no measured step "
                  "time", file=sys.stderr)
            ok = False
        if ok:
            print(f"[analyze-demo] run-dir analysis OK: bound={bound}, "
                  f"{len(inventory)} inventory entries, measured step p50 "
                  f"{measured['step_p50_s'] * 1e3:.1f} ms", flush=True)
        rc = diagnose_main([args.dir, "--out", os.path.join(args.dir, "diagnose.json")])
        if rc == 2:
            print("[analyze-demo] FAIL: tpu-ddp-torch diagnose refused the "
                  "telemetry run dir", file=sys.stderr)
            ok = False

    # -- 3. every strategy's collective fingerprint -----------------------
    failures = []
    for strategy in STRATEGIES:
        anatomy = anatomy_for_strategy(strategy, device=args.device,
                                       n_devices=args.n_devices)
        fp = check_fingerprint(anatomy)
        kinds = anatomy.collective_kinds()
        print(f"[analyze-demo] fingerprint {strategy:14} "
              f"{'OK  ' if fp['ok'] else 'FAIL'} kinds={sorted(kinds)}", flush=True)
        if not fp["ok"]:
            failures.append((strategy, fp))
    for strategy, fp in failures:
        print(f"[analyze-demo] FAIL: {strategy}: missing={fp['missing']} "
              f"unexpected={fp['unexpected']}", file=sys.stderr)
        ok = False

    # -- 4. the compare gate must gate ------------------------------------
    if not os.path.exists(artifact):
        print("[analyze-demo] FAIL: analyze wrote no artifact; compare gate not "
              "exercised", file=sys.stderr)
        return 1
    with open(artifact) as f:
        base = json.load(f)
    if compare_main([artifact, artifact]) != 0:
        print("[analyze-demo] FAIL: self-compare reported a regression",
              file=sys.stderr)
        ok = False
    extra = copy.deepcopy(base)
    extra["anatomy"]["inventory"][f"all-gather/f32/data/g{RANKS}"] = {
        "count": 3, "payload_bytes": 4 << 20, "wire_bytes": 3 << 20,
        "group_size": RANKS}
    widened = copy.deepcopy(base)
    inv = widened["anatomy"]["inventory"]
    narrow = next((k for k in inv if k.split("/")[1] in ("s8", "bf16")), None)
    if narrow is None:
        print("[analyze-demo] FAIL: the int8 run's inventory holds no narrow "
              f"payload to widen ({sorted(inv)})", file=sys.stderr)
        return 1
    kind, _, axis, group = narrow.split("/")
    inv[f"{kind}/f32/{axis}/{group}"] = inv.pop(narrow)
    for name, label, poisoned in (("extra", "an extra all-gather", extra),
                                  ("widened", f"{narrow} widened to f32", widened)):
        path = os.path.join(args.dir, f"analyze_poisoned_{name}.json")
        with open(path, "w") as f:
            json.dump(poisoned, f)
        if compare_main([artifact, path]) != 1:
            print(f"[analyze-demo] FAIL: bench compare did not flag {label}",
                  file=sys.stderr)
            ok = False
        else:
            print(f"[analyze-demo] bench compare flags {label} OK", flush=True)

    if ok:
        print(f"[analyze-demo] OK: bound classified, inventory rendered, all "
              f"{len(STRATEGIES)} strategy fingerprints hold, compare gate fires on "
              f"injected drift; inspect with: tpu-ddp-torch analyze {args.dir} "
              f"--chip {args.chip}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
