"""``tpu-ddp-torch ops`` — bench / calibrate the hand-written kernels.

Counterpart of ``tpu_ddp/ops/cli.py``, with its flags, output and exit
codes:

- ``bench`` — measure K2 (``fused_quant``), K3 (``fused_dequant``) and K1
  (``fused_update``) against their plain PyTorch versions
  (``ops/microbench.py``), gate the in-bench bit-parity check (exit 1
  naming any failing kernel), fit the per-kernel cost lines, and emit the
  schema-versioned ops artifact (``--json``; ``registry record``
  classifies it as kind ``"ops"``, ``bench compare`` gates it).
  ``--device`` (default ``cuda``) is the port's: ``cpu`` times plain
  against plain and says so.
- ``calibrate`` — assemble the per-chip kernel cost model from artifact
  files + registry evidence. Wrong-chip evidence is ignored by
  construction; an unknown chip exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def _cmd_bench(args) -> int:
    from tpu_ddp_torch.ops.microbench import (
        CPU_NOTE,
        DEFAULT_SIZES,
        bench_artifact,
        run_sweeps,
    )
    from tpu_ddp_torch.runtime import resolve_device

    device = resolve_device(args.device)     # no card: raise, never fall back

    kernels = tuple(args.kernels.split(",")) if args.kernels else None
    sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes \
        else DEFAULT_SIZES
    kwargs = {}
    if kernels:
        kwargs["kernels"] = kernels
    progress = None
    if not args.json:
        def progress(row):
            ratio = (row["xla_s"] / row["fused_s"]
                     if row["fused_s"] > 0 else 0.0)
            print(f"  {row['kernel']:<16} n={row['elements']:<8} "
                  f"fused {row['fused_s'] * 1e6:9.0f}us   "
                  f"plain {row['xla_s'] * 1e6:9.0f}us   "
                  f"x{ratio:.2f}"
                  + ("" if row["parity_ok"] else "   PARITY FAIL"),
                  flush=True)
    sweeps, skipped = run_sweeps(
        sizes=sizes, reps=args.reps, block=args.block,
        corrupt=args.corrupt, progress=progress, device=device, **kwargs)
    art = bench_artifact(sweeps, skipped, reps=args.reps, device=device)
    ops = art["ops"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=2, sort_keys=True)
    if args.json:
        print(json.dumps(art, indent=2, sort_keys=True))
    else:
        print(f"ops bench: chip {ops['chip']} "
              f"(backend {ops['backend']}, reps {ops['reps']})")
        for name, k in sorted(ops["kernels"].items()):
            print(f"  {name:<16} speedup x{k['speedup']:.2f}   "
                  f"parity {'ok' if k['parity_ok'] else 'FAIL'}")
        if skipped:
            print(f"  ({len(skipped)} kernels skipped; --json lists them)")
        if ops["backend"] == "cpu":
            print(f"  note: {CPU_NOTE}")
        if args.out:
            print(f"artifact -> {args.out}")
    if not ops["parity_ok"]:
        print("tpu-ddp-torch ops bench: PARITY GATE FAILED for kernel(s) "
              + ", ".join(ops["parity_failures"])
              + " — kernel output != plain reference (the kernel switch "
                "must not ship)", file=sys.stderr)
        return 1
    return 0


def _cmd_calibrate(args) -> int:
    from tpu_ddp_torch.ops.model import ops_model_for_chip

    try:
        model = ops_model_for_chip(
            args.chip, sources=args.sources, registry_dir=args.registry)
    except ValueError as e:
        print(f"tpu-ddp-torch ops calibrate: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({
            "chip": model.chip, "source": model.source,
            "samples": model.samples, "kernels": model.kernels_json(),
        }, indent=2, sort_keys=True))
        return 0
    if not model:
        print(f"ops calibrate: no applicable evidence for chip "
              f"{model.chip} (sources={list(args.sources)}, "
              f"registry={args.registry or 'none'}) — a tuner prices the "
              "kernel switch as a no-op")
        return 0
    print(f"ops model for chip {model.chip} "
          f"({model.samples} samples, source {model.source}):")
    for name, kc in sorted(model.kernels.items()):
        sv = kc.savings_s(65536)
        print(f"  {name:<16} fused {kc.fused.alpha_s * 1e6:8.1f}us + "
              f"{kc.fused.s_per_elem * 1e9:8.3f} ns/elem   "
              f"savings@64k {sv * 1e6:+9.1f}us   "
              f"parity {'ok' if kc.parity_ok else 'FAIL'}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch ops",
        description="hand-written kernels: measured kernel-vs-plain "
                    "microbenchmarks with a bit-parity gate, and the "
                    "per-chip kernel cost model that prices the "
                    "--kernels switch",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser(
        "bench", help="measure each kernel against its plain version "
                      "and gate bit-parity (exit 1 names any failure)")
    b.add_argument("--kernels", default=None,
                   help="comma list to restrict: fused_quant,"
                        "fused_dequant,fused_update")
    b.add_argument("--sizes", default=None,
                   help="comma list of element counts "
                        "(default 8192,65536)")
    b.add_argument("--reps", type=int, default=3,
                   help="timed repetitions per point (min wins)")
    b.add_argument("--block", type=int, default=256,
                   help="int8 scale-block size for the quant kernels")
    b.add_argument("--corrupt", default=None, metavar="KERNEL",
                   help=argparse.SUPPRESS)  # gate proof: deliberately
    # perturb KERNEL's output so the parity gate provably trips
    b.add_argument("--json", action="store_true",
                   help="emit the full artifact JSON on stdout")
    b.add_argument("--out", default=None, metavar="PATH",
                   help="also write the artifact to PATH")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the kernels run (default cuda: a GPU is "
                        "required unless --device cpu, which times the "
                        "plain versions on both sides)")
    b.set_defaults(fn=_cmd_bench)

    c = sub.add_parser(
        "calibrate", help="assemble the per-chip kernel cost model from "
                          "artifact + registry evidence")
    c.add_argument("--chip", required=True,
                   help="target chip kind (CHIP_SPECS key or device "
                        "kind string, e.g. h100)")
    c.add_argument("sources", nargs="*", metavar="ops-bench.json",
                   help="ops bench artifact files")
    c.add_argument("--registry", default=None, metavar="DIR",
                   help="also use ops-kind registry entries")
    c.add_argument("--json", action="store_true")
    c.set_defaults(fn=_cmd_calibrate)

    args = ap.parse_args(list(argv) if argv is not None else None)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
