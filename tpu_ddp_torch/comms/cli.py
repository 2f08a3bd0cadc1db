"""``tpu-ddp-torch comms`` — bench / calibrate / exposure / forensics.

Counterpart of ``tpu_ddp/comms/cli.py``, with its arguments, output and
exit codes (0, 1 a finding, 2 a refusal):

- ``bench`` — measure the collective microbenchmarks over the rank grid,
  fit the per-link α-β models, and emit the schema-versioned comms
  artifact (``--json``; ``registry record`` classifies it as kind
  ``"comms"``, ``bench compare`` gates its achieved bandwidth). Each rank
  is a process: run it under ``python -m tpu_ddp_torch.cli.launch
  --nproc-per-node N``; rank 0 prints and writes. ``--device`` (default
  ``cuda``) and ``--dist-backend`` are the port's, as in the train CLI;
  ``--mesh`` names the rank grid's axes (``data=2``).
- ``calibrate`` — assemble the per-chip link model from artifact files and
  registry evidence. Wrong-chip evidence is ignored by construction.
- ``exposure`` — time a recorded dp-family program over the launched
  ranks against its one-rank twin (``comms/exposure.py``) and land the
  measured exposed comm share in the run dir; run it under the launcher
  with the recorded rank count (rank 0 prints and writes), with the port's
  ``--device`` and ``--dist-backend``.
- ``forensics`` — read a hung run's suspect collective and check it
  against the recorded program's collective schedule
  (``comms/forensics.py::join_schedule``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def _parse_mesh(spec: Optional[str]) -> dict:
    """``"data=4,model=2"`` -> {"data": 4, "model": 2}; empty -> {}."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--mesh: expected axis=size pairs, got {part!r}")
        axis, _, size = part.partition("=")
        out[axis.strip()] = int(size)
    return out


def _cmd_bench(args) -> int:
    from tpu_ddp_torch.comms.microbench import (
        DEFAULT_SIZES,
        bench_artifact,
        run_sweeps,
    )
    from tpu_ddp_torch.parallel import runtime
    from tpu_ddp_torch.parallel.mesh import create_mesh, resolve
    from tpu_ddp_torch.runtime import resolve_device

    resolve_device(args.device)       # no card: raise, never fall back
    import torch.distributed as dist

    owned = not dist.is_initialized()
    runtime.initialize_distributed(args.device, args.dist_backend)
    try:
        try:
            spec = _parse_mesh(args.mesh)
            n = 1
            for s in spec.values():
                n *= s
            if spec and n != runtime.world_size():
                raise ValueError(f"mesh {spec} needs {n} ranks; "
                                 f"{runtime.world_size()} launched")
            resolve(spec or {"data": -1}, runtime.world_size())
        except (TypeError, ValueError) as e:
            print(f"tpu-ddp-torch comms bench: {e}", file=sys.stderr)
            return 2
        mesh = create_mesh(spec or None)
        device = resolve_device(args.device)
        primary = runtime.is_primary_process()
        kinds = tuple(args.kinds.split(",")) if args.kinds else None
        dtypes = tuple(args.dtypes.split(",")) if args.dtypes else None
        ring_modes = tuple(args.ring_modes.split(",")) if args.ring_modes \
            else ("f32", "bf16", "int8")
        sizes = tuple(int(s) for s in args.sizes.split(",")) if args.sizes \
            else DEFAULT_SIZES
        kwargs = {}
        if kinds:
            kwargs["kinds"] = kinds
        if dtypes:
            kwargs["dtypes"] = dtypes
        progress = None
        if not args.json and primary:
            def progress(row):
                print(f"  {row['kind']}/{row['dtype']}/{row['axis']} "
                      f"size={row['size']}: {row['time_s'] * 1e6:.0f}us "
                      f"({row['bw_bytes_per_s'] / 1e6:.1f} MB/s on wire)",
                      flush=True)
        sweeps, skipped = run_sweeps(
            mesh, device=device, ring_modes=ring_modes, sizes=sizes,
            reps=args.reps, block=args.block, progress=progress, **kwargs)
        art = bench_artifact(mesh, sweeps, skipped, device=device, reps=args.reps)
    finally:
        if owned:
            runtime.shutdown()
    if not primary:
        return 0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(art, f, indent=2, sort_keys=True)
    if args.json:
        print(json.dumps(art, indent=2, sort_keys=True))
        return 0
    comms = art["comms"]
    print(f"comms bench: chip {comms['chip']} "
          f"({comms['n_devices']} devices, mesh {comms['mesh']})")
    for key, link in sorted(comms["links"].items()):
        print(f"  {key:<38} alpha {link['alpha_s'] * 1e6:8.1f}us   "
              f"beta {link['beta_bytes_per_s'] / 1e6:10.1f} MB/s   "
              f"achieved {link['achieved_bw_bytes_per_s'] / 1e6:10.1f} MB/s")
    if skipped:
        print(f"  ({len(skipped)} combinations skipped; --json lists them)")
    if args.out:
        print(f"artifact -> {args.out}")
    return 0


def _cmd_calibrate(args) -> int:
    from tpu_ddp_torch.comms.model import comms_model_for_chip

    try:
        model = comms_model_for_chip(
            args.chip, sources=args.sources,
            registry_dir=args.registry)
    except ValueError as e:
        print(f"tpu-ddp-torch comms calibrate: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({
            "chip": model.chip, "source": model.source,
            "samples": model.samples, "links": model.links_json(),
        }, indent=2, sort_keys=True))
        return 0
    if not model:
        print(f"comms calibrate: no applicable evidence for chip "
              f"{model.chip} (sources={list(args.sources)}, "
              f"registry={args.registry or 'none'}) — the roofline "
              "keeps its spec-sheet link bandwidth")
        return 0
    print(f"comms model for chip {model.chip} "
          f"({model.samples} samples, source {model.source}):")
    for key, ab in sorted(model.links.items()):
        print(f"  {key:<38} alpha {ab.alpha_s * 1e6:8.1f}us   "
              f"beta {ab.beta_bytes_per_s / 1e6:10.1f} MB/s")
    return 0


def _cmd_exposure(args) -> int:
    from tpu_ddp_torch.comms.exposure import measure_exposure, write_exposure
    from tpu_ddp_torch.parallel import runtime

    try:
        runtime.initialize_distributed(args.device, args.dist_backend)
        rec = measure_exposure(args.run_dir, reps=args.reps, device=args.device)
    except (OSError, ValueError) as e:
        runtime.shutdown()
        print(f"tpu-ddp-torch comms exposure: {e}", file=sys.stderr)
        return 2
    if rec is None:                   # a rank other than 0
        return 0
    if not args.no_write:
        write_exposure(args.run_dir, rec)
    if args.json:
        print(json.dumps(rec, indent=2, sort_keys=True))
        return 0
    share = rec["measured_comm_share"]
    print(f"comms exposure: {rec['strategy']} on {rec['n_devices']} "
          f"devices ({rec['device_kind']})")
    print(f"  full step      {rec['t_full_s'] * 1e3:8.2f} ms")
    print(f"  stripped twin  {rec['t_stripped_s'] * 1e3:8.2f} ms")
    print(f"  exposed comm   {rec['exposed_comm_s'] * 1e3:8.2f} ms "
          f"({share:.1%} of the step)" if share is not None else
          "  exposed comm   n/a")
    if rec.get("telemetry_step_p50_s"):
        print(f"  (run's own telemetry step p50: "
              f"{rec['telemetry_step_p50_s'] * 1e3:.2f} ms)")
    if not args.no_write:
        print(f"  -> {args.run_dir}/comms-exposure.json "
              "(analyze/summarize will join it)")
    return 0


def _cmd_forensics(args) -> int:
    import os

    from tpu_ddp_torch.comms.forensics import (
        COMMS_HEALTH_SCHEMA_VERSION,
        FORENSICS_PREFIX,
        HANG_FORENSICS_SCHEMA_VERSION,
        HEALTH_PREFIX,
        join_schedule,
        match_program_order,
        suspect_from_files,
    )

    # refusal before verdict: no comms-health/hang-forensics files at
    # all means there is nothing to judge (exit 2), distinct from
    # "monitored but no suspect" (exit 1 below)
    try:
        names = sorted(os.listdir(args.run_dir))
    except OSError as e:
        print(f"tpu-ddp-torch comms forensics: {e}", file=sys.stderr)
        return 2
    evidence = [
        n for n in names
        if (n.startswith(f"{HEALTH_PREFIX}-p")
            or n.startswith(f"{FORENSICS_PREFIX}-p"))
        and n.endswith(".json")]
    if not evidence:
        print(f"tpu-ddp-torch comms forensics: no comms-health/hang-forensics "
              f"files in {args.run_dir} — was the run started with "
              "--comms-monitor?", file=sys.stderr)
        return 2
    for name in evidence:
        try:
            with open(os.path.join(args.run_dir, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        for key, known in (
                ("comms_health_schema_version",
                 COMMS_HEALTH_SCHEMA_VERSION),
                ("hang_forensics_schema_version",
                 HANG_FORENSICS_SCHEMA_VERSION)):
            v = rec.get(key)
            if isinstance(v, int) and v > known:
                print(f"tpu-ddp-torch comms forensics: {name}: {key} {v} is "
                      "newer than this tool understands "
                      f"(knows <= {known})", file=sys.stderr)
                return 2

    suspect = suspect_from_files(args.run_dir)
    order = join_schedule(args.run_dir)
    match = match_program_order(suspect, order or [])
    rec = {
        "run_dir": args.run_dir,
        "suspect_collective": suspect,
        "program_order": order,
        "program_order_match": match,
    }
    if args.json:
        print(json.dumps(rec, indent=2, sort_keys=True))
        return 0 if suspect else 1
    if suspect is None:
        print(f"comms forensics: no suspect collective in "
              f"{args.run_dir} (the health files carry neither an "
              "in-flight hop nor a last collective)")
        return 1
    print(f"comms forensics: suspect collective {suspect['key']} "
          f"(axis {suspect.get('axis')}, source {suspect.get('source')}"
          + (f", hop {suspect['hop']}/{suspect['n_hops']}"
             if suspect.get("hop") is not None else "") + ")")
    if order is None:
        print("  program order: not rebuildable here (mesh too big or "
              "no run metadata)")
    elif match is None:
        print(f"  NOT IN SCHEDULE: the recorded program's "
              f"{len(order)} collectives do not include it — the hang "
              "was outside the recorded step program")
    else:
        print(f"  matches program-order entry #{match['index']}: "
              f"{match['entry']}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch comms",
        description="measured collective microbenchmarks, α-β link "
                    "calibration, exposed-comm attribution, and "
                    "stuck-collective forensics (docs/comms.md)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser(
        "bench", help="measure collectives over the local mesh and fit "
                      "the per-link alpha-beta model")
    b.add_argument("--mesh", default=None,
                   help="axis=size pairs, e.g. data=4 (default: data "
                        "over every launched rank)")
    b.add_argument("--kinds", default=None,
                   help="comma list to restrict: all-reduce,"
                        "reduce-scatter,all-gather,all-to-all,"
                        "collective-permute,ring-all-reduce,"
                        "ring-reduce-scatter")
    b.add_argument("--dtypes", default=None,
                   help="comma list for the stock kinds (default "
                        "f32,bf16,s8)")
    b.add_argument("--ring-modes", default=None,
                   help="comma list of ring wire modes (default "
                        "f32,bf16,int8)")
    b.add_argument("--sizes", default=None,
                   help="comma list of per-shard payload sizes in "
                        "elements (default 4096,16384,65536,262144)")
    b.add_argument("--reps", type=int, default=10,
                   help="timed repetitions per point (min wins)")
    b.add_argument("--block", type=int, default=256,
                   help="int8 ring scale-block size")
    b.add_argument("--json", action="store_true",
                   help="emit the full artifact JSON on stdout")
    b.add_argument("--out", default=None, metavar="PATH",
                   help="also write the artifact to PATH")
    b.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the ranks' device (default cuda: a GPU is "
                        "required unless --device cpu)")
    b.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend (default: nccl on "
                        "cuda, gloo on cpu)")
    b.set_defaults(fn=_cmd_bench)

    c = sub.add_parser(
        "calibrate", help="assemble the per-chip link model from "
                          "artifact + registry evidence")
    c.add_argument("--chip", required=True,
                   help="target chip kind (CHIP_SPECS key or device "
                        "kind string)")
    c.add_argument("sources", nargs="*", metavar="comms-bench.json",
                   help="comms bench artifact files")
    c.add_argument("--registry", default=None, metavar="DIR",
                   help="also use comms-kind registry entries")
    c.add_argument("--json", action="store_true")
    c.set_defaults(fn=_cmd_calibrate)

    e = sub.add_parser(
        "exposure", help="measure the non-overlapped comm share of a "
                         "recorded run (dp-family)")
    e.add_argument("run_dir", help="telemetry run dir of the recorded run")
    e.add_argument("--reps", type=int, default=10)
    e.add_argument("--no-write", action="store_true",
                   help="print only; do not land comms-exposure.json "
                        "in the run dir")
    e.add_argument("--json", action="store_true")
    e.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the ranks' device (default cuda: a GPU is "
                        "required unless --device cpu)")
    e.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend (default: nccl on "
                        "cuda, gloo on cpu)")
    e.set_defaults(fn=_cmd_exposure)

    f = sub.add_parser(
        "forensics", help="name a hung run's suspect collective and "
                          "check it against the program order")
    f.add_argument("run_dir", help="run dir of the hung run")
    f.add_argument("--json", action="store_true")
    f.set_defaults(fn=_cmd_forensics)

    args = ap.parse_args(list(argv) if argv is not None else None)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
