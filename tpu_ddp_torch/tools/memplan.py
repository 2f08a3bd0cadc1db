"""Device memory planning: will this training config fit on the card?

``python -m tpu_ddp_torch.tools.memplan --model resnet50 --batch-size 256
--compute-dtype bfloat16 [--remat] [--n-devices 4] [--device cuda]``
(the ``tpu-ddp-torch-memplan`` script)

The port's counterpart of ``tpu_ddp/tools/memplan.py``, with its report
keys (``MEMPLAN_SCHEMA_VERSION``), flags and guards. The JAX planner
compiles the step against a deviceless topology and reads XLA's memory
analysis. The port compiles no step, so ``plan()`` runs rank 0's step of
the requested configuration ONCE (``analysis/explain.py::prepare_strategy_program``;
N ranks against ``analysis/anatomy.py::fake_world``) on the device asked
for, under the graph lint's audit (``analysis/lint.py::audit_program``,
whose ``donation_report`` is the report's ``donation`` section):

- on the card the caching allocator's figures are the truth, as
  ``anatomy.count_step`` reads them: ``argument_bytes`` allocated before
  the step, ``temp_bytes`` the peak above it, ``output_bytes`` after;
- on the CPU there is no allocator: the bytes come from the anatomy's
  tracker of the tensors alive through the step (``anatomy._LiveBytes``:
  the state and the batch, then every storage the step's ops make, until
  it is freed). Each kernel then runs its plain version, so a flash
  program's plan is the plain attention's memory (the report's ``notes``
  say so): plan flash programs on the card.

The tracker runs on the card too: ``tracked`` holds its figures beside
the allocator's, and ``top_buffers`` (the counterpart of the JAX
``largest_buffers``) the largest tensors alive at its peak, with the op
that made each (``argument`` for the state and the batch, named by
section and leaf).

``est_peak_bytes = argument + temp`` (the JAX convention). A planning step
that runs out of device memory is a verdict: ``fits`` false, and the bytes
the allocator had reached when it failed, a lower bound of the step's
peak, in ``est_peak_bytes`` with a note. ``--zero1``/``--zero3`` add the
partitions' accounting (``Zero1Partition.accounting``,
``Zero3Partition.accounting``), ``--grad-compress`` the gradient wire
table (``parallel/compression.py::wire_bytes_table``). The capacity is the
chip table's (``analysis/roofline.py``; ``--chip``, default the device's
own kind). Exit 1 when the configuration does not fit.
"""

from __future__ import annotations

import argparse
import json
import sys

#: bump on any breaking change to the plan() report dict shape
MEMPLAN_SCHEMA_VERSION = 1

#: the layouts the planner runs (the JAX list)
PARALLELISMS = ("dp", "fsdp", "tp", "fsdp_tp", "pp", "ep", "sp")

#: the note of a CPU plan of a program that would run hand-written kernels
#: on the card
CPU_KERNEL_NOTE = ("planned on the CPU: each hand-written kernel ran its plain "
                   "version, so this is the plain program's memory (a flash "
                   "program's is the plain attention's); plan on the card for "
                   "the kernels' own")


def _guards(parallelism, zero1, zero3, remat, grad_accum_steps, n_devices):
    """The JAX planner's argument guards (``memplan.py:124-140,188-193``)."""
    if parallelism not in PARALLELISMS:
        raise ValueError(
            f"parallelism must be one of {PARALLELISMS}, got {parallelism!r}")
    if zero1 and parallelism != "dp":
        raise ValueError(
            "--zero1 plans the DP weight-update-sharding layout; "
            f"--parallelism {parallelism} owns its own state layout "
            "(fsdp IS ZeRO-3)")
    if zero3 and parallelism != "dp":
        raise ValueError(
            "--zero3 plans the DP parameter-streaming layout; "
            f"--parallelism {parallelism} owns its own state layout "
            "(fsdp is the GSPMD ZeRO-3 — plan it via --parallelism fsdp)")
    if zero3 and zero1:
        raise ValueError("--zero3 subsumes --zero1; pass one")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if (remat or grad_accum_steps > 1) and parallelism in ("pp", "sp"):
        raise ValueError(
            "--remat/--grad-accum-steps are not supported with "
            f"--parallelism {parallelism} (pp schedules microbatches "
            "itself; sp's ring step owns its memory story)")


def live_arguments(prog, top: int):
    """A ``_LiveBytes`` holding the step's arguments, the rank's state and
    batch (``start``), for ``audit_program`` to track the step from."""
    from tpu_ddp_torch.analysis.anatomy import _LiveBytes

    live = _LiveBytes(top)
    for section, name, t, _, _ in prog.leaves():
        live.add(t, "argument", f"{section}/{name}")
    for key, v in (prog.batch or {}).items():
        live.add(v, "argument", f"batch/{key}")
    live.start = live.live
    return live


def plan(model_name: str, per_shard_batch: int, *, compute_dtype: str,
         remat: bool, device: str = "cuda", chip: str | None = None,
         n_devices: int | None = None, momentum: float = 0.9,
         ema_decay: float = 0.0, image_size: int | None = None,
         num_classes: int | None = None, parallelism: str = "dp",
         axis_size: int | None = None, grad_accum_steps: int = 1,
         zero1: bool = False, zero3: bool = False,
         grad_compress: bool = False, grad_compress_block: int = 256,
         kernels: bool = False, attention: str = "full", seq_len: int = 4096,
         top: int = 10) -> dict:
    """Run rank 0's step of the configuration once on ``device`` and
    return the memory report (module docstring); ``top_buffers`` holds the
    ``top`` largest tensors alive at the peak. Raises on a configuration
    that cannot be built or run; a step that runs out of device memory is
    the ``fits: false`` verdict."""
    import contextlib

    import torch

    from tpu_ddp_torch.analysis.anatomy import fake_world
    from tpu_ddp_torch.analysis.explain import prepare_strategy_program
    from tpu_ddp_torch.analysis.lint import audit_program, donation_report
    from tpu_ddp_torch.analysis.roofline import chip_spec
    from tpu_ddp_torch.parallel.runtime import world_size
    from tpu_ddp_torch.runtime import resolve_device

    n = 1 if n_devices is None else n_devices
    _guards(parallelism, zero1, zero3, remat, grad_accum_steps, n)
    if image_size not in (None, 32):
        raise ValueError(f"--image-size {image_size}: the port's trainer trains "
                         "32x32 images (CIFAR's)")
    num_classes = 10 if num_classes is None else num_classes
    strategy = "zero3" if zero3 else "zero1" if zero1 else parallelism
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    notes = []
    with fake_world(n) if n > 1 and world_size() == 1 else contextlib.nullcontext():
        prog = prepare_strategy_program(
            strategy, n_devices=n, device=device, model_name=model_name,
            per_shard_batch=per_shard_batch, compute_dtype=compute_dtype,
            num_classes=num_classes, axis_size=axis_size,
            grad_accum_steps=grad_accum_steps, remat=remat, kernels=kernels,
            attention=attention, seq_len=seq_len, momentum=momentum,
            ema_decay=ema_decay, compress_block=grad_compress_block)
        try:
            zero1_report = zero3_report = grad_compress_report = None
            part = prog.zero
            if part is not None and strategy in ("zero1", "zero3"):
                acct = part.accounting()
                if zero3:
                    acct["params_bytes_per_device"] = acct["params_bytes_per_device_sharded"]
                    zero3_report = acct
                else:
                    acct["params_bytes_per_device"] = sum(
                        s.size * 4 for s in part.param_slots.values())   # replicated
                    zero1_report = acct
            if grad_compress:
                from tpu_ddp_torch.parallel.compression import wire_bytes_table

                template = (part.param_slots if part is not None
                            else {name: t for section, name, t, _, _ in prog.leaves()
                                  if section == "params"})
                grad_compress_report = wire_bytes_table(template, prog.mesh["data"],
                                                        block=grad_compress_block)
            live = live_arguments(prog, top)
            try:
                audit = audit_program(prog, live=live)
            except torch.cuda.OutOfMemoryError:
                # the verdict: the step does not fit; what the allocator had
                # reached is a lower bound of its peak
                reached = torch.cuda.max_memory_allocated(dev) if cuda else live.peak
                notes.append(f"the planning step ran out of device memory: "
                             f"{reached} B allocated when it failed, a lower "
                             "bound of the step's peak")
                audit = None
        finally:
            if prog.close is not None:
                prog.close()
    if cuda:
        torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    tracked = {"argument_bytes": live.start, "output_bytes": live.live,
               "temp_bytes": live.peak - live.start, "est_peak_bytes": live.peak}
    if audit is None:
        arg = out = temp = donation = None
        peak = reached
    elif cuda:
        a = audit.anatomy
        arg, out, temp = a.argument_bytes, a.output_bytes, a.temp_bytes
        peak = arg + temp
    else:
        arg, out, temp = (tracked[k] for k in ("argument_bytes", "output_bytes",
                                               "temp_bytes"))
        peak = arg + temp
        if kernels or attention == "flash":
            notes.append(CPU_KERNEL_NOTE)
    if audit is not None:
        donation = donation_report(audit)
    spec = chip_spec(chip or kind)
    hbm = spec.hbm_bytes if spec else None
    fits = False if audit is None else (peak < hbm if hbm else None)
    report_parallelism = ("dp+zero3" if zero3 else "dp+zero1" if zero1 else parallelism)
    return {
        "memplan_schema_version": MEMPLAN_SCHEMA_VERSION,
        "model": model_name,
        "parallelism": report_parallelism,
        "zero1": zero1_report,
        "zero3": zero3_report,
        "grad_compress": grad_compress_report,
        "mesh": dict(prog.mesh),
        "image_size": 32,
        "num_classes": num_classes,
        "per_shard_batch": per_shard_batch,
        "n_devices": n,
        "compute_dtype": compute_dtype,
        "remat": remat,
        "grad_accum_steps": grad_accum_steps,
        "device_kind": kind,
        "per_device": {
            "argument_bytes": arg,
            "output_bytes": out,
            "temp_bytes": temp,
            "est_peak_bytes": peak,
        },
        "donation": donation,
        "hbm_bytes": hbm,
        "fits": fits,
        "hbm_fraction": round(peak / hbm, 4) if hbm else None,
        "top_buffers": list(live.at_peak),
        "source": "allocator" if cuda else "tracker",
        "tracked": tracked,
        "notes": notes,
    }


def main(argv=None) -> int:
    from tpu_ddp_torch.analysis.explain import LM_MODELS
    from tpu_ddp_torch.models import MODEL_REGISTRY

    p = argparse.ArgumentParser(description="device memory planner (one step that runs)")
    p.add_argument("--model", default="netresdeep",
                   choices=["netresdeep"] + sorted(MODEL_REGISTRY) + sorted(LM_MODELS))
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-shard batch (rows for lm_32k)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--remat", action="store_true",
                   help="plan with rematerialization (composes with "
                        "dp/fsdp/tp/fsdp_tp/ep)")
    p.add_argument("--grad-accum-steps", type=int, default=1,
                   help="plan with gradient accumulation (composes with "
                        "dp/fsdp/tp/fsdp_tp/ep)")
    p.add_argument("--parallelism", choices=list(PARALLELISMS), default="dp",
                   help="fsdp = ZeRO-3 state scatter (argument_bytes shows "
                        "the 1/N shrink); tp/fsdp_tp/pp/ep/sp plan the "
                        "sharded layouts on a data x axis grid")
    p.add_argument("--zero1", action="store_true",
                   help="plan the DP step with ZeRO-1 weight-update "
                        "sharding: the report gains a 'zero1' section "
                        "with replicated vs per-device-sharded optimizer-"
                        "state bytes, and argument_bytes shows the 1/N "
                        "shrink — run with and without to diff")
    p.add_argument("--zero3", action="store_true",
                   help="plan the DP step with ZeRO-3 parameter "
                        "streaming: the report gains a 'zero3' section "
                        "with replicated vs per-device-sharded param+"
                        "optimizer bytes AND the prefetch double-buffer "
                        "high-water")
    p.add_argument("--grad-compress", action="store_true",
                   help="add the static per-step gradient wire-bytes table "
                        "(f32 vs bf16 vs block-scaled int8, plain-DP "
                        "all-reduce vs ZeRO-1 reduce-scatter) to the report")
    p.add_argument("--grad-compress-block", type=int, default=256,
                   help="int8 scale-block size for the wire table")
    p.add_argument("--axis-size", type=int, default=None,
                   help="size of the non-data grid axis for "
                        "tp/fsdp_tp/pp/ep/sp (default: 2 for pp, sp, tp and "
                        "fsdp_tp, else min(4, n))")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="plan with a parameter-EMA shadow (another "
                        "param-sized opt_state tree)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the planning step runs (default cuda: the "
                        "allocator's figures; cpu: the live-tensor tracker's)")
    p.add_argument("--chip", default=None,
                   help="chip spec whose capacity the plan is held to (h100, "
                        "v5e...; default: the device's own kind)")
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks of the program (rank 0's step runs against a "
                        "group that does not communicate; default 1)")
    p.add_argument("--image-size", type=int, default=None,
                   help="input side length (the port trains 32x32 only)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="default 10")
    p.add_argument("--kernels", action="store_true",
                   help="the optimizer update through K1 (and the int8 ring's "
                        "codec through K2/K3)")
    p.add_argument("--attention", default="full", choices=["full", "flash"],
                   help="attention models: flash runs K4-K6")
    p.add_argument("--seq-len", type=int, default=4096,
                   help="tokens a row for --model lm_32k")
    p.add_argument("--json", default=None, metavar="OUT.json",
                   help="also write the schema-versioned report here")
    args = p.parse_args(argv)
    report = plan(
        args.model, args.batch_size, compute_dtype=args.compute_dtype,
        remat=args.remat, device=args.device, chip=args.chip,
        n_devices=args.n_devices, momentum=args.momentum,
        ema_decay=args.ema_decay, image_size=args.image_size,
        num_classes=args.num_classes, parallelism=args.parallelism,
        axis_size=args.axis_size, grad_accum_steps=args.grad_accum_steps,
        zero1=args.zero1, zero3=args.zero3,
        grad_compress=args.grad_compress,
        grad_compress_block=args.grad_compress_block, kernels=args.kernels,
        attention=args.attention, seq_len=args.seq_len,
    )
    print(json.dumps(report, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"memplan: wrote {args.json}", file=sys.stderr)
    if report["fits"] is False:
        frac = report["hbm_fraction"]
        print(f"memplan: DOES NOT FIT ("
              + (f"{frac:.1%} of " if frac is not None else "out of memory on ")
              + f"{report['device_kind']} device memory)", file=sys.stderr)
        sys.exit(1)  # preflight scripts must be able to gate on the verdict
    return 0


if __name__ == "__main__":
    main()
