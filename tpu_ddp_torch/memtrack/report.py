"""``tpu-ddp-torch mem <run_dir>`` — render the memory truth loop.

The port's copy of ``tpu_ddp/memtrack/report.py``: the same text and
``--json`` artifact (``torch_version`` for ``jax_version`` in its
provenance). Text mode is the operator surface: the per-host memory
timeline sparkline (worst-device bytes-in-use over samples), the
measured-vs-planned table, fragmentation/host-RSS lines, and every OOM
postmortem bundle.

``--json`` emits the schema-versioned, registry-recordable artifact
(``"type": "memtrack"``, ``registry/store.py``): the measured high-water
gates through ``bench compare`` as a size, and a fresh ``oom_count``
gates exactly. The planned side waits for the port's static plan
(``memtrack/postmortem.py``), so its fields are null with a note.

Exit codes: 0 clean, 1 when the run recorded an OOM postmortem, 2
unusable run dir. Stdlib-only, with or without ``--no-plan``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Sequence

from tpu_ddp_torch.memtrack.postmortem import attach_plan, list_postmortems
from tpu_ddp_torch.memtrack.reconcile import measured_summary, reconcile
from tpu_ddp_torch.memtrack.sampler import MEM_SCHEMA_VERSION


def _human_bytes(n) -> str:
    if not isinstance(n, (int, float)):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f} B" if unit == "B" else f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} GiB"


def mem_json(run_dir: str, *, chip: Optional[str] = None,
             expect_strategy: Optional[str] = None,
             with_plan: bool = True) -> dict:
    """The ``--json`` artifact. Raises ``FileNotFoundError``/
    ``ValueError`` exactly where the text mode would exit 2."""
    measured = measured_summary(run_dir)
    booms = list_postmortems(run_dir)
    rec = None
    notes: List[str] = []
    try:
        if with_plan:
            rec = reconcile(run_dir, chip=chip,
                            expect_strategy=expect_strategy,
                            measured=measured)
        else:
            notes.append("plan join skipped (--no-plan)")
    except ValueError:
        raise            # join-contract refusals propagate (exit 2)
    except FileNotFoundError as e:
        notes.append(f"no run-metadata join: {e}")
    mem = {
        "run_dir": run_dir,
        "run_id": (rec or {}).get("run_id")
        or (measured["run_ids"][0] if measured["run_ids"] else None),
        "strategy": (rec or {}).get("strategy"),
        "device_kind": (rec or {}).get("device_kind"),
        "chip": (rec or {}).get("chip"),
        "n_hosts": measured["n_hosts"],
        "measured_high_water_bytes": measured["high_water_bytes"],
        "bytes_limit": (rec or {}).get("bytes_limit")
        or measured["bytes_limit"],
        "high_water_frac": (rec or {}).get("high_water_frac")
        or measured["high_water_frac"],
        # "peak_bytes" on purpose: the PLANNED peak under the name the
        # compare gate already sizes (memplan/anatomy convention)
        "peak_bytes": ((rec or {}).get("planned") or {}).get("peak_bytes"),
        "planned": (rec or {}).get("planned"),
        "measured_over_planned": (rec or {}).get("measured_over_planned"),
        "calibratable": (rec or {}).get("calibratable", False),
        "fragmentation_bytes": max(
            (h["fragmentation_bytes"]
             for h in measured["hosts"].values()
             if h["fragmentation_bytes"] is not None), default=None),
        "host_rss_max_bytes": max(
            (h["host_rss_max_bytes"]
             for h in measured["hosts"].values()
             if h["host_rss_max_bytes"] is not None), default=None),
        "oom_count": len(booms),
        "hosts": {
            str(pid): {k: (v[-120:] if k in ("series", "steps") else v)
                       for k, v in h.items()}
            for pid, h in measured["hosts"].items()
        },
        "notes": notes + list((rec or {}).get("notes") or []),
    }
    oom = [{k: v for k, v in b.items() if k != "samples"}
           for b in booms]
    meta = next(
        (h.get("run_meta") for h in measured["headers"]
         if h.get("run_meta")), None) or {}
    from tpu_ddp_torch.telemetry import artifact_provenance

    provenance = artifact_provenance(
        descriptor={"artifact": "memtrack", "run_dir": run_dir},
        run_id=mem["run_id"],
        device_kind=mem["device_kind"] or meta.get("device_kind"),
        torch_version=meta.get("torch_version"),
        strategy=mem["strategy"] or meta.get("strategy"),
        mesh=meta.get("mesh"),
    )
    art = {
        "mem_schema_version": MEM_SCHEMA_VERSION,
        "type": "memtrack",
        "mem": mem,
        "oom": oom,
        "provenance": provenance,
    }
    if meta:
        art["run_meta"] = meta
    return art


def render(art: dict) -> str:
    from tpu_ddp_torch.health.summarize import sparkline

    mem = art["mem"]
    lines: List[str] = []
    label = [f"mem: {mem['run_dir']}"]
    for key in ("run_id", "strategy", "device_kind"):
        if mem.get(key):
            label.append(f"{key}={mem[key]}")
    lines.append("  ".join(label))
    frac = mem.get("high_water_frac")
    lines.append(
        f"measured high-water {_human_bytes(mem['measured_high_water_bytes'])}"
        f" (worst chip) of limit {_human_bytes(mem['bytes_limit'])}"
        + (f" ({frac:.0%})" if isinstance(frac, (int, float)) else "")
    )
    extras = []
    if mem.get("fragmentation_bytes") is not None:
        extras.append("fragmentation (peak-over-current) "
                      f"{_human_bytes(mem['fragmentation_bytes'])}")
    if mem.get("host_rss_max_bytes") is not None:
        extras.append(f"host RSS max {_human_bytes(mem['host_rss_max_bytes'])}")
    if extras:
        lines.append("  ".join(extras))
    lines.append("")
    for pid, h in sorted(mem.get("hosts", {}).items(),
                         key=lambda kv: int(kv[0])):
        series = h.get("series") or []
        lines.append(
            f"host {pid} |{sparkline(series)}| "
            f"({h.get('samples')} sample(s), source {h.get('source')})")
    lines.append("")

    planned = mem.get("planned")
    header = f"{'measured vs planned':<34} {'bytes':>14}"
    lines += [header, "-" * len(header)]
    if planned:
        lines.append(f"{'planned peak (args+temp)':<34} "
                     f"{planned['peak_bytes']:>14}")
        lines.append(f"{'  arguments':<34} "
                     f"{planned['argument_bytes']:>14}")
        lines.append(f"{'  temp (activations/workspace)':<34} "
                     f"{planned['temp_bytes']:>14}")
    else:
        lines.append(f"{'planned peak':<34} {'-':>14}")
    hw = mem.get("measured_high_water_bytes")
    lines.append(f"{'measured high-water':<34} "
                 f"{hw if hw is not None else '-':>14}")
    ratio = mem.get("measured_over_planned")
    lines.append(
        f"{'measured / planned':<34} "
        + (f"{ratio:>14.4f}" if isinstance(ratio, (int, float))
           else f"{'-':>14}")
        + (f"  (chip {mem['chip']})" if mem.get("chip") else "")
    )
    if planned and planned.get("top_buffers"):
        lines.append("top planned buffers:")
        for b in planned["top_buffers"][:8]:
            shape = "x".join(str(d) for d in b.get("shape") or []) or "()"
            lines.append(
                f"  {_human_bytes(b['bytes']):>12}  {b['dtype']}[{shape}] "
                f"{b['op']} ({b['name']})")

    oom = art.get("oom") or []
    lines.append("")
    if oom:
        lines.append(f"OOM postmortems ({len(oom)}):")
        for b in oom:
            lines.append(
                f"  step {b.get('step')} host {b.get('process_index')} "
                f"(incarnation {b.get('incarnation')}): "
                f"{b.get('error_type')}: "
                f"{(b.get('error') or '')[:100]}")
            lines.append(f"    bundle: {b.get('path')}")
            plan = b.get("plan")
            if plan and plan.get("top_buffers"):
                top = plan["top_buffers"][0]
                lines.append(
                    f"    largest planned buffer: "
                    f"{_human_bytes(top['bytes'])} {top['dtype']} "
                    f"{top['op']}")
    else:
        lines.append("OOM postmortems: none")
    for note in mem.get("notes") or []:
        lines.append(f"note: {note}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch mem",
        description="live-memory truth loop over a run dir: timeline, "
                    "measured-vs-planned reconciliation, OOM "
                    "postmortems",
    )
    ap.add_argument("path", help="run dir (the --telemetry-dir of a run "
                                 "that sampled memory)")
    ap.add_argument("--chip", default=None,
                    help="chip spec key for limits/ratio attribution "
                         "(default: the run's recorded device kind)")
    ap.add_argument("--strategy", default=None,
                    help="refuse the join unless the recorded strategy "
                         "matches (the analyze join contract)")
    ap.add_argument("--no-plan", action="store_true",
                    help="skip the static-plan join (the port's plan "
                         "side is a note until its rebuild lands)")
    ap.add_argument("--json", action="store_true",
                    help="emit the schema-versioned artifact "
                         "(perf-registry-recordable; gate with "
                         "`tpu-ddp-torch bench compare`)")
    args = ap.parse_args(list(argv) if argv is not None else None)
    if not args.no_plan:
        # attach the static plan to any OOM bundle that lacks one —
        # the rebuild-at-report-time half of the postmortem contract.
        # A bare glob, not list_postmortems: attach_plan reads only the
        # two files it needs, and mem_json parses the bundles once
        import glob
        import os

        for bundle in sorted(glob.glob(
                os.path.join(args.path, "oom", "*"))):
            attach_plan(bundle)
    try:
        art = mem_json(args.path, chip=args.chip,
                       expect_strategy=args.strategy,
                       with_plan=not args.no_plan)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch mem: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(art, indent=1))
    else:
        print(render(art))
    return 1 if art["mem"]["oom_count"] else 0


if __name__ == "__main__":
    sys.exit(main())
