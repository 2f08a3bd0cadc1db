"""``tpu-ddp-torch profile <run_dir>`` — render capture bundles into verdicts.

The port's copy of ``tpu_ddp/profiler/report.py``: the same text and
``--json`` report. Reads the bundles a run's
:class:`~tpu_ddp_torch.profiler.capture.CaptureManager` wrote under
``<run_dir>/profiles/`` and renders, per bundle: the trigger provenance
(which alert/config/POST armed it), the window's measured per-phase
times, the host sampler's top stacks (the frame burning the time), the
device-trace note/path, and the per-op attribution table
(``profiler/device.py``, which gives its degrade note in the port).

Given bundles from **two or more hosts** it also computes the straggler
diff: the frames the flagged host's self-time profile shows that the
fleet median doesn't. The flagged host comes from ``--host``, else the
alert provenance recorded in a bundle, else the host whose frame-share
vector diverges most from the fleet median.

Stdlib-only, ``--no-ops`` or not: it imports neither torch nor numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from tpu_ddp_torch.profiler.capture import (
    PROFILES_DIRNAME,
    list_bundles,
    read_bundle_meta,
)
from tpu_ddp_torch.profiler.host import frame_shares, parse_folded

#: bump on breaking changes to the ``--json`` report shape
REPORT_SCHEMA_VERSION = 1

#: a frame must gain at least this much self-time share over the fleet
#: median to make the straggler diff
DIFF_MIN_SHARE_DELTA = 0.05


def find_bundle_dirs(path: str) -> List[str]:
    """Resolve a CLI target: a bundle dir itself (holds meta.json), or a
    run dir holding ``profiles/*/meta.json``."""
    if os.path.isfile(os.path.join(path, "meta.json")):
        return [path]
    if os.path.isdir(path):
        hits = [b["path"] for b in list_bundles(path)]
        if hits:
            return hits
    raise FileNotFoundError(
        f"no profile bundles under {path!r} (expected a bundle dir or a "
        f"run dir with {PROFILES_DIRNAME}/*/meta.json — arm a capture "
        "with --profile-steps, POST /profile, or the capture_profile "
        "alert action)"
    )


def read_folded(bundle_dir: str) -> Dict[str, int]:
    """The bundle's folded stacks; {} when the file is absent/empty."""
    try:
        with open(os.path.join(bundle_dir, "host_stacks.folded")) as f:
            return parse_folded(f.read())
    except OSError:
        return {}


# -- straggler diff --------------------------------------------------------

def straggler_diff(shares_by_host: Dict[int, Dict[str, float]],
                   flagged: Optional[int] = None,
                   min_delta: float = DIFF_MIN_SHARE_DELTA) -> Optional[dict]:
    """Frames the flagged host burns self time in that the fleet median
    doesn't. ``flagged=None`` picks the host whose share vector diverges
    most from the per-frame fleet median (L1). None with < 2 hosts."""
    import statistics

    if len(shares_by_host) < 2:
        return None
    frames = set()
    for shares in shares_by_host.values():
        frames.update(shares)

    def median_excluding(frame: str, host: int) -> float:
        others = [shares_by_host[h].get(frame, 0.0)
                  for h in shares_by_host if h != host]
        return statistics.median(others) if others else 0.0

    if flagged is None:
        def divergence(host: int) -> float:
            return sum(
                abs(shares_by_host[host].get(f, 0.0)
                    - median_excluding(f, host))
                for f in frames
            )

        flagged = max(sorted(shares_by_host), key=divergence)

    if flagged not in shares_by_host:
        return None
    rows = []
    for frame in frames:
        own = shares_by_host[flagged].get(frame, 0.0)
        med = median_excluding(frame, flagged)
        delta = own - med
        if delta >= min_delta:
            rows.append({"frame": frame, "share": own,
                         "fleet_median": med, "delta": delta})
    rows.sort(key=lambda r: (-r["delta"], r["frame"]))
    return {
        "host": flagged,
        "n_hosts": len(shares_by_host),
        "frames": rows,
    }


# -- rendering -------------------------------------------------------------

def _fmt_s(v: Optional[float]) -> str:
    if not isinstance(v, (int, float)):
        return "n/a"
    if v >= 1:
        return f"{v:.2f} s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f} ms"
    return f"{v * 1e6:.1f} us"


def render_bundle(bundle_dir: str, meta: dict, *, top: int = 15,
                  ops: Optional[dict] = None) -> str:
    trigger = meta.get("trigger") or {}
    window = meta.get("window") or {}
    sources = meta.get("sources") or {}
    lines = [f"profile bundle: {bundle_dir}"]
    provenance = trigger.get("source", "?")
    if trigger.get("rule"):
        scope = (f" host {trigger['host']}"
                 if trigger.get("host") is not None else "")
        provenance = f"alert {trigger['rule']}{scope}"
    lines.append(
        f"  trigger: {provenance}   window: steps "
        f"{window.get('start_step')}..{window.get('end_step')} "
        f"({window.get('steps')} step(s), "
        f"{_fmt_s(window.get('duration_s'))})   "
        f"host {meta.get('process_index')}"
    )
    host_src = sources.get("host") or {}
    device_src = sources.get("device") or {}
    device = (f"trace -> {device_src['trace_dir']}/"
              if device_src.get("trace_dir")
              else f"note: {device_src.get('note', 'n/a')}")
    lines.append(
        f"  sources: host stacks ({host_src.get('samples', 0)} samples @ "
        f"{host_src.get('hz', 0):g} Hz), device {device}"
    )
    if meta.get("note"):
        lines.append(f"  note: {meta['note']}")

    phases = meta.get("measured_phases") or {}
    if phases:
        parts = []
        for name in ("data_wait", "h2d", "compiled_step", "device_sync"):
            p = phases.get(name)
            if p:
                parts.append(f"{name} {_fmt_s(p.get('total_s'))}")
        if parts:
            lines.append("  measured in window: " + "  ".join(parts))

    lines.append("")
    folded = read_folded(bundle_dir)
    if folded:
        from tpu_ddp_torch.profiler.host import top_frames

        lines.append("host top stacks (self time):")
        for row in top_frames(folded, n=top):
            lines.append(
                f"  {row['share']:>5.0%}  {row['frame']}"
            )
    else:
        lines.append("host top stacks: no samples recorded (window "
                     "shorter than a sampler tick?)")

    if ops is not None:
        lines.append("")
        lines.extend(render_ops(ops))
    return "\n".join(lines)


def render_ops(ops: dict) -> List[str]:
    """The per-op attribution table (or its degradation note)."""
    if ops.get("note"):
        return [f"per-op attribution: note: {ops['note']}"]
    measured = ops.get("measured_step_s")
    vs = ops.get("measured_vs_model")
    lines = [
        "per-op attribution (measured "
        + (_fmt_s(measured) + "/step" if measured else "n/a")
        + (f" = {vs:.1f}x the roofline model"
           if isinstance(vs, (int, float)) else "")
        + f", chip {ops.get('chip')}):"
    ]
    header = (f"  {'op':<34} {'model':>10} {'share':>6} "
              f"{'attributed':>11}")
    lines += [header, "  " + "-" * (len(header) - 2)]
    for row in ops.get("ops") or []:
        lines.append(
            f"  {row['op']:<34} {_fmt_s(row.get('model_s')):>10} "
            f"{row.get('share', 0):>6.0%} "
            f"{_fmt_s(row.get('attributed_s')):>11}"
        )
    for note in ops.get("notes") or []:
        lines.append(f"  note: {note}")
    if not ops.get("ops"):
        lines.append("  (no rows)")
    return lines


def render_diff(diff: dict) -> List[str]:
    lines = [
        f"straggler diff: host {diff['host']} vs the other "
        f"{diff['n_hosts'] - 1} host(s)' median self-time shares:"
    ]
    if not diff["frames"]:
        lines.append("  no frame exceeds the fleet median by >= "
                     f"{DIFF_MIN_SHARE_DELTA:.0%} — the flagged host's "
                     "host-side profile matches the fleet (look at the "
                     "device trace / per-op table instead)")
        return lines
    for row in diff["frames"][:10]:
        lines.append(
            f"  +{row['delta']:>4.0%}  {row['frame']}  "
            f"(host {row['share']:.0%} vs fleet {row['fleet_median']:.0%})"
        )
    return lines


# -- CLI -------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch profile",
        description="render anomaly-profiler capture bundles: trigger "
                    "provenance, host top stacks, per-op attribution, "
                    "and a cross-host straggler diff",
    )
    ap.add_argument("path", help="run dir (holding profiles/*/) or one "
                                 "bundle dir")
    ap.add_argument("--host", type=int, default=None,
                    help="only render this host's bundles; also the "
                         "straggler-diff target")
    ap.add_argument("--top", type=int, default=15,
                    help="host stack rows per bundle")
    ap.add_argument("--chip", default=None,
                    help="chip spec for the per-op attribution (h100, "
                         "v2..v6e; default: the recorded device kind, CPU "
                         "falls back to h100 with a note)")
    ap.add_argument("--no-ops", action="store_true",
                    help="skip the per-op attribution join (stays "
                         "the anatomy join, which the port gives as a note)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full report JSON here")
    args = ap.parse_args(list(argv) if argv is not None else None)

    try:
        bundle_dirs = find_bundle_dirs(args.path)
    except (FileNotFoundError, ValueError) as e:
        print(f"tpu-ddp-torch profile: {e}", file=sys.stderr)
        return 2

    report: dict = {"schema_version": REPORT_SCHEMA_VERSION,
                    "bundles": []}
    shares_by_host: Dict[int, Dict[str, float]] = {}
    flagged_from_alert: Optional[int] = None
    rendered: List[str] = []
    for bundle_dir in bundle_dirs:
        try:
            meta = read_bundle_meta(bundle_dir)
        except ValueError as e:
            print(f"tpu-ddp-torch profile: {e}", file=sys.stderr)
            return 2
        if meta is None:
            continue
        host = meta.get("process_index", 0)
        folded = read_folded(bundle_dir)
        if folded:
            # every host feeds the diff (newest bundle per host wins),
            # even when --host narrows what gets RENDERED — the diff is
            # exactly the cross-host comparison
            shares_by_host[host] = frame_shares(folded)
        trigger = meta.get("trigger") or {}
        if trigger.get("host") is not None:
            flagged_from_alert = trigger["host"]
        if args.host is not None and host != args.host:
            continue
        ops = None
        if not args.no_ops:
            from tpu_ddp_torch.profiler.device import attribution_for_bundle

            ops = attribution_for_bundle(meta, chip=args.chip)
        rendered.append(render_bundle(bundle_dir, meta, top=args.top,
                                      ops=ops))
        report["bundles"].append({
            "path": bundle_dir, "meta": meta,
            "ops": ops,
        })

    if not rendered:
        print(f"tpu-ddp-torch profile: no readable bundles under {args.path!r}"
              + (f" for host {args.host}" if args.host is not None
                 else ""),
              file=sys.stderr)
        return 2

    print("\n\n".join(rendered), flush=True)
    diff = straggler_diff(
        shares_by_host,
        flagged=(args.host if args.host is not None
                 else flagged_from_alert),
    )
    if diff is not None:
        print(flush=True)
        print("\n".join(render_diff(diff)), flush=True)
        report["straggler_diff"] = diff

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"tpu-ddp-torch profile: wrote {args.json}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
