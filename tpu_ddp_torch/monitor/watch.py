"""``tpu-ddp-torch watch <run_dir>`` — the live terminal dashboard.

The port's copy of ``tpu_ddp/monitor/watch.py``: the same dashboard and
``--json`` report. Polls the fleet aggregator on an interval and renders:
the run label, fleet throughput, a per-host table (step, steps/s,
compiled-step p50, data-wait share, heartbeat age, straggler/lost flags),
the active alerts, and a loss sparkline from the health record. The alert
engine runs inside the watcher, so watching a run is also what *writes*
``alerts.jsonl`` (and fires the log/webhook actions).

``--once --json`` emits one schema-versioned report (snapshot + alerts)
and exits; the exit code is 1 when any alert is firing.

``--once`` also joins the top verdict of the diagnose rule registry
(``likely_cause``). ``--roofline`` joins the predicted step time of the
recorded program (``analysis/explain.py``: the step rebuilt and run once)
against the fleet's measured step, which in the port is the p50 of a
step's dispatch plus its device wait (``compiled_step`` + ``device_sync``).
Stdlib-only but for ``--roofline``, which imports torch, as the JAX watch
imports jax there alone.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from tpu_ddp_torch.monitor.aggregate import FleetAggregator, MonitorConfig
from tpu_ddp_torch.monitor.alerts import AlertEngine, alert_history, read_alerts

#: bump on breaking changes to the ``watch --json`` report shape
#: (v2: + ``history`` — resolved alert episodes from alerts.jsonl — and
#: ``profiles`` — the run's profiler capture-bundle inventory)
WATCH_SCHEMA_VERSION = 2


class _RunRecords:
    """Cached view of a run dir's DURABLE records — ``alerts.jsonl``
    episodes and the profiler capture inventory. The live watch loop
    polls every few seconds forever, and the alert log only grows:
    re-parsing it end-to-end per tick would be O(file) work per poll,
    so the parse re-runs only when the underlying files change (alert
    log size, bundle meta set)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._signature = None
        self._history: List[dict] = []
        self._profiles: List[dict] = []

    def read(self):
        try:
            alerts_size = os.path.getsize(
                os.path.join(self.run_dir, "alerts.jsonl"))
        except OSError:
            alerts_size = -1
        metas = tuple(sorted(glob.glob(
            os.path.join(self.run_dir, "profiles", "*", "meta.json"))))
        signature = (alerts_size, metas)
        if signature != self._signature:
            from tpu_ddp_torch.profiler.capture import list_bundles

            self._history = alert_history(read_alerts(self.run_dir))
            self._profiles = list_bundles(self.run_dir)
            self._signature = signature
        return self._history, self._profiles


def build_report(aggregator: FleetAggregator, engine: AlertEngine,
                 now: Optional[float] = None,
                 records: Optional[_RunRecords] = None) -> dict:
    """One poll: snapshot + alert evaluation -> the ``--json`` payload.
    Alongside the live snapshot/alerts, the report folds in the run's
    durable records: the alert HISTORY (every fired episode in
    ``alerts.jsonl``, with durations once resolved — so ``--once`` over
    a finished run shows what happened, not just what is happening) and
    the profiler capture inventory (``profiles/*/``). Pass a
    ``_RunRecords`` to amortize that parse across a live loop's polls."""
    snap = aggregator.poll(now)
    engine.evaluate(snap)
    if records is None:
        records = _RunRecords(aggregator.run_dir)
    history, profiles = records.read()
    return {
        "schema_version": WATCH_SCHEMA_VERSION,
        "snapshot": snap.to_json(),
        "alerts": [a.to_record() for a in engine.active()],
        "history": history,
        "profiles": profiles,
    }


# -- roofline join --------------------------------------------------------

def roofline_view(run_dir: str) -> Dict[str, object]:
    """Predicted per-step time + per-device flops for the recorded run,
    via the analyze rebuild (on the device the run recorded; its kind is
    ``rebuilt_on``), attributed against the chip the run recorded. Any
    failure (no torch, anonymous trace, un-rebuildable program, a card
    run read where there is no card) returns a ``note`` instead — the
    dashboard must keep rendering."""
    try:
        from tpu_ddp_torch.analysis.explain import anatomy_for_run_meta, read_run_meta
        from tpu_ddp_torch.analysis.roofline import chip_spec, roofline

        meta = read_run_meta(run_dir)
        anatomy = anatomy_for_run_meta(meta)
        kind = meta.get("device_kind") or anatomy.device_kind
        rl = roofline(anatomy, kind)
        spec = chip_spec(kind)
        return {
            "predicted_step_s": rl.predicted_step_s,
            "bound": rl.bound,
            "chip": rl.chip,
            "rebuilt_on": anatomy.device_kind,
            "flops_per_step_device": anatomy.flops,
            "peak_bf16_flops": spec.peak_bf16_flops if spec else None,
        }
    except Exception as e:  # degrade, never take the dashboard down
        return {"note": f"roofline join unavailable: {e}"}


def _join_roofline(report: dict, rl: Dict[str, object]) -> None:
    """Fold measured fleet p50 step time against the prediction into
    ``report['roofline']`` (fraction achieved + MFU when computable)."""
    out = dict(rl)
    phases = (report["snapshot"].get("fleet") or {}).get("phase_p50_s") or {}
    # the port's step: its dispatch and the wait for the card behind it
    step_s = phases.get("compiled_step")
    if step_s and phases.get("device_sync"):
        step_s += phases["device_sync"]
    pred = rl.get("predicted_step_s")
    if step_s and pred:
        out["measured_step_p50_s"] = step_s
        out["roofline_fraction"] = pred / step_s
    flops, peak = rl.get("flops_per_step_device"), rl.get("peak_bf16_flops")
    if step_s and flops and peak:
        out["mfu"] = flops / step_s / peak
    report["roofline"] = out


# -- rendering ------------------------------------------------------------

def _fmt_ms(v: Optional[float]) -> str:
    return f"{1e3 * v:8.1f}" if isinstance(v, (int, float)) else f"{'-':>8}"


def _fmt_age(v: Optional[float]) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v:.0f}s" if v < 120 else f"{v / 60:.0f}m"


def render_report(report: dict) -> str:
    """The dashboard text: header, fleet line, per-host table, active
    alerts, loss sparkline. Pure function of the report (tested as
    such; the live loop just reprints it)."""
    snap = report["snapshot"]
    fleet = snap.get("fleet") or {}
    lines: List[str] = []
    mesh = ",".join(f"{a}={s}" for a, s in (snap.get("mesh") or {}).items()
                    if s != 1)
    label = [f"watch: {snap.get('run_dir')}"]
    if snap.get("run_id"):
        label.append(f"run_id={snap['run_id']}")
    if snap.get("strategy"):
        label.append(f"strategy={snap['strategy']}")
    if mesh:
        label.append(f"mesh={mesh}")
    lines.append("  ".join(label))

    rate = fleet.get("steps_per_sec")
    span = (f"steps {fleet.get('step_min')}..{fleet.get('step_max')}"
            if fleet.get("step_max") is not None else "no steps yet")
    fleet_bits = [
        f"fleet: {fleet.get('n_hosts', 0)} host(s)", span,
        f"{rate:.2f} steps/s" if isinstance(rate, (int, float)) else
        "steps/s n/a",
    ]
    dws = fleet.get("data_wait_share")
    if isinstance(dws, (int, float)):
        fleet_bits.append(f"data-wait {dws:.0%}")
    gf = fleet.get("goodput_fraction")
    if isinstance(gf, (int, float)):
        # the trainers' live goodput gauge (this incarnation only);
        # `tpu-ddp-torch goodput` is the cross-incarnation truth
        fleet_bits.append(f"goodput {gf:.0%}")
    hbm = fleet.get("hbm_high_water_frac")
    if isinstance(hbm, (int, float)):
        # worst host's measured HBM high-water over the device limit
        # (the live memory sampler's gauge; MEM001 fires past the
        # configured fraction — docs/memory.md)
        fleet_bits.append(f"hbm {hbm:.0%}")
    rl = report.get("roofline") or {}
    if rl.get("mfu") is not None:
        fleet_bits.append(f"MFU {rl['mfu']:.1%}")
    if rl.get("roofline_fraction") is not None:
        fleet_bits.append(
            f"roofline {rl['roofline_fraction']:.0%} ({rl.get('bound')})")
    lines.append("  ".join(fleet_bits))
    if rl.get("note"):
        lines.append(f"  note: {rl['note']}")
    lines.append("")

    header = (f"{'host':>4} {'step':>8} {'steps/s':>8} {'step_ms':>8} "
              f"{'wait_ms':>8} {'wait%':>6} {'hb_age':>7}  flags")
    lines += [header, "-" * len(header)]
    for h in snap.get("hosts", []):
        p50 = h.get("phase_p50_s") or {}
        flags = []
        if h.get("lost"):
            flags.append("LOST")
        if h.get("ended"):
            flags.append("done")  # clean shutdown, not a loss
        if h.get("straggler"):
            flags.append("STRAGGLER")
        health = h.get("health") or {}
        if health.get("nonfinite_steps"):
            flags.append(f"nonfinite×{health['nonfinite_steps']}")
        # a loader stage currently wedged on this host (the
        # StageMonitor's in-flight marker — DAT001's suspect)
        flight = (h.get("datapath") or {}).get("in_flight") or {}
        if flight.get("stage"):
            flags.append(f"stage:{flight['stage']}")
        rate = h.get("steps_per_sec")
        share = h.get("data_wait_share")
        lines.append(
            f"{h.get('host'):>4} "
            f"{h.get('step') if h.get('step') is not None else '-':>8} "
            + (f"{rate:>8.2f} " if isinstance(rate, (int, float))
               else f"{'-':>8} ")
            + f"{_fmt_ms(p50.get('compiled_step'))} "
            + f"{_fmt_ms(p50.get('data_wait'))} "
            + (f"{share:>6.0%} " if isinstance(share, (int, float))
               else f"{'-':>6} ")
            + f"{_fmt_age(h.get('heartbeat_age_s')):>7}  "
            + (",".join(flags) or "ok")
        )

    alerts = report.get("alerts") or []
    lines.append("")
    if alerts:
        lines.append(f"active alerts ({len(alerts)}):")
        for a in alerts:
            scope = f"host {a['host']}" if a.get("host") is not None \
                else "fleet"
            lines.append(
                f"  {a['rule']} [{a['severity']}] {scope}: {a['message']}")
    else:
        lines.append("active alerts: none")

    # resolved episodes from alerts.jsonl — the durable record, so a
    # watcher attached AFTER an incident still sees what happened
    history = [ep for ep in (report.get("history") or [])
               if ep.get("resolved_wall") is not None]
    if history:
        lines.append(f"alert history ({len(history)} resolved "
                     "episode(s), newest last):")
        for ep in history[-8:]:
            scope = (f"host {ep['host']}" if ep.get("host") is not None
                     else "fleet")
            dur = ep.get("duration_s")
            lines.append(
                f"  {ep['rule']} [{ep.get('severity')}] {scope}: "
                f"resolved after "
                + (_fmt_age(dur) if isinstance(dur, (int, float))
                   else "?")
                + (f" @ step {ep['step']}"
                   if ep.get("step") is not None else "")
            )

    profiles = report.get("profiles") or []
    if profiles:
        latest = profiles[-1]
        trig = latest.get("trigger") or "?"
        if latest.get("rule"):
            trig = f"alert:{latest['rule']}"
        lines.append(
            f"profile captures: {len(profiles)} bundle(s) — latest "
            f"steps {latest.get('start_step')}..{latest.get('end_step')} "
            f"(trigger {trig}); read with `tpu-ddp-torch profile "
            f"{snap.get('run_dir')}`"
        )

    # the diagnose join (--once only): one line naming the likely
    # root cause from the DIA rule registry (docs/diagnose.md)
    if "likely_cause" in report:
        from tpu_ddp_torch.diagnose.report import render_likely_cause

        lines.append("")
        lines.append(render_likely_cause(report["likely_cause"]))

    series = snap.get("loss_series") or []
    if series:
        from tpu_ddp_torch.health.summarize import sparkline

        lines.append("")
        lines.append(f"loss   |{sparkline(series)}|")
    return "\n".join(lines)


# -- CLI ------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-ddp-torch watch",
        description="live fleet monitor over a run dir's per-host "
                    "telemetry/health/heartbeat files "
                    "(docs/monitoring.md)",
    )
    ap.add_argument("path", help="run dir (the --telemetry-dir of a "
                                 "running or finished job)")
    ap.add_argument("--once", action="store_true",
                    help="one poll, print, exit (exit code 1 when any "
                         "alert fires — scriptable)")
    ap.add_argument("--json", action="store_true",
                    help="emit the schema-versioned report JSON instead "
                         "of the dashboard text")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="poll/refresh period in seconds (live mode)")
    ap.add_argument("--stale-seconds", type=float, default=60.0,
                    help="heartbeat age that marks a host lost (FLT001)")
    ap.add_argument("--straggler-mad", type=float, default=5.0,
                    help="k in the median + k*MAD straggler threshold")
    ap.add_argument("--persist-windows", type=int, default=3,
                    help="consecutive flagged polls before STR001 fires "
                         "(--once treats this as 1)")
    ap.add_argument("--data-wait-max", type=float, default=0.5,
                    help="DWT001 threshold on the data-wait share")
    ap.add_argument("--checkpoint-overdue", type=float, default=0.0,
                    metavar="SECONDS",
                    help=">0: CKP001 fires when the newest checkpoint "
                         "span is older than this")
    ap.add_argument("--goodput-min", type=float, default=0.0,
                    metavar="FRACTION",
                    help=">0: GDP001 fires when the fleet's live "
                         "goodput gauge falls below this fraction "
                         "(e.g. 0.5; short runs are legitimately "
                         "compile-bound, so the rule is opt-in)")
    ap.add_argument("--loss-plateau-window", type=int, default=0,
                    metavar="N",
                    help=">0: TRN001 fires when the loss improved less "
                         "than --loss-plateau-delta over the last N "
                         "recorded points (opt-in — a converged run "
                         "legitimately plateaus; docs/curves.md)")
    ap.add_argument("--loss-plateau-delta", type=float, default=0.01,
                    metavar="FRACTION",
                    help="TRN001: minimum fractional loss improvement "
                         "over the window that counts as progress")
    ap.add_argument("--mem-limit-frac", type=float, default=0.92,
                    metavar="FRACTION",
                    help="MEM001 fires when a host's measured HBM "
                         "high-water exceeds this fraction of the "
                         "device limit (0 disables; docs/memory.md)")
    ap.add_argument("--comms-baseline", default=None, metavar="FILE",
                    help="`tpu-ddp-torch comms bench --json` artifact: COM001 "
                         "fires when a host axis's live measured "
                         "collective bandwidth (comms-health-p<i>.json, "
                         "staleness-adjusted) falls below "
                         "--comms-collapse-frac of its calibrated "
                         "per-axis baseline (docs/comms.md; needs a run "
                         "started with --comms-monitor)")
    ap.add_argument("--comms-collapse-frac", type=float, default=0.25,
                    metavar="FRACTION",
                    help="COM001 threshold as a fraction of the "
                         "calibrated baseline bandwidth")
    ap.add_argument("--data-baseline", default=None, metavar="FILE",
                    help="`tpu-ddp-torch data bench --json` artifact: DAT001 "
                         "fires when a host's live staged-loader stage "
                         "busy rate (batches per second of stage run "
                         "time, data-health-p<i>.json) falls below "
                         "--data-collapse-frac of its benched per-stage "
                         "baseline (docs/data.md; needs a run on the "
                         "staged pipeline, --prefetch-batches N or "
                         "--prefetch-depth 0)")
    ap.add_argument("--data-collapse-frac", type=float, default=0.25,
                    metavar="FRACTION",
                    help="DAT001 threshold as a fraction of the benched "
                         "baseline stage throughput")
    ap.add_argument("--data-min-stage-s", type=float, default=0.005,
                    metavar="SECONDS",
                    help="DAT001 materiality floor: a stage only alarms "
                         "when its live busy cost also exceeds this many "
                         "seconds per batch (micro-stages bench in the "
                         "sub-microsecond range, where observer overhead "
                         "alone would mimic a ratio collapse; 0 "
                         "disables)")
    ap.add_argument("--webhook", default=None, metavar="URL",
                    help="also POST every alert edge as JSON here")
    ap.add_argument("--no-alerts-file", action="store_true",
                    help="do not append alerts.jsonl into the run dir")
    ap.add_argument("--capture-profile", action="store_true",
                    help="alert action: a STR001/THR001/DWT001 firing "
                         "edge POSTs /profile at the implicated host's "
                         "monitor endpoint, auto-arming an anomaly-"
                         "profiler capture (docs/profiling.md); "
                         "rate-limited by --max-auto-profiles")
    ap.add_argument("--max-auto-profiles", type=int, default=3,
                    metavar="N",
                    help="alert-armed profiler captures allowed per "
                         "watch session (0 disables the arming while "
                         "keeping --capture-profile accepted)")
    ap.add_argument("--roofline", action="store_true",
                    help="join measured throughput against the roofline "
                         "prediction (a note in the port until its "
                         "anatomy rebuild lands; off by default)")
    args = ap.parse_args(list(argv) if argv is not None else None)

    config = MonitorConfig(
        straggler_mad_threshold=args.straggler_mad,
        straggler_persist_windows=args.persist_windows,
        heartbeat_stale_seconds=args.stale_seconds,
        data_wait_share_max=args.data_wait_max,
        checkpoint_overdue_seconds=args.checkpoint_overdue,
        goodput_min_fraction=args.goodput_min,
        loss_plateau_window=args.loss_plateau_window,
        loss_plateau_rel_delta=args.loss_plateau_delta,
        mem_limit_frac=args.mem_limit_frac,
        webhook_url=args.webhook,
        max_auto_profiles=args.max_auto_profiles,
        comms_baseline=args.comms_baseline,
        comms_collapse_frac=args.comms_collapse_frac,
        data_baseline=args.data_baseline,
        data_collapse_frac=args.data_collapse_frac,
        data_min_stage_s=args.data_min_stage_s,
    )
    actions = ["log"] if args.json else []
    if not args.no_alerts_file:
        actions.append("file")
    if args.webhook:
        actions.append("webhook")
    if args.capture_profile:
        actions.append("capture_profile")
    try:
        aggregator = FleetAggregator(args.path, config)
    except FileNotFoundError as e:
        print(f"tpu-ddp-torch watch: {e}", file=sys.stderr)
        return 2
    engine = AlertEngine(config, run_dir=args.path,
                         actions=tuple(actions), once=args.once)
    rl = roofline_view(args.path) if args.roofline else None

    if args.once:
        report = build_report(aggregator, engine)
        if rl is not None:
            _join_roofline(report, rl)
        # one-shot mode reads a static run dir, so the full diagnose
        # join is affordable: a single "likely cause" row from the DIA
        # rule registry (docs/diagnose.md); None = no suspect
        from tpu_ddp_torch.diagnose.rules import likely_cause

        report["likely_cause"] = likely_cause(args.path)
        print(json.dumps(report, indent=1) if args.json
              else render_report(report))
        return 1 if report["alerts"] else 0

    records = _RunRecords(args.path)
    try:
        while True:
            report = build_report(aggregator, engine, records=records)
            if rl is not None:
                _join_roofline(report, rl)
            if args.json:
                print(json.dumps(report), flush=True)
            else:
                # clear + home, then the dashboard (plain ANSI, no curses)
                sys.stdout.write("\x1b[2J\x1b[H" + render_report(report)
                                 + "\n")
                sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
