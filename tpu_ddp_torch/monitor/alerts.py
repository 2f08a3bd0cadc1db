"""Declarative alert rules over fleet snapshots -> ``alerts.jsonl``.

The port's copy of ``tpu_ddp/monitor/alerts.py``: the same rule ids,
severities, kinds, fix hints (with ``tpu-ddp-torch`` for ``tpu-ddp``) and
record shape, so either package's ``alerts.jsonl`` reads the same. Every
rule has a stable id, a severity, a kind (``threshold`` / ``trend`` /
``staleness``), and a one-line fix hint.

The :class:`AlertEngine` is edge-triggered: a condition FIRES once when
it first holds, stays in the ``active()`` set while it persists, and
emits one RESOLVED record when it clears. Every edge goes through the
configured actions: ``log`` (process logger), ``file`` (schema-versioned
``alerts.jsonl`` appended in the run dir), ``webhook`` (JSON POST to
``MonitorConfig.webhook_url``, best-effort), and ``capture_profile`` (a
performance alert's firing edge POSTs ``/profile`` at the implicated
host's exporter, rate-limited to ``MonitorConfig.max_auto_profiles`` per
run and edge-triggered like the alerts themselves).

COM001 and DAT001 judge the live comms-health and data-health files
(``comms/forensics.py``'s ``HopMonitor``, ``datapath/stages.py``'s
``StageMonitor``) against a ``comms bench`` / ``data bench`` baseline
artifact (``--comms-baseline``, ``--data-baseline``), read through
``comms/model.py::axis_baselines`` and ``datapath/model.py::stage_baselines``;
an unreadable baseline disables its rule with a warning, as in JAX.
Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import statistics
from collections import deque
from typing import Dict, List, Optional, Tuple

from tpu_ddp_torch.monitor.aggregate import FleetSnapshot, MonitorConfig

log = logging.getLogger(__name__)

#: bump on any breaking change to the alerts.jsonl record shape
ALERT_SCHEMA_VERSION = 1

#: the performance rules whose firing edge auto-arms a profiler capture
#: under the ``capture_profile`` action: a straggler, a throughput
#: collapse, and an input-bound loop are exactly the anomalies a capture
#: window can explain. Numerics alerts (NUM*) already have their own
#: evidence path (the health anomaly dump), and FLT001's host is gone.
CAPTURE_PROFILE_RULES = ("STR001", "THR001", "DWT001")

#: rule registry: id -> (what it catches, severity, kind, fix hint) —
#: the single source behind findings and the docs/monitoring.md table
ALERT_RULES: Dict[str, Dict[str, str]] = {
    "FLT001": {
        "title": "host lost",
        "severity": "critical",
        "kind": "staleness",
        "fix": "check the host for preemption/crash (hang-p<i>.log, "
               "scheduler events); restart it or re-mesh the job to the "
               "survivors and --resume",
    },
    "STR001": {
        "title": "persistent straggler",
        "severity": "warning",
        "kind": "threshold",
        "fix": "a host's compiled_step/data_wait p50 has sat > k*MAD "
               "above the fleet median for N windows: check its input "
               "pipeline, thermal state, and neighbors on the ICI/DCN "
               "path; drain-and-replace if it persists",
    },
    "THR001": {
        "title": "fleet steps/sec collapse",
        "severity": "critical",
        "kind": "trend",
        "fix": "throughput fell below the collapse fraction of its "
               "rolling baseline: look for a new straggler/lost host, "
               "storage slowdown, or a recompile storm "
               "(jax/cache counters in /metrics)",
    },
    "DWT001": {
        "title": "data-wait share high",
        "severity": "warning",
        "kind": "threshold",
        "fix": "the step loop is input-bound: run `tpu-ddp-torch data report "
               "<run_dir>` for the per-stage decomposition of the wait "
               "(docs/data.md), then raise --prefetch-batches, fix the "
               "named stage, or move decode work off the trainer hosts",
    },
    "NUM001": {
        "title": "grad-norm spike",
        "severity": "warning",
        "kind": "trend",
        "fix": "gradient norm jumped > k*MAD over its rolling window: "
               "inspect `tpu-ddp-torch health <run_dir>` and the anomaly "
               "dump; consider --grad-clip-norm or a lower lr",
    },
    "NUM002": {
        "title": "non-finite sentinel",
        "severity": "critical",
        "kind": "threshold",
        "fix": "a NaN/Inf step was recorded: the health policy decides "
               "the in-run response (--health-policy skip_step/halt); "
               "the anomaly dump under <run_dir>/anomalies/ has the "
               "offending batch and stats",
    },
    "MEM001": {
        "title": "HBM headroom low",
        "severity": "warning",
        "kind": "threshold",
        "fix": "a host's measured HBM high-water sits above the "
               "configured fraction of the device limit: the next "
               "allocation spike is an OOM — run `tpu-ddp-torch mem "
               "<run_dir>` for the measured-vs-planned breakdown, then "
               "shrink the batch, enable --remat/--zero1, or re-run "
               "`tpu-ddp-torch tune` under the measured cap (docs/memory.md)",
    },
    "COM001": {
        "title": "interconnect bandwidth collapse",
        "severity": "warning",
        "kind": "threshold",
        "fix": "a host axis's live measured collective bandwidth "
               "(staleness-adjusted from comms-health-p<i>.json) fell "
               "below the collapse fraction of its calibrated baseline "
               "(`tpu-ddp-torch comms bench`): check the in-flight collective "
               "named in the message and the ICI/DCN path under it; if "
               "the ring is fully wedged the watchdog's hang bundle "
               "will name the suspect collective (docs/comms.md)",
    },
    "DAT001": {
        "title": "loader stage throughput collapse",
        "severity": "warning",
        "kind": "threshold",
        "fix": "a host's live staged-loader stage busy-rate (batches "
               "per second of stage run time, data-health-p<i>.json) "
               "fell below the collapse fraction of its benched "
               "baseline (`tpu-ddp-torch data bench`): check the stage named "
               "in the message (a currently-wedged stage is also named "
               "in_flight); if the step fully stalls the watchdog's "
               "hang bundle will carry suspect_stage (docs/data.md)",
    },
    "TRN001": {
        "title": "loss plateau",
        "severity": "warning",
        "kind": "trend",
        "fix": "the training loss has stopped improving over the "
               "configured window (opt-in: --loss-plateau-window): "
               "check the lr schedule (warmup over? decay kicked in "
               "too early?), then judge the trajectory against its "
               "seed band with `tpu-ddp-torch curves <run_dir> --against "
               "<registry>` (docs/curves.md) — an expected convergence "
               "plateau resolves by disabling the rule",
    },
    "CKP001": {
        "title": "checkpoint overdue",
        "severity": "warning",
        "kind": "staleness",
        "fix": "no checkpoint span within the configured budget: a "
               "preemption now loses that much work — check the "
               "checkpoint storage path and --checkpoint-every-epochs",
    },
    "GDP001": {
        "title": "goodput low",
        "severity": "warning",
        "kind": "threshold",
        "fix": "the fleet's productive fraction of wall-clock sits "
               "below the configured floor: run `tpu-ddp-torch goodput "
               "<run_dir>` for the badput breakdown (restart gaps, "
               "replayed steps, data wait, checkpoint cost) and the "
               "checkpoint-interval recommendation (docs/goodput.md)",
    },
}


@dataclasses.dataclass
class Alert:
    """One edge (firing or resolved) of one rule on one scope."""

    rule: str
    severity: str
    state: str                      # "firing" | "resolved"
    message: str
    host: Optional[int] = None      # None = fleet-scoped
    value: Optional[float] = None
    step: Optional[int] = None
    wall_time: float = 0.0

    def to_record(self) -> dict:
        rec = {
            "schema_version": ALERT_SCHEMA_VERSION,
            "type": "alert",
            **dataclasses.asdict(self),
        }
        rec["title"] = ALERT_RULES[self.rule]["title"]
        rec["fix"] = ALERT_RULES[self.rule]["fix"]
        return rec


class AlertEngine:
    """Evaluate the rule registry against each snapshot; edge-triggered.

    ``once=True`` is the ``watch --once`` / CI mode: persistence
    requirements collapse to a single observation (a one-shot pass over
    a static run dir must still surface a straggler that would need N
    live windows to qualify).
    """

    def __init__(
        self,
        config: Optional[MonitorConfig] = None,
        *,
        run_dir: Optional[str] = None,
        actions: Tuple[str, ...] = ("log", "file"),
        once: bool = False,
        profile_trigger=None,
    ):
        self.config = config or MonitorConfig()
        self.run_dir = run_dir
        self.actions = tuple(actions)
        self.once = once
        # the capture_profile action's POST; injectable for tests. The
        # default discovers the run's exporter endpoints from the run dir
        self._profile_trigger = profile_trigger
        self.auto_profiles = 0      # successful capture arms this run
        self._active: Dict[Tuple[str, Optional[int]], Alert] = {}
        self._straggler_runs: Dict[int, int] = {}
        self._rate_baseline: deque = deque(
            maxlen=max(self.config.baseline_polls, 3))
        # COM001's calibrated per-axis bandwidth reference, loaded once
        # from the configured `comms bench --json` artifact ({} = rule
        # disabled: no baseline, or an unreadable/baseline-less file —
        # the engine must keep watching either way)
        self._comms_baselines: Dict[str, float] = {}
        if self.config.comms_baseline:
            try:
                with open(self.config.comms_baseline) as f:
                    art = json.load(f)
            except (OSError, json.JSONDecodeError):
                log.warning(
                    "COM001 disabled: could not read the comms baseline "
                    "artifact at %r", self.config.comms_baseline)
                art = None
            if isinstance(art, dict):
                from tpu_ddp_torch.comms.model import axis_baselines

                self._comms_baselines = axis_baselines(
                    art.get("comms") if isinstance(art.get("comms"), dict)
                    else art)
        # DAT001's benched per-stage throughput reference, same contract
        # as the comms baseline above ({} = rule disabled)
        self._data_baselines: Dict[str, float] = {}
        if self.config.data_baseline:
            try:
                with open(self.config.data_baseline) as f:
                    art = json.load(f)
            except (OSError, json.JSONDecodeError):
                log.warning(
                    "DAT001 disabled: could not read the data baseline "
                    "artifact at %r", self.config.data_baseline)
                art = None
            if isinstance(art, dict):
                from tpu_ddp_torch.datapath.model import stage_baselines

                self._data_baselines = stage_baselines(art)

    # -- rule evaluation --------------------------------------------------

    def _conditions(
        self, snap: FleetSnapshot
    ) -> Dict[Tuple[str, Optional[int]], Tuple[str, Optional[float]]]:
        """{(rule, host): (message, value)} for every condition that
        holds on this snapshot."""
        cfg = self.config
        found: Dict[Tuple[str, Optional[int]],
                    Tuple[str, Optional[float]]] = {}

        for h in snap.hosts:
            if h.lost:
                age = (h.heartbeat_age_s if h.heartbeat_age_s is not None
                       else h.last_event_age_s)
                found[("FLT001", h.host)] = (
                    f"host {h.host} lost: heartbeat stale "
                    f"{age:.0f}s (deadline "
                    f"{cfg.heartbeat_stale_seconds:.0f}s)"
                    if age is not None else f"host {h.host} lost",
                    age,
                )

            # straggler persistence: consecutive flagged polls
            runs = self._straggler_runs.get(h.host, 0)
            runs = runs + 1 if h.straggler else 0
            self._straggler_runs[h.host] = runs
            need = 1 if self.once else cfg.straggler_persist_windows
            if h.straggler and runs >= need:
                phase = (h.straggler_phases[0] if h.straggler_phases
                         else "compiled_step")
                p50 = h.phase_p50_s.get(phase)
                med = (snap.fleet.get("phase_p50_s") or {}).get(phase)

                def ms(v):
                    return f"{1e3 * v:.1f}ms" if v else "n/a"

                found[("STR001", h.host)] = (
                    f"host {h.host} straggling on "
                    f"{','.join(h.straggler_phases) or phase} "
                    f"({runs} consecutive window(s), p50 {ms(p50)} vs "
                    f"fleet median {ms(med)})",
                    p50,
                )

            if (h.data_wait_share is not None
                    and h.data_wait_share > cfg.data_wait_share_max):
                found[("DWT001", h.host)] = (
                    f"host {h.host} data-wait share "
                    f"{h.data_wait_share:.0%} > "
                    f"{cfg.data_wait_share_max:.0%} of the step loop",
                    h.data_wait_share,
                )

            if h.health.get("grad_norm_spike"):
                found[("NUM001", h.host)] = (
                    f"host {h.host} grad norm spiked to "
                    f"{h.health.get('last_grad_norm')} "
                    f"(> {cfg.grad_norm_mad_threshold:g}*MAD over its "
                    "rolling window)",
                    h.health.get("last_grad_norm"),
                )

            # MEM001: measured HBM high-water above the configured
            # fraction of the device limit (the gauge pair the live
            # memory sampler publishes, docs/memory.md). The high-water
            # is monotone, so this naturally latches until the run ends.
            frac = h.memory.get("high_water_frac")
            if (cfg.mem_limit_frac > 0
                    and isinstance(frac, (int, float))
                    and frac > cfg.mem_limit_frac):
                hw = h.memory.get("high_water_bytes")
                limit = h.memory.get("bytes_limit")
                found[("MEM001", h.host)] = (
                    f"host {h.host} HBM high-water {frac:.0%} of the "
                    f"device limit (> {cfg.mem_limit_frac:.0%}"
                    + (f"; {hw:.0f}/{limit:.0f} B"
                       if isinstance(hw, (int, float))
                       and isinstance(limit, (int, float)) else "")
                    + ") — `tpu-ddp-torch mem` has the breakdown",
                    float(frac),
                )

            # COM001: live measured per-axis collective bandwidth (the
            # hop monitor's health file, staleness-adjusted by the
            # aggregator) against the calibrated baseline. Worst
            # offending axis names the message; the in-flight collective
            # rides along — it is the hang forensics' suspect.
            if self._comms_baselines and h.comms:
                worst = None  # (axis, eff, base)
                for axis, eff in (h.comms.get("axis_bw") or {}).items():
                    base = self._comms_baselines.get(axis)
                    if (base and isinstance(eff, (int, float))
                            and eff < cfg.comms_collapse_frac * base
                            and (worst is None
                                 or eff / base < worst[1] / worst[2])):
                        worst = (axis, float(eff), base)
                if worst is not None:
                    axis, eff, base = worst
                    flight = h.comms.get("in_flight") or {}
                    stuck = (f"; in flight: {flight.get('key')} "
                             f"hop {flight.get('hop')}/"
                             f"{flight.get('n_hops')}"
                             if flight.get("key") else "")
                    found[("COM001", h.host)] = (
                        f"host {h.host} axis {axis!r} measured "
                        f"{eff:.3g} B/s vs calibrated {base:.3g} B/s "
                        f"(< {cfg.comms_collapse_frac:.0%})"
                        + stuck,
                        eff,
                    )

            # DAT001: live measured per-stage loader throughput (the
            # StageMonitor's health file, staleness-adjusted by the
            # aggregator) against the benched baseline. Worst offending
            # stage names the message; the in-flight stage rides along —
            # it is the hang forensics' suspect_stage.
            if self._data_baselines and h.datapath:
                worst = None  # (stage, eff, base)
                rates = h.datapath.get("stage_batches_per_s") or {}
                for stage, eff in rates.items():
                    base = self._data_baselines.get(stage)
                    if not (base and isinstance(eff, (int, float))):
                        continue
                    # materiality floor: sub-millisecond benched stages
                    # fail the ratio test on observer overhead alone; a
                    # stage whose live busy cost is under the floor
                    # cannot be the input bottleneck, whatever its ratio
                    if eff * cfg.data_min_stage_s > 1.0:
                        continue
                    if (eff < cfg.data_collapse_frac * base
                            and (worst is None
                                 or eff / base < worst[1] / worst[2])):
                        worst = (stage, float(eff), base)
                if worst is not None:
                    stage, eff, base = worst
                    flight = h.datapath.get("in_flight") or {}
                    stuck = (f"; in flight: {flight.get('stage')} "
                             f"since step {flight.get('step')}"
                             if flight.get("stage") else "")
                    found[("DAT001", h.host)] = (
                        f"host {h.host} loader stage {stage!r} measured "
                        f"{eff:.3g} batches/s vs benched {base:.3g} "
                        f"batches/s (< {cfg.data_collapse_frac:.0%})"
                        + stuck,
                        eff,
                    )

            # latched, not edge-on-delta: NaNs never un-happen, so the
            # alert must stay in the active set (and never emit a bogus
            # "resolved" record) for the rest of the watch session
            nonfinite = int(h.health.get("nonfinite_steps") or 0)
            if nonfinite > 0:
                found[("NUM002", h.host)] = (
                    f"host {h.host} recorded {nonfinite} non-finite "
                    "step(s)",
                    float(nonfinite),
                )

        rate = snap.fleet.get("steps_per_sec")
        if isinstance(rate, (int, float)):
            baseline = (statistics.median(self._rate_baseline)
                        if len(self._rate_baseline) >= 3 else None)
            if (baseline and baseline > 0
                    and rate < cfg.steps_per_sec_collapse_frac * baseline):
                found[("THR001", None)] = (
                    f"fleet steps/sec collapsed to {rate:.2f} "
                    f"(< {cfg.steps_per_sec_collapse_frac:.0%} of rolling "
                    f"baseline {baseline:.2f})",
                    rate,
                )
            # baseline freezes while collapsed: absorbing the collapsed
            # rate would lower the median until the alert falsely
            # self-resolves with throughput still on the floor
            if (("THR001", None) not in found
                    and ("THR001", None) not in self._active):
                self._rate_baseline.append(rate)

        # TRN001 — loss plateau (opt-in, fleet-scoped: the health loss
        # series is a replicated global). Compared as median(first half)
        # vs median(second half) of the newest window: robust to single-
        # step jitter, and it RESOLVES as soon as the loss starts moving
        # again (or latches through a whole converged tail — which is
        # why the rule is opt-in).
        w = cfg.loss_plateau_window
        if w > 0:
            series = [v for v in (snap.loss_series or [])
                      if isinstance(v, (int, float)) and math.isfinite(v)]
            if len(series) >= w:
                recent = series[-w:]
                first = statistics.median(recent[:w // 2])
                second = statistics.median(recent[w // 2:])
                level = max(abs(first), 1e-8)
                improvement = (first - second) / level
                if improvement < cfg.loss_plateau_rel_delta:
                    found[("TRN001", None)] = (
                        f"loss plateaued: improved {improvement:.2%} "
                        f"over the last {w} recorded points (< "
                        f"{cfg.loss_plateau_rel_delta:.2%} of its "
                        f"level {first:.4g}) — is this convergence or "
                        "a dead schedule?",
                        improvement,
                    )

        if cfg.goodput_min_fraction > 0:
            gf = snap.fleet.get("goodput_fraction")
            if (isinstance(gf, (int, float))
                    and gf < cfg.goodput_min_fraction):
                found[("GDP001", None)] = (
                    f"fleet goodput {gf:.0%} below the "
                    f"{cfg.goodput_min_fraction:.0%} floor — "
                    "`tpu-ddp-torch goodput` has the badput breakdown",
                    gf,
                )

        if cfg.checkpoint_overdue_seconds > 0:
            ckpt_age = snap.fleet.get("checkpoint_age_s")
            if isinstance(ckpt_age, (int, float)):
                if ckpt_age > cfg.checkpoint_overdue_seconds:
                    found[("CKP001", None)] = (
                        f"last checkpoint {ckpt_age:.0f}s ago (budget "
                        f"{cfg.checkpoint_overdue_seconds:.0f}s) — that "
                        "much work is at preemption risk",
                        ckpt_age,
                    )
            else:
                # no checkpoint span EVER recorded — the worst case the
                # rule exists for; age the condition off the run start
                run_age = snap.fleet.get("run_age_s")
                if (isinstance(run_age, (int, float))
                        and run_age > cfg.checkpoint_overdue_seconds):
                    found[("CKP001", None)] = (
                        f"no checkpoint recorded in {run_age:.0f}s of "
                        f"run (budget "
                        f"{cfg.checkpoint_overdue_seconds:.0f}s) — is "
                        "checkpointing configured?",
                        run_age,
                    )
        return found

    # -- engine -----------------------------------------------------------

    def evaluate(self, snap: FleetSnapshot) -> List[Alert]:
        """Fold one snapshot in; returns the EDGES (newly firing +
        newly resolved alerts) this poll produced. ``active()`` holds
        the standing set."""
        conditions = self._conditions(snap)
        step = snap.fleet.get("step_max")
        edges: List[Alert] = []
        for key, (message, value) in conditions.items():
            if key in self._active:
                continue  # still firing — no new edge
            rule, host = key
            alert = Alert(
                rule=rule,
                severity=ALERT_RULES[rule]["severity"],
                state="firing",
                message=message,
                host=host,
                value=value,
                step=step if isinstance(step, int) else None,
                wall_time=snap.wall_time,
            )
            self._active[key] = alert
            edges.append(alert)
        for key in [k for k in self._active if k not in conditions]:
            fired = self._active.pop(key)
            edges.append(dataclasses.replace(
                fired, state="resolved", wall_time=snap.wall_time,
                message=f"resolved: {fired.message}",
            ))
        for alert in edges:
            self._emit(alert)
        return edges

    def active(self) -> List[Alert]:
        """The standing firing set, most severe first."""
        order = {"critical": 0, "warning": 1}
        return sorted(
            self._active.values(),
            key=lambda a: (order.get(a.severity, 2), a.rule,
                           a.host if a.host is not None else -1),
        )

    # -- actions ----------------------------------------------------------

    def _emit(self, alert: Alert) -> None:
        if "log" in self.actions:
            level = (logging.ERROR if alert.severity == "critical"
                     and alert.state == "firing" else logging.WARNING)
            log.log(level, "alert %s [%s] %s: %s", alert.rule,
                    alert.severity, alert.state, alert.message)
        if "file" in self.actions and self.run_dir:
            try:
                path = os.path.join(self.run_dir, "alerts.jsonl")
                with open(path, "a") as f:
                    f.write(json.dumps(alert.to_record()) + "\n")
            except OSError:  # alerting must never kill the watcher
                log.exception("failed to append alerts.jsonl")
        if "webhook" in self.actions and self.config.webhook_url:
            self._post_webhook(alert)
        if ("capture_profile" in self.actions
                and alert.state == "firing"
                and alert.rule in CAPTURE_PROFILE_RULES):
            self._capture_profile(alert)

    def _capture_profile(self, alert: Alert) -> None:
        """Arm an anomaly-profiler capture off a performance alert's
        firing edge. Host-scoped alerts (STR001/DWT001) target the
        implicated host's exporter; fleet-scoped ones (THR001) arm every
        host. Edge-triggering already bounds this to one attempt per
        alert episode; ``max_auto_profiles`` bounds the run total."""
        if self.auto_profiles >= self.config.max_auto_profiles:
            log.info(
                "alert %s fired but max_auto_profiles (%d) is exhausted; "
                "arm manually with POST /profile if needed",
                alert.rule, self.config.max_auto_profiles,
            )
            return
        trigger = self._profile_trigger
        if trigger is None:
            if not self.run_dir:
                return
            from tpu_ddp_torch.profiler.capture import post_profile_trigger

            def trigger(**kw):
                return post_profile_trigger(self.run_dir, **kw)

        try:
            armed = trigger(host=alert.host, rule=alert.rule, steps=None)
        except Exception:
            log.warning("capture_profile trigger failed", exc_info=True)
            return
        if armed:
            self.auto_profiles += 1
            log.warning(
                "alert %s auto-armed a profiler capture (%d/%d this "
                "run); read it back with `tpu-ddp-torch profile %s`",
                alert.rule, self.auto_profiles,
                self.config.max_auto_profiles, self.run_dir or "<run_dir>",
            )

    def _post_webhook(self, alert: Alert) -> None:
        import urllib.request

        try:
            req = urllib.request.Request(
                self.config.webhook_url,
                data=json.dumps(alert.to_record()).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=3).close()
        except Exception:  # best-effort by design
            log.warning("alert webhook POST failed", exc_info=True)


def read_alerts(run_dir: str) -> List[dict]:
    """Parse a run dir's ``alerts.jsonl`` (post-mortem / test path);
    empty when no alert ever fired. Shares the torn-line/future-schema
    tolerance of the other JSONL readers."""
    path = os.path.join(run_dir, "alerts.jsonl")
    if not os.path.isfile(path):
        return []
    from tpu_ddp_torch.telemetry.summarize import read_records

    return read_records([path], schema_version=ALERT_SCHEMA_VERSION,
                        kind="alerts")


def alert_history(records: List[dict]) -> List[dict]:
    """Pair ``alerts.jsonl`` firing/resolved edges into EPISODES — what
    ``tpu-ddp-torch watch`` renders as history: each entry carries the rule,
    scope, firing message, and (once resolved) the episode duration.
    Unresolved episodes come back with ``resolved_wall=None`` (still
    active, or the watcher died first); edges are paired per
    (rule, host) in file order, so interleaved episodes of different
    scopes can't cross-match."""
    open_eps: Dict[Tuple[str, Optional[int]], dict] = {}
    episodes: List[dict] = []
    for rec in records:
        if rec.get("type") != "alert":
            continue
        key = (rec.get("rule"), rec.get("host"))
        if rec.get("state") == "firing":
            ep = {
                "rule": rec.get("rule"),
                "severity": rec.get("severity"),
                "host": rec.get("host"),
                "message": rec.get("message"),
                "step": rec.get("step"),
                "fired_wall": rec.get("wall_time"),
                "resolved_wall": None,
                "duration_s": None,
            }
            open_eps[key] = ep
            episodes.append(ep)
        elif rec.get("state") == "resolved":
            ep = open_eps.pop(key, None)
            if ep is None:
                continue  # resolved without a recorded firing (torn file)
            ep["resolved_wall"] = rec.get("wall_time")
            fired, resolved = ep["fired_wall"], ep["resolved_wall"]
            if isinstance(fired, (int, float)) and isinstance(
                    resolved, (int, float)):
                ep["duration_s"] = max(resolved - fired, 0.0)
    return episodes
