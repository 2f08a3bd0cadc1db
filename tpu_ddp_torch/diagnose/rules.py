"""The causal rule registry behind ``tpu-ddp-torch diagnose`` (DIA001..).

The port's copy of ``tpu_ddp/diagnose/rules.py``, rule for rule; DIA003's
action names the port's memory planner (``tpu-ddp-torch-memplan``) as the
JAX one names its own. DIA005 counts ``jax/cache/*`` counters, so it
judges JAX run dirs only: a port run writes none.

A throughput-collapse decision tree over the cross-observatory
evidence table (``evidence.py``): each rule inspects only loaded
sources (a refused source is "cannot know", never "fine"), names its
suspect — the collapsed loader stage, the stuck collective, the lost
host, the non-finite step — prices the incident against the goodput
ledger where it can, and carries the citations its decision rests on
plus a concrete next action. A clean run fires nothing.

Thresholds are deliberately conservative: the chaos-verified contract
(``make diagnose-demo``) is that every injected fault kind is
diagnosed as EXACTLY its own root cause, so a rule that could fire on
a healthy run's noise is a bug here, not an operator judgment call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from tpu_ddp_torch.diagnose.evidence import Evidence, cite

#: rule registry: id -> (what it names, the one-line next action) —
#: the single source behind verdicts and the docs/diagnose.md table
RULES: Dict[str, Dict[str, str]] = {
    "DIA001": {
        "title": "input-bound: collapsed loader stage",
        "action": "fix the named stage (move it off the trainer hosts "
                  "or raise --prefetch-batches); re-price the floor "
                  "with tpu-ddp-torch data bench + tune --data-from",
    },
    "DIA002": {
        "title": "comm-bound: stuck or dominant collective",
        "action": "check the named ring's axis/hosts; shrink the "
                  "payload with --grad-compress int8, or re-mesh "
                  "around the failing link",
    },
    "DIA003": {
        "title": "HBM pressure / fragmentation",
        "action": "re-price with tpu-ddp-torch-memplan: --remat, a smaller "
                  "per-shard batch, or --zero1/--zero3 to shard state",
    },
    "DIA004": {
        "title": "straggler / lost host",
        "action": "drain or re-mesh around the named host (tpu-ddp-torch "
                  "elastic does this automatically); check thermals "
                  "and neighbors before returning it",
    },
    "DIA005": {
        "title": "recompile churn",
        "action": "pin --compilation-cache-dir to shared storage and "
                  "hoist jit out of loops (tpu-ddp-torch lint RCP001 names "
                  "the hazard sites)",
    },
    "DIA006": {
        "title": "numerics: non-finite step",
        "action": "inspect the anomaly dump (tpu-ddp-torch health <dir>); "
                  "train with --health on --health-policy skip_step "
                  "to discard poisoned updates",
    },
    "DIA007": {
        "title": "checkpoint stall / refused checkpoint",
        "action": "retune cadence per the Young-Daly advisor (tpu-ddp-torch "
                  "goodput); verify checkpoint storage health and the "
                  "checksum manifests",
    },
    "DIA008": {
        "title": "restart churn",
        "action": "checkpoint more often per the Young-Daly advisor "
                  "and raise the failing class's restart budget only "
                  "after fixing its cause",
    },
    "DIA009": {
        "title": "zero3 prefetch serialization",
        "action": "restore the double-buffered gather (--zero3 "
                  "prefetch); re-verify the schedule overlap with "
                  "tpu-ddp-torch lint (COL001) and --kernels off",
    },
}


@dataclasses.dataclass
class Verdict:
    """One diagnosed cause: ranked suspect + cost + citations."""

    rule: str
    message: str
    suspect: Dict[str, Any]
    citations: List[dict]
    cost_s: Optional[float] = None
    share: Optional[float] = None

    @property
    def title(self) -> str:
        return RULES[self.rule]["title"]

    @property
    def action(self) -> str:
        return RULES[self.rule]["action"]

    def render(self) -> str:
        cost = ""
        if isinstance(self.cost_s, (int, float)):
            cost = f" [{self.cost_s:.1f}s"
            if isinstance(self.share, (int, float)):
                cost += f", {self.share:.0%} of elapsed"
            cost += "]"
        out = f"  {self.rule} {self.title}: {self.message}{cost}"
        out += f"\n      action: {self.action}"
        for c in self.citations:
            out += f"\n      evidence: {c['path']} :: {c['field']}"
        return out

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "title": self.title,
            "message": self.message,
            "suspect": dict(self.suspect),
            "action": self.action,
            "cost_s": self.cost_s,
            "share": self.share,
            "citations": list(self.citations),
        }


def rule_counts(verdicts: List[Verdict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in verdicts:
        out[v.rule] = out.get(v.rule, 0) + 1
    return out


# -- shared extractors -----------------------------------------------------


def _episodes(ev: Evidence, rule: str) -> List[dict]:
    alerts = ev.data("alerts") or {}
    return [e for e in alerts.get("episodes") or []
            if e.get("rule") == rule]


def _ledger_share(ev: Evidence, *categories: str):
    ledger = ev.data("ledger")
    if not ledger:
        return None, None
    secs = sum(ledger["category_seconds"].get(c, 0.0)
               for c in categories)
    elapsed = ledger.get("elapsed_s") or 0.0
    return secs, (secs / elapsed if elapsed > 0 else None)


def _elastic_deaths(ev: Evidence) -> List[dict]:
    elastic = ev.data("elastic") or {}
    return [d for d in elastic.get("decisions") or []
            if d.get("event") in ("restart", "stop")
            and d.get("exit_class") not in (None, "clean")]


# -- the rules -------------------------------------------------------------


def _rule_input_bound(ev: Evidence) -> Optional[Verdict]:
    dp = ev.data("datapath")
    if not dp:
        return None
    cites: List[dict] = []
    stage = None
    suspect = dp.get("suspect_stage")
    wedged = isinstance(suspect, dict) \
        and suspect.get("source") == "in_flight"
    if wedged:
        flight = (ev.data("comms") or {}).get("in_flight")
        if isinstance(flight, dict) and flight.get("key"):
            # a wedged collective holds every device, so a loader
            # stage caught in flight behind it is back-pressure, not
            # an input root cause — DIA002 owns this run
            wedged = False
    if wedged:
        stage = suspect["stage"]
        cites.append(cite(
            f"{ev.run_dir}/data-health-"
            f"p{suspect.get('process_index', 0)}.json",
            "in_flight.stage"))
    dat = _episodes(ev, "DAT001")
    if dat and stage is None:
        from tpu_ddp_torch.datapath.stages import STAGES

        msg = dat[0].get("message") or ""
        stage = next((s for s in STAGES if s in msg), None)
        if stage:
            cites.append(cite(f"{ev.run_dir}/alerts.jsonl",
                              "DAT001.message"))
    measured = dp.get("measured") or {}
    trace = ev.data("trace") or {}
    phases = trace.get("phases") or {}
    dw = (phases.get("data_wait") or {}).get("total_s") or 0.0
    cs = (phases.get("compiled_step") or {}).get("total_s") or 0.0
    dw_share = dw / (dw + cs) if (dw + cs) > 0 else 0.0
    starved = dw_share > 0.5 and measured.get("dominant_stage")
    if not (wedged or dat or starved):
        return None
    if stage is None:
        stage = measured.get("dominant_stage")
    if stage is None:
        return None  # cannot NAME the stage -> no verdict
    if starved or measured:
        cites.append(cite(ev.run_dir, "datapath.dominant_stage"))
        for f in trace.get("files") or []:
            cites.append(cite(f, "span/data_wait"))
            break
    cost, share = _ledger_share(ev, "data_wait")
    return Verdict(
        rule="DIA001",
        message=(f"loader stage '{stage}' "
                 + ("is wedged in flight" if wedged
                    else "dominates the input wait")
                 + f" (data_wait {dw_share:.0%} of step loop)"),
        suspect={"stage": stage,
                 "process_index": (suspect or {}).get("process_index")},
        citations=cites, cost_s=cost, share=share)


def _rule_comm_bound(ev: Evidence) -> Optional[Verdict]:
    comms = ev.data("comms")
    ledger = ev.data("ledger") or {}
    cites: List[dict] = []
    suspect = None
    wedged = False
    if comms:
        flight = comms.get("in_flight")
        if isinstance(flight, dict) and flight.get("key"):
            suspect, wedged = flight, True
            cites.append(cite(f"{ev.run_dir}/comms-health-p*.json",
                              "in_flight"))
    hangs = (ledger.get("exit_counts") or {}).get("hang", 0)
    hang_deaths = [d for d in _elastic_deaths(ev)
                   if d.get("exit_class") == "hang"]
    if suspect is None and (hangs or hang_deaths):
        for d in hang_deaths:
            if isinstance(d.get("suspect_collective"), dict):
                suspect = d["suspect_collective"]
                cites.append(cite(f"{ev.run_dir}/elastic.jsonl",
                                  "suspect_collective"))
                break
        if suspect is None and comms and comms.get("suspect"):
            suspect = comms["suspect"]
            cites.append(cite(
                f"{ev.run_dir}/hang-forensics-p*.json",
                "suspect_collective"))
    com = _episodes(ev, "COM001")
    if com and suspect is None and comms and comms.get("suspect"):
        suspect = comms["suspect"]
        cites.append(cite(f"{ev.run_dir}/alerts.jsonl",
                          "COM001.message"))
    if suspect is None:
        return None
    cost, share = (_ledger_share(ev, "stall")
                   if (wedged or hangs or hang_deaths)
                   else (None, None))
    state = ("is wedged in flight" if wedged
             else "was in flight when the run hung" if (hangs
                                                        or hang_deaths)
             else "collapsed its measured bandwidth (COM001)")
    extra = (f" at hop {suspect['hop']}/{suspect['n_hops']}"
             if suspect.get("hop") is not None else "")
    return Verdict(
        rule="DIA002",
        message=(f"collective {suspect.get('key')} "
                 f"(axis {suspect.get('axis')}) {state}{extra}"),
        suspect={"collective": suspect.get("key"),
                 "axis": suspect.get("axis"),
                 "hop": suspect.get("hop")},
        citations=cites, cost_s=cost, share=share)


def _rule_hbm(ev: Evidence) -> Optional[Verdict]:
    mem = ev.data("mem")
    if not mem:
        return None
    ledger = ev.data("ledger") or {}
    ooms = int(mem.get("oom_count") or 0) \
        + int((ledger.get("exit_counts") or {}).get("oom", 0))
    hw = mem.get("high_water_frac")
    pressured = isinstance(hw, (int, float)) and hw >= 0.92
    episodes = _episodes(ev, "MEM001")
    if not (ooms or pressured or episodes):
        return None
    cites = [cite(f"{ev.run_dir}/mem-p*.jsonl", "mem.oom_count")]
    if pressured:
        cites.append(cite(f"{ev.run_dir}/mem-p*.jsonl",
                          "mem.high_water_frac"))
    if episodes:
        cites.append(cite(f"{ev.run_dir}/alerts.jsonl",
                          "MEM001.message"))
    frag = mem.get("fragmentation_bytes")
    msg = (f"{ooms} OOM event(s)" if ooms
           else f"HBM high-water {hw:.0%} of capacity")
    if isinstance(frag, (int, float)) and frag > 0:
        msg += f", {frag / 2**20:.0f} MiB fragmented"
    cost, share = (_ledger_share(ev, "restart_gap", "replayed")
                   if ooms else (None, None))
    return Verdict(
        rule="DIA003", message=msg,
        suspect={"oom_count": ooms, "high_water_frac": hw},
        citations=cites, cost_s=cost, share=share)


def _rule_fleet(ev: Evidence) -> Optional[Verdict]:
    import glob
    import json as _json
    import os

    # lost host / lost capacity first: the stronger claim
    cites: List[dict] = []
    lost = _episodes(ev, "FLT001")
    ledger = ev.data("ledger") or {}
    kills = (ledger.get("exit_counts") or {}).get("killed", 0)
    kill_deaths = [d for d in _elastic_deaths(ev)
                   if d.get("exit_class") == "killed"]
    capacity = None
    cap_path = os.path.join(ev.run_dir, "capacity.json")
    if os.path.exists(cap_path):
        try:
            with open(cap_path) as f:
                capacity = _json.load(f)
        except (OSError, ValueError):
            capacity = None
    if lost:
        host = lost[0].get("host")
        cites.append(cite(f"{ev.run_dir}/alerts.jsonl",
                          "FLT001.host"))
        return Verdict(
            rule="DIA004",
            message=f"host p{host} lost (stale heartbeat, FLT001)",
            suspect={"host": host, "kind": "lost_host"},
            citations=cites)
    # postmortem heartbeat skew: a host whose LAST heartbeat trails the
    # fleet's newest by minutes stopped reporting long before the run
    # ended — relative lag, so this works hours after the fact
    beats = {}
    for path in glob.glob(os.path.join(ev.run_dir, "heartbeat-p*.json")):
        try:
            with open(path) as f:
                hb = _json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(hb, dict) and isinstance(
                hb.get("wall_time"), (int, float)):
            beats[hb.get("process_index"), path] = hb["wall_time"]
    if len(beats) >= 2:
        newest = max(beats.values())
        (dead, dead_path), oldest = min(
            beats.items(), key=lambda kv: kv[1])
        lag = newest - oldest
        if lag > 120.0:
            cost, share = _ledger_share(ev, "stall")
            return Verdict(
                rule="DIA004",
                message=(f"host p{dead} lost: its last heartbeat "
                         f"trails the fleet's newest by {lag:.0f}s"),
                suspect={"host": dead, "kind": "lost_host"},
                citations=[cite(dead_path, "wall_time")],
                cost_s=cost, share=share)
    if capacity is not None and (kills or kill_deaths):
        cites.append(cite(cap_path, "devices"))
        cites.append(cite(
            f"{ev.run_dir}/elastic.jsonl" if kill_deaths
            else ev.run_dir, "exit_class"))
        cost, share = _ledger_share(ev, "stall", "restart_gap")
        return Verdict(
            rule="DIA004",
            message=(f"host loss: capacity dropped to "
                     f"{capacity.get('devices')} device(s) "
                     f"({capacity.get('source') or 'scheduler signal'})"),
            suspect={"kind": "lost_host",
                     "devices": capacity.get("devices")},
            citations=cites, cost_s=cost, share=share)
    # straggler: fleet skew in the measured compiled-step p50s
    strag = _episodes(ev, "STR001")
    trace = ev.data("trace") or {}
    per_host = trace.get("per_host_compiled_p50") or {}
    skew_host = None
    if len(per_host) >= 2:
        vals = sorted(per_host.values())
        median = vals[len(vals) // 2]
        worst = max(per_host, key=lambda p: per_host[p])
        if median > 0 and per_host[worst] > 1.5 * median:
            skew_host = worst
    if strag:
        host = strag[0].get("host")
        cites.append(cite(f"{ev.run_dir}/alerts.jsonl",
                          "STR001.host"))
        msg = f"host p{host} straggling (STR001)"
        suspect = {"host": host, "kind": "straggler"}
    elif skew_host is not None:
        host = skew_host
        for f in trace.get("files") or []:
            cites.append(cite(f, "span/compiled_step"))
            break
        msg = (f"host p{host} compiled_step p50 "
               f"{per_host[host] * 1e3:.1f}ms vs fleet — straggler")
        suspect = {"host": host, "kind": "straggler"}
    else:
        return None
    return Verdict(rule="DIA004", message=msg, suspect=suspect,
                   citations=cites)


def _rule_recompile(ev: Evidence) -> Optional[Verdict]:
    trace = ev.data("trace")
    if not trace:
        return None
    hits = misses = 0
    for snap in (trace.get("counters") or {}).values():
        for key, val in (snap.get("counters") or {}).items():
            if not key.startswith("jax/cache/"):
                continue
            if "miss" in key:
                misses += int(val)
            elif "hit" in key:
                hits += int(val)
    if misses < 5 or misses <= hits:
        return None
    cites = []
    for f in trace.get("files") or []:
        cites.append(cite(f, "counters.jax/cache/*"))
        break
    cost, share = _ledger_share(ev, "compile")
    return Verdict(
        rule="DIA005",
        message=(f"compilation cache missing persistently "
                 f"({misses} miss(es) vs {hits} hit(s)) — the step "
                 "program is being rebuilt instead of reloaded"),
        suspect={"cache_misses": misses, "cache_hits": hits},
        citations=cites, cost_s=cost, share=share)


def _rule_numerics(ev: Evidence) -> Optional[Verdict]:
    health = ev.data("health")
    if not health:
        return None
    nonfinite = health.get("nonfinite") or []
    anomalies = health.get("anomalies") or []
    if not nonfinite and not anomalies:
        return None
    step = (nonfinite[0]["step"] if nonfinite
            else anomalies[0].get("step"))
    cites = []
    for f in health.get("files") or []:
        cites.append(cite(f, "health.all_finite"))
        break
    for a in anomalies:
        if a.get("dir"):
            cites.append(cite(f"{a['dir']}/meta.json", "reason"))
            break
    reasons = sorted({r.get("anomaly") for r in nonfinite
                      if r.get("anomaly")}
                     | {a.get("reason") for a in anomalies
                        if a.get("reason")})
    return Verdict(
        rule="DIA006",
        message=(f"non-finite numerics first at step {step} "
                 f"({', '.join(reasons) or 'nonfinite'}; "
                 f"{len(nonfinite)} flagged step(s), "
                 f"{len(anomalies)} anomaly dump(s))"),
        suspect={"step": step, "reasons": reasons},
        citations=cites)


def _rule_checkpoint(ev: Evidence) -> Optional[Verdict]:
    refused = []
    elastic = ev.data("elastic") or {}
    for d in elastic.get("decisions") or []:
        rec = d.get("recovery")
        if isinstance(rec, dict) and rec.get("refused"):
            refused.extend(rec["refused"])
    episodes = _episodes(ev, "CKP001")
    cost, share = _ledger_share(ev, "checkpoint_save")
    stalled = isinstance(share, (int, float)) and share > 0.2
    if not (refused or episodes or stalled):
        return None
    cites = []
    if refused:
        cites.append(cite(f"{ev.run_dir}/elastic.jsonl",
                          "recovery.refused"))
    if episodes:
        cites.append(cite(f"{ev.run_dir}/alerts.jsonl",
                          "CKP001.message"))
    if stalled:
        cites.append(cite(ev.run_dir,
                          "ledger.category_seconds.checkpoint_save"))
    ledger = ev.data("ledger") or {}
    reco = ledger.get("recommendation") or {}
    if refused:
        msg = (f"{len(refused)} checkpoint(s) refused by checksum "
               "manifest during recovery")
    elif stalled:
        msg = f"checkpoint saves consume {share:.0%} of elapsed"
    else:
        msg = "checkpoint save stalls (CKP001)"
    if isinstance(reco.get("optimal_interval_steps"), (int, float)):
        msg += (f"; Young-Daly advises --checkpoint-steps "
                f"{int(reco['optimal_interval_steps'])}")
    return Verdict(
        rule="DIA007", message=msg,
        suspect={"refused": len(refused) or None,
                 "save_share": share},
        citations=cites, cost_s=cost, share=share)


def _rule_restart_churn(ev: Evidence) -> Optional[Verdict]:
    ledger = ev.data("ledger")
    if not ledger:
        return None
    failures = int(ledger.get("n_failures") or 0)
    cost, share = _ledger_share(ev, "restart_gap", "replayed")
    churning = (failures >= 3
                or (failures >= 2 and isinstance(share, (int, float))
                    and share > 0.2))
    if not churning:
        return None
    exits = {k: v for k, v in (ledger.get("exit_counts") or {}).items()
             if k != "clean" and v}
    return Verdict(
        rule="DIA008",
        message=(f"{failures} failed incarnation(s) "
                 f"({', '.join(f'{k}x{v}' for k, v in exits.items())}) "
                 "— restart gaps and replay dominate"),
        suspect={"n_failures": failures, "exit_counts": exits},
        citations=[cite(ev.run_dir, "ledger.exit_counts")],
        cost_s=cost, share=share)


def _rule_zero3(ev: Evidence) -> Optional[Verdict]:
    meta = ev.run_meta or {}
    config = meta.get("config") or {}
    zero3 = bool(config.get("zero3")) \
        or "zero3" in str(meta.get("strategy") or "")
    if not zero3:
        return None
    arts = ev.data("artifacts") or {}
    lint = arts.get("lint")
    col = int(((lint or {}).get("rule_counts") or {}).get("COL001", 0))
    if not col:
        return None
    trace = ev.data("trace") or {}
    p50 = ((trace.get("phases") or {}).get("compiled_step")
           or {}).get("p50_s")
    step = (f"; measured compiled_step p50 {p50 * 1e3:.1f}ms"
            if isinstance(p50, (int, float)) else "")
    cites = [cite(lint["path"], "rule_counts.COL001")]
    for f in trace.get("files") or []:
        cites.append(cite(f, "span/compiled_step"))
        break
    return Verdict(
        rule="DIA009",
        message=(f"zero3 schedule violates the prefetch overlap "
                 f"contract ({col} COL001 finding(s): gathers "
                 f"serialized against compute){step}"),
        suspect={"col001_findings": col},
        citations=cites)


_RULE_FNS = (
    _rule_input_bound,
    _rule_comm_bound,
    _rule_hbm,
    _rule_fleet,
    _rule_recompile,
    _rule_numerics,
    _rule_checkpoint,
    _rule_restart_churn,
    _rule_zero3,
)


def diagnose(ev: Evidence) -> List[Verdict]:
    """Run every rule; rank verdicts by priced goodput cost (unpriced
    verdicts keep registry order below the priced ones)."""
    verdicts = [v for fn in _RULE_FNS if (v := fn(ev)) is not None]
    verdicts.sort(key=lambda v: (-(v.cost_s
                                   if isinstance(v.cost_s, (int, float))
                                   else -1.0), v.rule))
    return verdicts


def likely_cause(run_dir: str) -> Optional[dict]:
    """The one-line join for ``tpu-ddp-torch watch --once`` and the elastic
    supervisor's death records: the top-ranked verdict's summary, or
    None (no suspect / no usable evidence). Never raises — callers are
    dashboards and restart loops that must keep running."""
    try:
        from tpu_ddp_torch.diagnose.evidence import gather_evidence

        verdicts = diagnose(gather_evidence(run_dir))
    except Exception:
        return None
    if not verdicts:
        return None
    top = verdicts[0]
    return {
        "rule": top.rule,
        "title": top.title,
        "message": top.message,
        "suspect": dict(top.suspect),
        "action": top.action,
    }
