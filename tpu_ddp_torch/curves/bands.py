"""Seed-band baselines and the CRV trajectory-regression rules.

A *seed band* is the per-step median + k×MAD envelope of N baseline
runs that share a ``quality_digest`` (the seed-invariant recipe key —
``telemetry/provenance.py``): same learning recipe, different seeds.
Robust statistics, like every detector in-tree (health spikes, monitor
stragglers, registry trend): one odd seed cannot drag the envelope the
way mean/std would, and the MAD is floored at a fraction of |median| so
a recipe whose seeds agree tightly doesn't flag ordinary jitter.

A candidate run is judged against the band with lint-``RULES``-style
findings (stable id + severity + fix hint — the single source behind
the report, the docs/curves.md table, and the CI demo's exact-id
assertions):

- CRV001  final eval metric below the band          (critical)
- CRV002  loss left the envelope >= W consecutive sampled points
                                                    (critical)
- CRV003  time-to-target-loss slower than the band  (warning)
- CRV004  non-finite / divergent trajectory         (critical)

Baselines come from the perf registry: ``band_from_registry`` pools the
newest clean kind-"curves" entries sharing the candidate's quality
digest and device kind — which is why ``tpu-ddp-torch curves --against
<registry>`` needs no hand-pointed baseline files. Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Tuple

#: rule registry: id -> (what it catches, severity, fix hint) — the
#: single source behind findings and the docs/curves.md table
RULES: Dict[str, Dict[str, str]] = {
    "CRV001": {
        "title": "final eval metric below the seed band",
        "severity": "critical",
        "fix": "the run converged measurably worse than the archived "
               "seeds of this recipe: diff it against a baseline run "
               "(`tpu-ddp-torch curves diff`), then bisect what changed — an "
               "overlay (--zero1/--grad-compress), a kernel, a data "
               "pipeline edit. Genuine recipe changes need re-baselining "
               "(record fresh runs under the new quality digest)",
    },
    "CRV002": {
        "title": "loss left the seed envelope",
        "severity": "critical",
        "fix": "the loss sat outside median+k*MAD of the baselines for "
               ">= W consecutive sampled steps — a trajectory-level "
               "divergence, not end-point noise: check `tpu-ddp-torch health` "
               "for the first excursion step, and whether a numerics "
               "overlay (compression error feedback, bf16) regressed",
    },
    "CRV003": {
        "title": "time-to-target slower than the band",
        "severity": "warning",
        "fix": "the run reached the band's target loss, but took "
               "measurably more steps than the baselines: same final "
               "quality, slower learning — usually an effective-lr or "
               "batch-schedule drift; compare optimizer/schedule config "
               "against a baseline entry (`tpu-ddp-torch registry show`)",
    },
    "CRV004": {
        "title": "non-finite / divergent trajectory",
        "severity": "critical",
        "fix": "the candidate recorded NaN/Inf steps (or a non-finite "
               "final loss): `tpu-ddp-torch health <run_dir>` has the "
               "sentinel timeline and the anomaly dump with the "
               "offending batch; consider --health-policy skip_step "
               "and --grad-clip-norm while bisecting",
    },
}


@dataclasses.dataclass
class BandConfig:
    """Envelope knobs (mirrors the health ``SpikeDetector`` shape)."""

    k: float = 6.0            # envelope half-width in MADs
    floor_frac: float = 0.02  # MAD floor as a fraction of |median|
    exit_window: int = 3      # W: consecutive sampled points outside
                              # the envelope before CRV002 fires
    min_runs: int = 3         # baselines required to build a band

    def validate(self) -> "BandConfig":
        if self.k <= 0:
            raise ValueError(f"k must be > 0, got {self.k}")
        if not 0 <= self.floor_frac < 1:
            raise ValueError(
                f"floor_frac must be in [0, 1), got {self.floor_frac}")
        if self.exit_window < 1:
            raise ValueError(
                f"exit_window must be >= 1, got {self.exit_window}")
        if self.min_runs < 2:
            raise ValueError(
                f"min_runs must be >= 2 (one run is not a band), got "
                f"{self.min_runs}")
        return self


@dataclasses.dataclass
class SeedBand:
    """The envelope N seeded baselines of one recipe trace out."""

    quality_digest: Optional[str]
    device_kind: Optional[str]
    n_runs: int
    run_ids: List[str]
    steps: List[int]
    loss_median: List[float]
    loss_upper: List[float]
    loss_lower: List[float]
    #: final-metric stats: {"metric", "median", "spread"} — metric is
    #: "final_eval_accuracy" (gated BELOW median-spread) when the
    #: baselines evaluated, else "final_train_loss" (gated above)
    final: Optional[dict] = None
    #: the band's target loss (median of baseline final losses) and the
    #: steps-to-reach-it stats of the baselines that got there
    target_loss: Optional[float] = None
    time_to_target: Optional[dict] = None   # {"median", "limit", "n"}
    notes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Finding:
    """One CRV verdict on a candidate curve."""

    rule: str
    severity: str
    message: str
    value: Optional[float] = None
    step: Optional[int] = None

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["title"] = RULES[self.rule]["title"]
        rec["fix"] = RULES[self.rule]["fix"]
        return rec

    def render(self) -> str:
        at = f" @ step {self.step}" if self.step is not None else ""
        return (f"{self.rule} [{self.severity}]{at}: {self.message}\n"
                f"    fix: {RULES[self.rule]['fix']}")


def _spread(values: List[float], k: float, floor_frac: float,
            abs_floor: float = 1e-9) -> Tuple[float, float]:
    """(median, k * floored MAD) of a value list."""
    med = statistics.median(values)
    mad = statistics.median(abs(v - med) for v in values)
    return med, k * max(mad, floor_frac * abs(med), abs_floor)


def _finite_series(curve: dict) -> Dict[int, float]:
    """{step: loss} of a curve's finite sampled points."""
    out: Dict[int, float] = {}
    for step, loss in zip(curve.get("steps") or [],
                          curve.get("loss") or []):
        if isinstance(loss, (int, float)) and math.isfinite(loss):
            out[step] = float(loss)
    return out


def _time_to_target(curve: dict, target: float) -> Optional[int]:
    """First sampled step at which the loss reached ``target`` (None =
    never got there)."""
    for step, loss in zip(curve.get("steps") or [],
                          curve.get("loss") or []):
        if isinstance(loss, (int, float)) and math.isfinite(loss) \
                and loss <= target:
            return step
    return None


def build_band(curves: List[dict],
               config: Optional[BandConfig] = None) -> SeedBand:
    """Pool baseline curve records into a :class:`SeedBand`.

    Refuses (``ValueError``, named reason) fewer than ``min_runs``
    baselines, baselines with mixed quality digests (an envelope across
    different recipes is meaningless), and baselines with no common
    sampled steps.
    """
    cfg = (config or BandConfig()).validate()
    if len(curves) < cfg.min_runs:
        raise ValueError(
            f"seed band needs >= {cfg.min_runs} baseline runs, got "
            f"{len(curves)} — record more seeds of this recipe "
            "(`tpu-ddp-torch curves <run_dir> --json` + `registry record`)")
    digests = {c.get("quality_digest") for c in curves}
    if len(digests) > 1:
        raise ValueError(
            "baseline curves span multiple quality digests "
            f"({', '.join(sorted(str(d) for d in digests))}) — a band "
            "is defined per recipe; filter to one digest first")

    series = [_finite_series(c) for c in curves]
    common = sorted(set.intersection(*(set(s) for s in series)))
    if not common:
        raise ValueError(
            "baseline curves share no sampled steps (mismatched strides "
            "or empty health records) — re-extract with one --stride")

    notes: List[str] = []
    med_l: List[float] = []
    up_l: List[float] = []
    lo_l: List[float] = []
    for step in common:
        med, spread = _spread([s[step] for s in series],
                              cfg.k, cfg.floor_frac)
        med_l.append(med)
        up_l.append(med + spread)
        lo_l.append(med - spread)

    # final metric: accuracy when every baseline evaluated (finitely —
    # one NaN accuracy would poison the median and disarm CRV001 for
    # every future candidate), else the final train loss (always
    # present — health records it)
    accs = [c.get("final_eval_accuracy") for c in curves]
    final: Optional[dict] = None
    if all(isinstance(a, (int, float)) and math.isfinite(a)
           for a in accs):
        med, spread = _spread([float(a) for a in accs],
                              cfg.k, cfg.floor_frac)
        final = {"metric": "final_eval_accuracy",
                 "median": med, "spread": spread}
    else:
        losses = [c.get("final_train_loss") for c in curves]
        finite = [float(v) for v in losses
                  if isinstance(v, (int, float)) and math.isfinite(v)]
        if len(finite) == len(curves):
            med, spread = _spread(finite, cfg.k, cfg.floor_frac)
            final = {"metric": "final_train_loss",
                     "median": med, "spread": spread}
        else:
            notes.append("a baseline has no finite final loss: the "
                         "final-metric gate (CRV001) is disabled")

    # target loss: the median of the baselines' final losses. Baselines
    # whose own final loss sits above it never reach it — expected; the
    # time-to-target stats pool the ones that did.
    target: Optional[float] = None
    ttt: Optional[dict] = None
    final_losses = [s[common[-1]] for s in series]
    if final_losses:
        target = statistics.median(final_losses)
        reached = [t for c in curves
                   if (t := _time_to_target(c, target)) is not None]
        if len(reached) >= 2:
            med, spread = _spread([float(t) for t in reached],
                                  cfg.k, cfg.floor_frac, abs_floor=1.0)
            ttt = {"median": med, "limit": med + spread,
                   "n": len(reached)}
        else:
            notes.append("fewer than 2 baselines reached the target "
                         "loss: the time-to-target gate (CRV003) is "
                         "disabled")

    return SeedBand(
        quality_digest=next(iter(digests)),
        device_kind=next((c.get("device_kind") for c in curves
                          if c.get("device_kind")), None),
        n_runs=len(curves),
        run_ids=[str(c.get("run_id")) for c in curves],
        steps=common,
        loss_median=med_l,
        loss_upper=up_l,
        loss_lower=lo_l,
        final=final,
        target_loss=target,
        time_to_target=ttt,
        notes=notes,
    )


def judge_curve(curve: dict, band: SeedBand,
                config: Optional[BandConfig] = None) -> List[Finding]:
    """Judge a candidate curve against a band; returns the findings
    (empty = within the band) and ANNOTATES the candidate record with
    the judgment's derived fields (``target_loss``,
    ``time_to_target_steps``, ``rule_counts``) so its ``--json``
    artifact carries exactly what ``bench compare`` / ``registry
    trend`` gate."""
    cfg = (config or BandConfig()).validate()
    findings: List[Finding] = []

    # CRV004 — non-finite/divergence: its own class, judged before the
    # envelope (NaN points are invisible to the step alignment)
    nonfinite = int(curve.get("nonfinite_steps") or 0)
    sampled_nonfinite = sum(
        1 for v in (curve.get("loss") or [])
        if v is not None and not math.isfinite(v))
    if nonfinite > 0 or sampled_nonfinite > 0:
        findings.append(Finding(
            rule="CRV004", severity=RULES["CRV004"]["severity"],
            message=(f"{max(nonfinite, sampled_nonfinite)} non-finite "
                     "step(s) recorded in the trajectory"),
            value=float(max(nonfinite, sampled_nonfinite)),
        ))

    # CRV002 — loss exits the envelope for >= W consecutive sampled
    # points (above only: a run tracking BELOW the band is learning
    # faster than its baselines, which is a note, not a defect)
    cand = _finite_series(curve)
    upper = dict(zip(band.steps, band.loss_upper))
    run = 0
    worst: Optional[Tuple[int, float, float]] = None  # (step, loss, up)
    fired = False
    for step in band.steps:
        if step not in cand:
            continue
        if cand[step] > upper[step]:
            run += 1
            if worst is None or cand[step] - upper[step] > \
                    worst[1] - worst[2]:
                worst = (step, cand[step], upper[step])
            if run >= cfg.exit_window and not fired:
                fired = True
        else:
            run = 0
    if fired and worst is not None:
        findings.append(Finding(
            rule="CRV002", severity=RULES["CRV002"]["severity"],
            message=(f"loss sat above the seed envelope for >= "
                     f"{cfg.exit_window} consecutive sampled steps "
                     f"(worst: {worst[1]:.4f} vs upper bound "
                     f"{worst[2]:.4f})"),
            value=worst[1], step=worst[0],
        ))

    # CRV001 — final metric below the band
    if band.final is not None:
        metric = band.final["metric"]
        med, spread = band.final["median"], band.final["spread"]
        v = curve.get(metric)
        if metric == "final_train_loss" and not isinstance(
                v, (int, float)):
            v = cand[max(cand)] if cand else None
        if isinstance(v, (int, float)) and math.isfinite(v):
            if metric == "final_eval_accuracy":
                bad = v < med - spread
                rel = f"{v:.4f} < band floor {med - spread:.4f}"
            else:
                bad = v > med + spread
                rel = f"{v:.4f} > band ceiling {med + spread:.4f}"
            if bad:
                findings.append(Finding(
                    rule="CRV001",
                    severity=RULES["CRV001"]["severity"],
                    message=(f"{metric} {rel} (band median {med:.4f} "
                             f"over {band.n_runs} seed(s))"),
                    value=float(v),
                ))
        elif v is None:
            # fail closed: the baselines all carry the metric, the
            # candidate doesn't (crashed before its first eval, or the
            # eval history was lost) — the end-state gate must not pass
            # by omission
            findings.append(Finding(
                rule="CRV001", severity=RULES["CRV001"]["severity"],
                message=(f"{metric} is missing from the candidate "
                         f"(never evaluated?) while all {band.n_runs} "
                         "baselines carry it — the final-metric gate "
                         "cannot pass by omission"),
            ))
        else:
            findings.append(Finding(
                rule="CRV004", severity=RULES["CRV004"]["severity"],
                message=f"{metric} is non-finite",
            ))

    # CRV003 — reached the target, but slower than the band. A run that
    # NEVER reaches the target is CRV001/CRV002's business (its end
    # state is bad), not a "slower" verdict.
    cand_ttt: Optional[int] = None
    if band.target_loss is not None:
        cand_ttt = _time_to_target(curve, band.target_loss)
        if (band.time_to_target is not None and cand_ttt is not None
                and cand_ttt > band.time_to_target["limit"]):
            findings.append(Finding(
                rule="CRV003", severity=RULES["CRV003"]["severity"],
                message=(f"target loss {band.target_loss:.4f} reached "
                         f"at step {cand_ttt} vs band median "
                         f"{band.time_to_target['median']:.0f} (limit "
                         f"{band.time_to_target['limit']:.0f})"),
                value=float(cand_ttt), step=cand_ttt,
            ))

    curve["target_loss"] = band.target_loss
    curve["time_to_target_steps"] = cand_ttt
    counts = {rule: 0 for rule in RULES}
    for f in findings:
        counts[f.rule] += 1
    curve["rule_counts"] = counts
    return findings


def band_from_registry(
    registry_dir: str,
    *,
    quality_digest: Optional[str],
    device_kind: Optional[str],
    config: Optional[BandConfig] = None,
    exclude_run_id: Optional[str] = None,
    allow_dirty: bool = False,
    max_baselines: int = 16,
) -> Tuple[Optional[SeedBand], Optional[str]]:
    """Build the band from archived kind-"curves" registry entries
    matching the candidate's (quality digest, device kind). Returns
    ``(band, None)`` or ``(None, named_refusal)`` — like the registry's
    ``select_baseline``, a gate that silently passes for lack of a
    baseline is how regressions slip in.

    Entries are filtered to clean checkouts (unless ``allow_dirty``),
    judged-failed baselines (a nonzero critical CRV count in the
    archived record) are excluded, the candidate's own run never
    baselines itself, and the newest ``max_baselines`` entries win."""
    from tpu_ddp_torch.registry.store import read_entries

    cfg = (config or BandConfig()).validate()
    if not quality_digest:
        return None, ("candidate curve carries no quality_digest (run "
                      "recorded before provenance stamping, or an "
                      "anonymous trace) — cannot key a seed band")
    entries = read_entries(registry_dir)
    if not entries:
        return None, f"registry {registry_dir!r} is empty"
    pool: List[dict] = []
    seen_run_ids = set()
    for e in entries:
        if e.artifact_kind != "curves":
            continue
        rec = (e.programs or {}).get("curves")
        if not isinstance(rec, dict):
            continue
        if rec.get("quality_digest") != quality_digest:
            continue
        if device_kind and rec.get("device_kind") != device_kind:
            continue
        if not allow_dirty and not e.clean:
            continue
        if exclude_run_id and rec.get("run_id") == exclude_run_id:
            continue
        counts = rec.get("rule_counts") or {}
        if any(counts.get(r) for r in RULES
               if RULES[r]["severity"] == "critical"):
            continue  # a judged-failed run must not widen the band
        rid = rec.get("run_id")
        if rid in seen_run_ids:
            continue  # one vote per run, however often it was recorded
        seen_run_ids.add(rid)
        pool.append(rec)
    if len(pool) < cfg.min_runs:
        kinds = sorted({e.artifact_kind for e in entries})
        return None, (
            f"only {len(pool)} usable baseline curve(s) match quality "
            f"digest {quality_digest} on {device_kind or 'any device'} "
            f"(need >= {cfg.min_runs}; registry holds "
            f"{len(entries)} entr"
            f"{'y' if len(entries) == 1 else 'ies'} of kinds: "
            f"{', '.join(kinds)}) — record more seeds of this recipe")
    pool = pool[-max_baselines:]
    try:
        return build_band(pool, cfg), None
    except ValueError as e:
        return None, str(e)
