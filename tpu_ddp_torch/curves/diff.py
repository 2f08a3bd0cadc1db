"""Step-aligned paired A/B curve comparison — the overlay-parity oracle.

``tpu-ddp-torch curves diff runA runB --tolerance T`` answers the question
every perf change must answer before it lands: *did this overlay change
what the model learns?* Two runs of the SAME seed and data differing in
exactly one program property (``--grad-compress`` on/off, a new hand-written
kernel, ZeRO re-sharding) are compared point-for-point on their shared
sampled steps:

- **smoothed trajectory drift** — gated: ``max |smooth(loss_a) -
  smooth(loss_b)|`` over the aligned steps (centered rolling mean,
  ``smooth_window`` sampled points) must stay within the absolute
  tolerance. Smoothing is what makes the oracle a TRAJECTORY verdict:
  per-batch quantization noise on a healthy int8 run decorrelates the
  raw per-step losses by a few hundredths (reported, not gated), while
  a genuine divergence moves the smoothed curve by whole units. This
  is the same 20-step/0.05 discipline ``make compress-demo`` pinned by
  hand since PR 4, now shared as one oracle;
- **final eval loss drift** — gated at ``eval_tolerance`` (default 3×
  the trajectory tolerance: one evaluation point at the churniest end
  of training carries more variance than the smoothed curve) when both
  runs evaluated;
- **non-finite asymmetry** — gated exactly: a NaN step on one side only
  is never parity;
- final eval ACCURACY delta — reported, not gated: argmax accuracy is a
  step function and jitters at small scale where the loss doesn't
  (docs/curves.md).

Mismatched quality digests are a note, not a refusal — comparing ACROSS
an overlay flip is the point, and the note names what differed.
Stdlib-only.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def _series(curve: dict) -> Dict[int, Optional[float]]:
    return dict(zip(curve.get("steps") or [], curve.get("loss") or []))


def _smooth(values: List[float], window: int) -> List[float]:
    """Centered rolling mean (window clipped at the edges)."""
    half = max(window, 1) // 2
    return [
        sum(values[max(0, i - half):i + half + 1])
        / len(values[max(0, i - half):i + half + 1])
        for i in range(len(values))
    ]


def diff_curves(a: dict, b: dict, *, tolerance: float = 0.05,
                eval_tolerance: Optional[float] = None,
                smooth_window: int = 5) -> dict:
    """Compare two curve records; returns the verdict dict
    (``verdict`` "pass"/"fail", ``regressions`` naming every gate that
    tripped, drift figures, notes). Raises ``ValueError`` when the
    curves share fewer than 2 sampled steps (nothing to align)."""
    if tolerance <= 0:
        raise ValueError(f"tolerance must be > 0, got {tolerance}")
    if smooth_window < 1:
        raise ValueError(
            f"smooth_window must be >= 1, got {smooth_window}")
    if eval_tolerance is None:
        eval_tolerance = 3 * tolerance
    sa, sb = _series(a), _series(b)
    common = sorted(set(sa) & set(sb))
    if len(common) < 2:
        raise ValueError(
            f"curves share only {len(common)} sampled step(s) — "
            "re-extract both with the same --stride (and check the runs "
            "trained comparable step counts)")

    regressions: List[str] = []
    notes: List[str] = []

    qa, qb = a.get("quality_digest"), b.get("quality_digest")
    if qa and qb and qa != qb:
        notes.append(
            f"quality digests differ ({qa} vs {qb}): comparing across a "
            "recipe/overlay change — that is what this verdict is for")
    if a.get("seed") != b.get("seed"):
        notes.append(
            f"seeds differ ({a.get('seed')} vs {b.get('seed')}): "
            "seed noise joins the drift; prefer same-seed pairs for "
            "overlay parity")

    # non-finite asymmetry gates exactly
    na = int(a.get("nonfinite_steps") or 0)
    nb = int(b.get("nonfinite_steps") or 0)
    if na != nb:
        regressions.append(
            f"non-finite steps differ: {na} vs {nb} (a NaN on one side "
            "only is never parity)")

    pairs = [(step, sa[step], sb[step]) for step in common
             if _finite(sa[step]) and _finite(sb[step])]
    if len(pairs) < 2:
        raise ValueError(
            "fewer than 2 aligned finite loss points — both runs must "
            "record finite per-step loss (--health on)")
    steps_aligned = [p[0] for p in pairs]
    raw = [abs(va - vb) for _, va, vb in pairs]
    raw_max = max(raw)
    raw_step = steps_aligned[raw.index(raw_max)]
    smooth_a = _smooth([va for _, va, _ in pairs], smooth_window)
    smooth_b = _smooth([vb for _, _, vb in pairs], smooth_window)
    smoothed = [abs(x - y) for x, y in zip(smooth_a, smooth_b)]
    max_drift = max(smoothed)
    drift_step = steps_aligned[smoothed.index(max_drift)]
    if max_drift > tolerance:
        regressions.append(
            f"smoothed loss-trajectory drift {max_drift:.6f} > "
            f"tolerance {tolerance} (worst at step {drift_step}, "
            f"rolling mean over {smooth_window} sampled points)")

    ela, elb = a.get("final_eval_loss"), b.get("final_eval_loss")
    eval_loss_delta: Optional[float] = None
    if _finite(ela) and _finite(elb):
        eval_loss_delta = abs(float(ela) - float(elb))
        if eval_loss_delta > eval_tolerance:
            regressions.append(
                f"final eval loss drift {eval_loss_delta:.6f} > "
                f"eval tolerance {eval_tolerance:g} "
                f"({ela:.4f} vs {elb:.4f})")

    eaa, eab = a.get("final_eval_accuracy"), b.get("final_eval_accuracy")
    acc_delta: Optional[float] = None
    if _finite(eaa) and _finite(eab):
        acc_delta = abs(float(eaa) - float(eab))

    return {
        "verdict": "fail" if regressions else "pass",
        "tolerance": tolerance,
        "eval_tolerance": eval_tolerance,
        "smooth_window": smooth_window,
        "steps_compared": len(pairs),
        "max_loss_drift": max_drift,
        "drift_step": drift_step,
        "raw_max_loss_drift": raw_max,
        "raw_drift_step": raw_step,
        "final_eval_loss_delta": eval_loss_delta,
        "final_eval_accuracy_delta": acc_delta,
        "nonfinite_steps": [na, nb],
        "regressions": regressions,
        "notes": notes,
    }


def render_diff(result: dict, label_a: str, label_b: str) -> str:
    lines = [f"curves diff: {label_a} vs {label_b}"]
    lines.append(
        f"aligned steps: {result['steps_compared']}   smoothed "
        f"trajectory drift {result['max_loss_drift']:.6f}"
        + (f" @ step {result['drift_step']}"
           if result.get("drift_step") is not None else "")
        + f"   tolerance {result['tolerance']}")
    lines.append(
        f"raw per-step drift {result['raw_max_loss_drift']:.6f}"
        + (f" @ step {result['raw_drift_step']}"
           if result.get("raw_drift_step") is not None else "")
        + f" (reported; the gate smooths over {result['smooth_window']} "
        "points)")
    if result.get("final_eval_loss_delta") is not None:
        lines.append(
            f"final eval loss delta: "
            f"{result['final_eval_loss_delta']:.6f}")
    if result.get("final_eval_accuracy_delta") is not None:
        lines.append(
            f"final eval accuracy delta: "
            f"{result['final_eval_accuracy_delta']:.4f} (reported, not "
            "gated — argmax accuracy is a step function)")
    for note in result.get("notes") or []:
        lines.append(f"note: {note}")
    if result["regressions"]:
        lines.append(f"REGRESSIONS ({len(result['regressions'])}):")
        lines.extend(f"  {r}" for r in result["regressions"])
        lines.append("verdict: FAIL")
    else:
        lines.append("verdict: PASS (trajectories match within tolerance)")
    return "\n".join(lines)
