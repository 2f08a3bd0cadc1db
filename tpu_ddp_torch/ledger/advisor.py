"""Checkpoint-interval advisor: measured MTBF + Young–Daly optimum.

The classic first-order result (Young 1974, Daly 2006): with a
checkpoint cost of C seconds and a mean time between failures of M
seconds, the wall-clock-optimal checkpoint interval is

    t_opt = sqrt(2 * C * M)

— checkpoint much more often and the saves themselves dominate badput;
much less often and the expected replay after a failure does. The
ledger feeds this with *measured* inputs (median checkpoint-save span,
failures counted from exit classifications) and renders the verdict in
the unit the operator can act on: ``--checkpoint-steps``.

Pure stdlib math, separated from the taxonomy so it unit-tests on
hand-picked numbers.
"""

from __future__ import annotations

import math
from typing import Optional


def mtbf_seconds(elapsed_s: float,
                 n_failures: int) -> Optional[float]:
    """Mean time between failures over the stitched run; None when the
    run never failed (no interruption was observed, so the ledger has
    no basis for a failure-rate estimate — not infinity, *unknown*)."""
    if n_failures <= 0 or elapsed_s <= 0:
        return None
    return elapsed_s / n_failures


def young_daly_interval(checkpoint_cost_s: float,
                        mtbf_s: float) -> float:
    """The Young–Daly optimal seconds between checkpoint *starts*."""
    if checkpoint_cost_s <= 0 or mtbf_s <= 0:
        raise ValueError(
            "young_daly_interval needs positive checkpoint cost and "
            f"MTBF, got C={checkpoint_cost_s}, M={mtbf_s}")
    return math.sqrt(2.0 * checkpoint_cost_s * mtbf_s)


def recommend_interval(
    *,
    checkpoint_cost_s: Optional[float],
    mtbf_s: Optional[float],
    steps_per_sec: Optional[float] = None,
    current_interval_s: Optional[float] = None,
) -> Optional[dict]:
    """The advisor verdict, or None when an input is missing (the
    report says WHICH input instead of inventing numbers).

    Returns a dict with the optimal interval in seconds, in steps when
    a measured step rate exists (the ``--checkpoint-steps`` value to
    pass), the measured current cadence, and a one-line verdict."""
    if not checkpoint_cost_s or checkpoint_cost_s <= 0:
        return None
    if not mtbf_s or mtbf_s <= 0:
        return None
    interval_s = young_daly_interval(checkpoint_cost_s, mtbf_s)
    out = {
        "checkpoint_cost_s": checkpoint_cost_s,
        "mtbf_s": mtbf_s,
        "optimal_interval_s": interval_s,
    }
    if steps_per_sec and steps_per_sec > 0:
        out["optimal_interval_steps"] = max(
            1, round(interval_s * steps_per_sec))
    if current_interval_s and current_interval_s > 0:
        out["current_interval_s"] = current_interval_s
        ratio = current_interval_s / interval_s
        out["cadence_ratio"] = ratio
        if ratio > 1.5:
            verdict = (f"checkpoint ~{ratio:.1f}x more often "
                       "(current cadence risks that much replay per "
                       "failure)")
        elif ratio < 1 / 1.5:
            verdict = (f"checkpoint ~{1 / ratio:.1f}x less often "
                       "(save cost outweighs the replay it insures)")
        else:
            verdict = "current cadence is near the Young–Daly optimum"
        out["verdict"] = verdict
    else:
        out["verdict"] = (
            "no measured cadence to compare (fewer than two "
            "checkpoints observed)")
    return out
