"""Multi-label evaluation: precision/recall curves and mean average
precision.

A copy of ``tpu_ddp/metrics/evaluation.py`` (numpy only), which the port
keeps so that it imports nothing of the JAX package.

Capability parity with the reference's (non-runnable) mAP harness
(``ppe_main_ddp.py:186-221`` — it depends on a ``compute_map`` module absent
from the repo). Implemented here from scratch as pure numpy: per-class AP is
the area under the precision-recall curve computed over score-ranked
predictions (the standard "all-points" AP), and mAP averages over classes
with at least one positive.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def precision_recall_curve(
    scores: np.ndarray, targets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds) over descending score thresholds.
    `scores` float (N,), `targets` binary (N,)."""
    order = np.argsort(-scores, kind="stable")
    targets = np.asarray(targets, np.float64)[order]
    tp = np.cumsum(targets)
    fp = np.cumsum(1.0 - targets)
    n_pos = targets.sum()
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / max(n_pos, 1e-12)
    return precision, recall, np.asarray(scores)[order]


def average_precision(scores: np.ndarray, targets: np.ndarray) -> float:
    """All-points AP: sum of precision at each positive's rank / n_pos."""
    n_pos = float(np.sum(targets))
    if n_pos == 0:
        return float("nan")
    precision, recall, _ = precision_recall_curve(scores, targets)
    # integrate precision over recall steps (each positive adds 1/n_pos)
    order_targets = np.asarray(targets, np.float64)[np.argsort(-scores, kind="stable")]
    return float((precision * order_targets).sum() / n_pos)


def mean_average_precision(
    scores: np.ndarray, targets: np.ndarray
) -> Dict[str, object]:
    """scores/targets (N, C): per-class AP + mAP over classes with positives."""
    scores = np.asarray(scores)
    targets = np.asarray(targets)
    if scores.shape != targets.shape or scores.ndim != 2:
        raise ValueError(f"scores {scores.shape} and targets {targets.shape} must be "
                         "the same (N, C)")
    aps = np.array(
        [average_precision(scores[:, c], targets[:, c]) for c in range(scores.shape[1])]
    )
    valid = ~np.isnan(aps)
    return {
        "per_class_ap": aps,
        "mAP": float(aps[valid].mean()) if valid.any() else float("nan"),
    }


def multilabel_predictions(scores: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binary predictions at a score threshold (the reference thresholds
    sigmoid outputs at 0.5, ppe_main_ddp.py:355)."""
    return (scores >= threshold).astype(np.int32)
