"""k-fold cross-validation (``--cv-mode K``).

The port's copy of ``tpu_ddp/train/kfold.py`` (``kfold_split`` :20,
``run_kfold`` :40): an index split and a loop that trains a fresh model a
fold and reports each fold's validation metrics. Each fold's ``Trainer``
runs data-parallel over the ranks like any other run. The port's loop
also closes each fold's trainer once it is evaluated (its prefetcher and
its metric sinks).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def kfold_split(n: int, k: int, *, seed: int = 0,
                shuffle: bool = True) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``[(train_idx, val_idx)] * k``; folds are near-equal, disjoint and
    cover ``range(n)``."""
    if k < 2:
        raise ValueError(f"k must be >= 2, got {k}")
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    folds = np.array_split(order, k)
    out = []
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        out.append((train, val))
    return out


def run_kfold(images: np.ndarray, labels: np.ndarray, *, k: int = 5,
              make_trainer: Callable, seed: int = 0) -> List[dict]:
    """Train k models, each on k-1 folds, and validate on the held-out fold.

    ``make_trainer(train_data, val_data, fold_index)`` returns an object with
    ``run() -> metrics`` and ``evaluate() -> (acc, loss)`` (``Trainer``).
    Returns each fold's metrics with ``val_accuracy`` and ``val_loss``. A
    drained fold (SIGTERM, SIGINT) ends the loop: it carries no val
    metrics and no later fold starts."""
    results = []
    for i, (train_idx, val_idx) in enumerate(kfold_split(len(labels), k, seed=seed)):
        trainer = make_trainer((images[train_idx], labels[train_idx]),
                               (images[val_idx], labels[val_idx]), i)
        try:
            metrics = trainer.run()
            if metrics.get("preempted"):
                results.append({**metrics, "fold": i})
                break
            acc, loss = trainer.evaluate()
        finally:
            close = getattr(trainer, "close", None)
            if close is not None:
                close()
        results.append({**metrics, "fold": i, "val_accuracy": acc, "val_loss": loss})
    return results
