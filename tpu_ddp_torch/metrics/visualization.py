"""Prediction visualization artifacts.

The reference's inference path draws thresholded predictions onto each image
and writes them out (``/root/reference/ppe_main_ddp.py:355-396``, cv2 box
drawing for its detection workload). The classification-apt equivalents
here: a PNG grid of test images annotated predicted-vs-true (mistakes
highlighted), and a confusion-matrix image. matplotlib only (already a
dependency via the loss-curve plots), imported inside the functions; Agg
backend so headless hosts never need a display.

The port's copy of ``tpu_ddp/metrics/visualization.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)


def _display_image(img: np.ndarray) -> np.ndarray:
    """Normalized (H, W, C) float -> [0, 1] for display (per-image min-max:
    the loader's channel normalization is not invertible here without the
    dataset constants, and display only needs contrast)."""
    img = np.asarray(img, np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def save_prediction_grid(
    images: np.ndarray,
    labels: np.ndarray,
    preds: np.ndarray,
    path: str,
    *,
    class_names: Optional[Sequence[str]] = None,
    max_images: int = 64,
) -> str:
    """PNG grid: each cell one test image titled "pred/true", mistakes in
    red — the ppe_main_ddp.py:355-396 analogue for classification."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(len(images), max_images)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(1.6 * cols, 1.8 * rows))
    axes = np.atleast_1d(axes).ravel()
    names = class_names or [str(i) for i in range(int(labels.max()) + 1)]
    for i in range(n):
        ax = axes[i]
        ax.imshow(_display_image(images[i]))
        ok = int(preds[i]) == int(labels[i])
        ax.set_title(
            f"{names[int(preds[i])]}\n({names[int(labels[i])]})",
            fontsize=7,
            color="black" if ok else "red",
        )
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts, rows = true class."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (np.asarray(labels, int), np.asarray(preds, int)), 1)
    return cm


def save_confusion_matrix(
    labels: np.ndarray,
    preds: np.ndarray,
    path: str,
    *,
    num_classes: int,
    class_names: Optional[Sequence[str]] = None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = confusion_matrix(labels, preds, num_classes)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    names = class_names or [str(i) for i in range(num_classes)]
    ax.set_xticks(range(num_classes), names, rotation=45, ha="right",
                  fontsize=7)
    ax.set_yticks(range(num_classes), names, fontsize=7)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    thresh = cm.max() / 2 if cm.max() else 0
    for i in range(num_classes):
        for j in range(num_classes):
            ax.text(j, i, int(cm[i, j]), ha="center", va="center",
                    fontsize=6,
                    color="white" if cm[i, j] > thresh else "black")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_prediction_artifacts(
    images: np.ndarray,
    labels: np.ndarray,
    preds: np.ndarray,
    out_dir: str,
    *,
    num_classes: int,
    class_names: Optional[Sequence[str]] = None,
) -> dict:
    """Both artifacts under ``out_dir``; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    if class_names is None and num_classes == 10:
        class_names = CIFAR10_CLASSES
    grid = save_prediction_grid(
        images, labels, preds, os.path.join(out_dir, "predictions.png"),
        class_names=class_names,
    )
    cm = save_confusion_matrix(
        labels, preds, os.path.join(out_dir, "confusion_matrix.png"),
        num_classes=num_classes, class_names=class_names,
    )
    return {"grid": grid, "confusion_matrix": cm}
