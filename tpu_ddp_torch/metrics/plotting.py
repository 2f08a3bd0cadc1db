"""Curve plotting (matplotlib -> PNG).

Capability parity with the reference's loss-curve and precision-recall PNGs
(``ppe_main_ddp.py:176-181`` and ``:223-231``), generalized: plot from
in-memory series or from a metrics JSONL written by
``tpu_ddp_torch.metrics.logging.MetricLogger``. Headless (Agg) always.

The port's copy of ``tpu_ddp/metrics/plotting.py`` (``plot_loss_curves``,
``plot_from_jsonl``, ``plot_precision_recall``); matplotlib is imported
inside each function, so nothing on the training path needs it.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence



def _pyplot():
    """``matplotlib.pyplot`` on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss_curves(
    series: Dict[str, Sequence[float]],
    out_path: str,
    *,
    xlabel: str = "epoch",
    ylabel: str = "loss",
    title: str = "training curves",
) -> str:
    """series: name -> values (e.g. {'train_loss': [...], 'val_loss': [...]})."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, values in series.items():
        ax.plot(range(1, len(values) + 1), values, label=name)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_from_jsonl(
    jsonl_path: str,
    out_path: str,
    keys: Sequence[str] = ("train_loss", "test_loss"),
    x_key: str = "step",
) -> Optional[str]:
    """Plot metric columns from a MetricLogger JSONL file."""
    xs: Dict[str, list] = {k: [] for k in keys}
    ys: Dict[str, list] = {k: [] for k in keys}
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            for k in keys:
                if k in rec:
                    xs[k].append(rec.get(x_key, len(xs[k])))
                    ys[k].append(rec[k])
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    plotted = False
    for k in keys:
        if ys[k]:
            ax.plot(xs[k], ys[k], label=k)
            plotted = True
    if not plotted:
        plt.close(fig)
        return None
    ax.set_xlabel(x_key)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_precision_recall(
    precision, recall, out_path: str, *, label: str = "PR"
) -> str:
    """The reference's PR-curve PNG (ppe_main_ddp.py:223-231)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5.5, 5))
    ax.plot(recall, precision, label=label)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1.02)
    ax.set_ylim(0, 1.02)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
