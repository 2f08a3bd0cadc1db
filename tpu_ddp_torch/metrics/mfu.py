"""Model FLOPs Utilization (MFU).

Counterpart of ``tpu_ddp/metrics/mfu.py`` (``mfu``, ``record_mfu``) and of
the peak lookup it re-exports (``tpu_ddp/analysis/roofline.py:104-113``).
MFU is a step's FLOPs over the card's peak rate, at the measured steps a
second:

- **FLOPs a step** (``flops_per_step``, in place of the JAX
  ``compiled_flops``, which asks XLA's cost model of the compiled step):
  one forward and backward of the run's loss counted by
  ``torch.utils.flop_counter.FlopCounterMode`` on a copy of the model that
  the caller's factory builds on the ``meta`` device (the trainer's
  ``_compute_mfu``: from the run's config), at the run's batch shape and
  compute dtype. Nothing is allocated and the card is not touched. A tied
  block is counted once a use, as XLA counts it. The flash kernels K4–K6
  are opaque to the counter, so the trainer builds the copy with
  ``attention="full"``: a flash run's FLOPs are its model's. A count that
  fails on a card with a known peak is logged, and MFU is then None. The
  optimizer's elementwise work and ``--remat``'s recompute are not counted
  (XLA's count of the whole step has both). A rank of a model group (sp, tp, pp, ep) is charged its
  group's share of its data shard's rows.
- **Peak** (``peak_flops_per_chip``, re-exported from
  ``analysis/roofline.py`` as the JAX module re-exports it): the dense
  bfloat16 tensor-core rate of the card, whatever the compute dtype, as the
  JAX package quotes MFU against the bfloat16 peak. The chip table's card
  is the H100 SXM; the CPU, and a card the table does not hold, give None,
  and then no ``train/mfu`` gauge is written.
"""

from __future__ import annotations

from typing import Optional

from tpu_ddp_torch.analysis.roofline import CHIP_SPECS, peak_flops_per_chip  # noqa: F401

#: ``torch.cuda.get_device_name()`` -> dense bfloat16 tensor-core FLOP/s of
#: the card, read from the one chip table (``analysis/roofline.py``)
PEAK_BF16_FLOPS = {CHIP_SPECS["h100"].description: CHIP_SPECS["h100"].peak_bf16_flops}


def flops_per_step(build, rows: int, *, image_size: int = 32, num_classes: int = 10,
                   loss: str = "ce", share: float = 1.0) -> float:
    """FLOPs of one training step at ``rows`` images of ``image_size``
    (module docstring), times ``share`` (a rank's part of its model group's
    work). ``build()`` returns the model; it is called on the ``meta``
    device, and the caller builds the copy with full attention. ``loss``
    and ``num_classes`` pick the loss and its labels as the run does.
    Whatever the build or the counter raises goes to the caller."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_ddp_torch.train.losses import binary_cross_entropy_with_logits, cross_entropy_loss

    with torch.device("meta"):
        model = build()
        model.train()
        images = torch.empty(rows, image_size, image_size, 3)
        mask = torch.ones(rows, dtype=torch.bool)
        if loss == "bce":
            labels = torch.empty(rows, num_classes)
            loss_fn = binary_cross_entropy_with_logits
        else:
            labels = torch.zeros(rows, dtype=torch.int32)
            loss_fn = cross_entropy_loss
        with FlopCounterMode(display=False) as counter:
            loss_fn(model(images), labels, mask).backward()
    return float(counter.get_total_flops()) * share


def mfu(flops_per_call: Optional[float], calls_per_sec: float,
        device=None) -> Optional[float]:
    """Fraction of peak: ``flops_per_call * calls_per_sec / peak``; None
    without a FLOP count or a peak (the JAX ``mfu``)."""
    peak = peak_flops_per_chip(device)
    if flops_per_call is None or peak is None or calls_per_sec <= 0:
        return None
    return flops_per_call * calls_per_sec / peak


def record_mfu(registry, mfu_value: Optional[float]) -> None:
    """Publish MFU as the ``train/mfu`` gauge (skipped when there is none:
    the CPU)."""
    if mfu_value is not None:
        registry.gauge("train/mfu").set(mfu_value)
