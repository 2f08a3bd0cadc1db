"""Masked cross-entropy, binary cross-entropy and accuracy.

Counterpart of ``tpu_ddp/train/losses.py`` (``cross_entropy_loss`` :20,
``binary_cross_entropy_with_logits`` :39, ``combine_aux_loss`` :48,
``masked_accuracy`` :63): the
reference's ``nn.CrossEntropyLoss()`` with an optional validity mask, so the
wrap-padded rows of a static-shape batch do not count, and the multi-label
fine-tune's BCE on multi-hot targets (``ppe_main_ddp.py:147``), masked the
same way.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, *,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    log_probs = F.log_softmax(logits, dim=-1)
    true_lp = torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        # soft target: (1-s) on the true class, s/K spread over all classes
        n = logits.shape[-1]
        nll = -((1.0 - label_smoothing) * true_lp
                + (label_smoothing / n) * log_probs.sum(dim=-1))
    else:
        nll = -true_lp
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over classes, then over the (valid) rows, of the numerically
    stable ``max(x, 0) - x * t + log1p(exp(-|x|))``, expression for
    expression as the JAX function."""
    per = (torch.clamp_min(logits, 0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    per = per.mean(dim=-1)
    if mask is None:
        return per.mean()
    mask = mask.to(per.dtype)
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def combine_aux_loss(task: torch.Tensor, sown: Dict[str, torch.Tensor], aux_weight: float):
    """Fold the auxiliary losses a model kept in its forward (``sown``:
    ``models/moe.py::sown_aux_losses``, the MoE router's load-balance terms)
    into the differentiated objective: ``(total, aux)``, ``aux`` their sum in
    the JAX tree's key order and None when the model kept none (the JAX
    ``combine_aux_loss``, shared by every step builder)."""
    if not sown:
        return task, None
    keys = sorted(sown)
    aux = sown[keys[0]]
    for k in keys[1:]:
        aux = aux + sown[k]
    return task + aux_weight * aux, aux


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """(correct_count, valid_count) as float32 tensors — summable across
    batches without a host sync."""
    correct = (logits.argmax(dim=-1) == labels).to(torch.float32)
    if mask is None:
        return correct.sum(), torch.tensor(float(correct.numel()),
                                           device=correct.device)
    mask = mask.to(torch.float32)
    return (correct * mask).sum(), mask.sum()
