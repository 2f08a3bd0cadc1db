"""Single-device train and eval steps.

Counterpart of ``tpu_ddp/train/steps.py`` (``_make_shard_step`` :114,
``make_train_step`` :335, ``make_eval_step`` :659) on one device: forward in
train mode (which moves the BatchNorm running stats), masked cross-entropy,
backward, the optimizer update (``Optimizer.apply``). One device's
``pmean`` is the identity, so there is no collective. The metrics stay on
the device; the caller fetches them when it needs them.

Not ported yet: augment, mixup, the health recorder, ZeRO and gradient
compression (later slices).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from tpu_ddp_torch.train.losses import cross_entropy_loss, masked_accuracy
from tpu_ddp_torch.train.optim import Optimizer
from tpu_ddp_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def batch_to_device(batch: dict, device: torch.device) -> Batch:
    """Numpy ``{image, label, mask}`` -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(tx: Optimizer) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, batch) -> (state, {"loss", "accuracy"})``; ``state`` is
    updated in place and returned."""

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        params = state.params()
        logits = model(batch["image"])
        loss = cross_entropy_loss(logits, batch["label"], batch.get("mask"))
        grads = torch.autograd.grad(loss, list(params.values()))
        tx.apply(dict(zip(params, grads)), state.opt_state, params)
        state.step += 1
        with torch.no_grad():
            correct, count = masked_accuracy(logits, batch["label"],
                                             batch.get("mask"))
            metrics = {"loss": loss.detach(),
                       "accuracy": correct / torch.clamp_min(count, 1.0)}
        return state, metrics

    return train_step


def make_eval_step() -> Callable[..., dict]:
    """``eval(state, batch, params=None) -> {correct, count, loss_sum}``:
    running-stats BatchNorm; ``params`` (the EMA shadow) replaces the
    model's params when given."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch,
                  params: Optional[Dict[str, torch.Tensor]] = None):
        model = state.model
        model.eval()
        images = batch["image"]
        logits = (model(images) if params is None
                  else functional_call(model, params, (images,)))
        mask = batch.get("mask")
        loss = cross_entropy_loss(logits, batch["label"], mask)
        correct, count = masked_accuracy(logits, batch["label"], mask)
        return {"correct": correct, "count": count, "loss_sum": loss * count}

    return eval_step
