"""Train state: step, model (params and BatchNorm buffers) and optimizer
state, travelling together.

Counterpart of ``tpu_ddp/train/state.py`` (``TrainState`` :24,
``create_train_state`` :52). JAX's state is an immutable pytree; here the
model's tensors and the optimizer state are updated in place by the step.
``grad_residual`` is this rank's error-feedback residual of the compressed
gradient ring (``parallel/compression.py``): one f32 ``(padded,)`` tensor
per param, or ``None`` without error feedback.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from tpu_ddp_torch.train.optim import OptState, Optimizer


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor          # int64 scalar on the model's device
    model: nn.Module
    opt_state: OptState
    grad_residual: Optional[Dict[str, torch.Tensor]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx: Optimizer,
                       device: torch.device, zero1=None) -> TrainState:
    """Move ``model`` (initialised from its own seeded generator) to
    ``device`` and build the optimizer state for its params: replicated, or
    under ZeRO-1 (``zero1``, a ``parallel.zero.Zero1Partition``) this rank's
    shards of it, built in shard space."""
    model = model.to(device)
    params = dict(model.named_parameters())
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        model=model,
        opt_state=tx.init(params) if zero1 is None else zero1.init_opt_state(params),
    )
