"""Next-token training step for the causal LM, data parallel, one rank per
process.

Counterpart of ``tpu_ddp/train/lm_steps.py`` (``_token_nll`` :54,
``make_lm_train_step`` :60, ``create_lm_train_state`` :309). Each rank runs
the forward on its own rows of ``tokens`` ``(B, T)``, the loss (the mean
negative log-likelihood of ``logits[:, :-1]`` against ``tokens[:, 1:]``,
from a float32 ``log_softmax`` over the vocabulary) and the backward; then
the gradient sync and update of the image step, ``train/steps.py``'s
``sync_and_update``: the all-reduce mean, or the compressed ring with this
rank's error-feedback residual, or ZeRO-1's sharded update. The model has
no BatchNorm buffers. The loss is averaged over the ranks, and it is the
step's only metric, as in the JAX step. The model's ``dtype`` and ``remat``
apply as the model carries them, as in the JAX step; the loss takes the
model's float32 logits.

Not ported: the ``health`` flight recorder (the port has none yet) and
``make_sp_lm_train_step`` (sequence parallelism and ring attention).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from tpu_ddp_torch.parallel.collectives import all_reduce_mean_
from tpu_ddp_torch.parallel.runtime import world_size
from tpu_ddp_torch.train.optim import Optimizer
from tpu_ddp_torch.train.state import TrainState, create_train_state
from tpu_ddp_torch.train.steps import sync_and_update

Batch = Dict[str, torch.Tensor]


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood, float32: ``(B, T', V)``,
    ``(B, T')`` -> ``(B, T')``."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, targets[..., None])[..., 0]


def make_lm_train_step(tx: Optimizer, *, compress=None,
                       zero1=None) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, {"tokens": (B, T)}) -> (state, {"loss"})``; ``state``
    is updated in place and returned, ``tokens`` are this rank's rows.
    ``compress`` and ``zero1`` as in ``train/steps.py::make_train_step``."""

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        params = state.params()
        tokens = batch["tokens"]
        logits = model(tokens)
        loss = token_nll(logits[:, :-1], tokens[:, 1:]).mean()
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        sync_and_update(tx, state, grads, params, compress=compress, zero1=zero1)
        loss = loss.detach()
        if world_size() > 1:
            all_reduce_mean_([loss])
        return state, {"loss": loss}

    return train_step


#: the JAX function initialises the model from a dummy token batch; the
#: port's LM is initialised at construction, so ``create_train_state``
#: serves it as it is
create_lm_train_state = create_train_state
