"""Next-token training step for the causal LM, data parallel, one rank per
process.

Counterpart of ``tpu_ddp/train/lm_steps.py`` (``_token_nll`` :54,
``make_lm_train_step`` :60, ``create_lm_train_state`` :309). Each rank runs
the forward on its own rows of ``tokens`` ``(B, T)``, the loss (the mean
negative log-likelihood of ``logits[:, :-1]`` against ``tokens[:, 1:]``,
from a float32 ``log_softmax`` over the vocabulary) and the backward; then
the gradient sync and update of the image step, ``train/steps.py``'s
``sync_and_update``: the all-reduce mean, or the compressed ring with this
rank's error-feedback residual, or ZeRO-1's or ZeRO-3's sharded update
(ZeRO-3 streams the params through the forward as the image step does;
the JAX LM step has no zero3 branch, the port's shares the image step's
tail). The model has
no BatchNorm buffers. The loss is averaged over the ranks, and it is the
step's only metric, as in the JAX step. The model's ``dtype`` and ``remat``
apply as the model carries them, as in the JAX step; the loss takes the
model's float32 logits.

``health`` adds the flight recorder (the JAX ``_with_health`` :38 and
``make_lm_train_step(health=)`` :60) through the same ``sync_and_update``:
``metrics["health"]``, and under ``skip_nonfinite`` the guard over the
params, the optimizer state and the residual (the model has no buffers).

``make_sp_lm_train_step`` (the JAX :165-306) is the sequence-parallel step
on the data x sequence grid (``parallel/mesh.py``): tokens
``(B, T / n)``, this rank's data shard's rows cut to its chunk of the
sequence, the model sequence-parallel over the rank's ring (the causal
ring attention, ``parallel/ring_attention.py``). The target of a chunk's
last position is the next chunk's first token, brought by one
``ring_shift`` of ``tokens[:, :1]`` by -1 (the JAX ``shift_perm`` :191);
the global last position has no target and is masked on the last rank of
the ring. The loss is ``sum(nll * mask) / sum(mask)`` with both sums over
the ring (``collectives.group_sum``, whose backward is the same sum), the
DP step's mean over ``(B, T - 1)``. Each rank's gradient is then n times
its own partial, and the all-reduce mean over all ranks of
``sync_and_update`` is the exact gradient
(``parallel/sequence_parallel.py`` on the convention). ``zero1`` and
``compress`` (``--zero1``, ``--grad-compress``; the JAX :165-306) are built
over ``mesh.data_group()``: the gradients are averaged over the ring first
and the data half is theirs, as in the ViT's sp step
(``sequence_parallel.sync_group``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from tpu_ddp_torch.health.stats import HealthConfig
from tpu_ddp_torch.parallel.collectives import group_size, group_sum, rank_mean, ring_shift
from tpu_ddp_torch.parallel.runtime import world_size
from tpu_ddp_torch.train.optim import Optimizer
from tpu_ddp_torch.train.state import TrainState, create_train_state
from tpu_ddp_torch.train.steps import StepHealth, streamed, sync_and_update, update_params

Batch = Dict[str, torch.Tensor]


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood, float32: ``(B, T', V)``,
    ``(B, T')`` -> ``(B, T')``."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -lp.gather(-1, targets[..., None])[..., 0]


def make_lm_train_step(tx: Optimizer, *, compress=None, zero1=None,
                       health: Optional[HealthConfig] = None
                       ) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, {"tokens": (B, T)}) -> (state, {"loss"})`` (and
    ``health`` under ``health``); ``state`` is updated in place and
    returned, ``tokens`` are this rank's rows. ``compress``, ``zero1`` and
    ``health`` as in ``train/steps.py::make_train_step``."""
    recorder = StepHealth(health) if health is not None else None

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        params = state.params()
        tokens = batch["tokens"]
        if recorder is not None:
            recorder.before_forward(model)
        with streamed(zero1, state):
            logits = model(tokens)
            loss = token_nll(logits[:, :-1], tokens[:, 1:]).mean()
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        sums = loss.detach().reshape(1)
        stats = sync_and_update(tx, state, grads, update_params(state, params, zero1),
                                sums, compress=compress, zero1=zero1, health=recorder)
        metrics = {"loss": rank_mean(sums[0], world_size())}
        if stats is not None:
            metrics["health"] = stats
        return state, metrics

    return train_step


def sp_targets(tokens: torch.Tensor, mesh) -> tuple:
    """``(targets, mask)`` of this rank's ``(B, T / n)`` chunk of tokens:
    the chunk shifted left by one with the next chunk's first token last
    (one ``ring_shift`` by -1), and the float32 mask that drops the global
    last position on the last rank of the ring (module docstring)."""
    next_first = ring_shift(tokens[:, :1], mesh.sequence_group(), shift=-1)
    targets = torch.cat([tokens[:, 1:], next_first], dim=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    if mesh.sequence_index == mesh.sequence_size - 1:
        mask[:, -1] = 0.0
    return targets, mask


def make_sp_lm_train_step(tx: Optimizer, mesh, *, sp_flash: bool = False,
                          health: Optional[HealthConfig] = None, zero1=None,
                          compress=None) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, {"tokens": (B, T / n)}) -> (state, {"loss"})`` (and
    ``health`` under ``health``) for the LM in ``state.model``, updated in
    place; ``mesh`` the rank's ``parallel.mesh.Mesh`` and ``tokens`` its
    chunk of its data shard's rows; ``sp_flash``: the ring's flash tiles
    (K4-K6); ``zero1`` and ``compress`` the overlays over the data group.
    Module docstring for the rest."""
    from tpu_ddp_torch.parallel.sequence_parallel import sequence_parallel, sync_group

    recorder = StepHealth(health) if health is not None else None
    group = mesh.sequence_group()

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        params = state.params()
        tokens = batch["tokens"]
        targets, mask = sp_targets(tokens, mesh)
        if recorder is not None:
            recorder.before_forward(model)
        with sequence_parallel(model, mesh, sp_flash):
            logits = model(tokens)
        nll = token_nll(logits, targets)
        total = group_sum(torch.stack([(nll * mask).sum(), mask.sum()]), group)
        loss = total[0] / total[1]
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        sums = loss.detach().reshape(1)
        sync = sync_group(grads, mesh, zero1, compress)
        stats = sync_and_update(tx, state, grads, params, sums, compress=compress,
                                zero1=zero1, health=recorder, group=sync)
        metrics = {"loss": rank_mean(sums[0], group_size(sync))}
        if stats is not None:
            metrics["health"] = stats
        return state, metrics

    return train_step


#: the JAX function initialises the model from a dummy token batch, through
#: the plain twin of an SP model (:309); the port's LM is initialised at
#: construction, as the plain module, so ``create_train_state`` serves it
#: as it is
create_lm_train_state = create_train_state
