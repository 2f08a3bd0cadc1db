"""Data-parallel train and eval steps, one rank per process.

Counterpart of ``tpu_ddp/train/steps.py`` (``_make_shard_step`` :114,
``make_train_step`` :335, ``make_eval_step`` :659). Each rank runs the
forward in train mode on its own rows (which moves the BatchNorm running
stats), its local masked cross-entropy and the backward. Then:

* the BatchNorm running stats are averaged over the ranks (the JAX step's
  ``pmean`` of ``batch_stats`` :252; not DDP's broadcast from rank 0);
* the gradients are averaged over the ranks, by ``sync_gradients`` (an
  all-reduce) or, with a ``GradCompressor``, by its compressed ring
  (:272-277), with this rank's error-feedback residual in
  ``state.grad_residual`` when error feedback is on;
* the optimizer update (``Optimizer.apply``) runs on every rank on the same
  averaged gradients, so the replicas stay equal;
* under ZeRO-1 (``zero1``, a ``parallel.zero.Zero1Partition``; the JAX
  step's zero1 branch :230-242) the last two are one: the partition's
  reduce-scatter is the gradient sync (the compressed ring when the
  partition has the compressor, with the residual threaded as above), the
  update runs on this rank's shards of the params and of the state in
  ``state.opt_state``, and one all-gather brings the params back whole;
* ``loss`` is averaged over the ranks, ``accuracy`` is the summed correct
  count over the summed count (:318-329).

``remat`` (the JAX ``resolve_remat`` :65 and its whole-forward
``jax.checkpoint`` :176): a model with a ``remat`` attribute (the ViT, the
LM) recomputes each block in the backward; any other (NetResDeep, the
ResNet family) has its whole forward checkpointed
(``torch.utils.checkpoint``, non-reentrant). The recompute runs the
forward a second time, and ``jax.checkpoint`` returns the mutated
``batch_stats`` once: the recompute therefore runs with every BatchNorm's
``update_running`` off, so the running buffers move once a step, as
without remat.

Both builders take ``loss_fn`` (``cross_entropy_loss`` by default; the
fine-tune's ``binary_cross_entropy_with_logits`` on multi-hot targets) and
``compute_accuracy``, as the JAX builders do (:335, :659): without accuracy
(BCE) the train step reports no ``accuracy`` and the eval step counts
``correct = 0``.

With one rank nothing of this runs a collective: the step is the
single-device step. The metrics stay on the device; the caller fetches
them when it needs them.

Not ported yet: zero3, the health recorder, augment, mixup and auxiliary
losses, and the scanned and accumulating steps.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpu_ddp_torch.models.resnet import BatchNorm
from tpu_ddp_torch.parallel.collectives import (
    all_reduce_mean_,
    all_reduce_sum_,
    sync_gradients,
)
from tpu_ddp_torch.parallel.runtime import world_size
from tpu_ddp_torch.train.losses import cross_entropy_loss, masked_accuracy
from tpu_ddp_torch.train.optim import Optimizer
from tpu_ddp_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def batch_to_device(batch: dict, device: torch.device) -> Batch:
    """Numpy ``{image, label, mask}`` -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def resolve_remat(model: torch.nn.Module, remat: bool) -> bool:
    """Under ``remat``, turn on the per-block recompute of a model that has
    one (``model.remat``); returns whether the caller must checkpoint the
    whole forward instead (a model without it)."""
    if remat and hasattr(model, "remat"):
        model.remat = True
        return False
    return remat


@contextlib.contextmanager
def running_stats_frozen(model: torch.nn.Module):
    """Every BatchNorm of ``model`` leaves its running buffers alone."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_running = False
    try:
        yield
    finally:
        for m in norms:
            m.update_running = True


def checkpointed_forward(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` with the whole forward recomputed in the backward; the
    recompute moves no BatchNorm running buffer (module docstring)."""
    return checkpoint(model, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          running_stats_frozen(model)))


def sync_and_update(tx: Optimizer, state: TrainState, grads: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor], *, compress=None, zero1=None) -> None:
    """The tail every data-parallel step shares: average ``grads`` (this
    rank's) over the ranks and update ``params`` and ``state`` in place, by
    ZeRO-1's sharded update, or the compressed ring, or the all-reduce
    (nothing at one rank), then ``tx``; thread the error-feedback residual
    and count the step (module docstring)."""
    ef = compress is not None and compress.config.error_feedback
    residual = state.grad_residual if ef else None
    err_state = None
    if zero1 is not None:
        _, _, err_state = zero1.sharded_update(
            grads, params, state.opt_state, residual=residual, with_error=ef)
    else:
        if compress is not None:
            grads, err_state = compress.all_reduce_mean(grads, residual,
                                                        with_error=ef)
        elif world_size() > 1:
            grads = sync_gradients(grads)
        tx.apply(grads, state.opt_state, params)
    if ef:
        state.grad_residual = err_state
    state.step += 1


def make_train_step(tx: Optimizer, *, compress=None, zero1=None,
                    loss_fn: Callable = cross_entropy_loss,
                    compute_accuracy: bool = True,
                    remat: bool = False) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, batch) -> (state, {"loss", "accuracy"})`` (no
    ``accuracy`` when ``compute_accuracy`` is False); ``state`` is
    updated in place and returned. ``batch`` holds this rank's rows.
    ``compress`` (a ``parallel.compression.GradCompressor``) replaces the
    gradient all-reduce with its compressed ring; ``zero1`` (a
    ``parallel.zero.Zero1Partition`` built over ``tx``, with ``compress``
    attached when both are given) shards the update; ``remat`` recomputes
    the forward in the backward (module docstring)."""

    def train_step(state: TrainState, batch: Batch):
        n = world_size()
        model = state.model
        model.train()
        params = state.params()
        if resolve_remat(model, remat):
            logits = checkpointed_forward(model, batch["image"])
        else:
            logits = model(batch["image"])
        loss = loss_fn(logits, batch["label"], batch.get("mask"))
        if n > 1:
            all_reduce_mean_([b for _, b in model.named_buffers()])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        sync_and_update(tx, state, grads, params, compress=compress, zero1=zero1)
        with torch.no_grad():
            loss = loss.detach()
            correct = count = torch.zeros_like(loss)
            if compute_accuracy:
                correct, count = masked_accuracy(logits, batch["label"],
                                                 batch.get("mask"))
            if n > 1:
                sums = torch.stack([loss, correct, count])
                all_reduce_sum_([sums])
                loss = sums[0] / torch.full_like(sums[0], n)
                correct, count = sums[1], sums[2]
            metrics = {"loss": loss}
            if compute_accuracy:
                metrics["accuracy"] = correct / torch.clamp_min(count, 1.0)
        return state, metrics

    return train_step


def make_eval_step(loss_fn: Callable = cross_entropy_loss,
                   compute_accuracy: bool = True) -> Callable[..., dict]:
    """``eval(state, batch, params=None) -> {correct, count, loss_sum}``,
    each summed over the ranks: running-stats BatchNorm; ``params`` (the
    EMA shadow) replaces the model's params when given. ``loss_sum`` is
    each rank's masked-mean loss times ITS OWN count before the sum, so the
    eval loss is exact across shards with unequal real counts."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch,
                  params: Optional[Dict[str, torch.Tensor]] = None):
        model = state.model
        model.eval()
        images = batch["image"]
        logits = (model(images) if params is None
                  else functional_call(model, params, (images,)))
        mask = batch.get("mask")
        loss = loss_fn(logits, batch["label"], mask)
        if compute_accuracy:
            correct, count = masked_accuracy(logits, batch["label"], mask)
        else:                            # multi-hot targets: no accuracy
            correct = torch.zeros_like(loss)
            count = (mask.to(torch.float32).sum() if mask is not None else
                     torch.full_like(loss, float(logits.shape[0])))
        out = {"correct": correct, "count": count, "loss_sum": loss * count}
        if world_size() > 1:
            sums = torch.stack(list(out.values()))
            all_reduce_sum_([sums])
            out = dict(zip(out, sums))
        return out

    return eval_step
