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

``health`` (a ``health.stats.HealthConfig``; the JAX step's health block
:254-312 and ``guard_step``) adds the numerics flight recorder:
``metrics["health"]``, the stats of the synchronised gradients, the
params before the update and the updates applied (K1's ``u`` output, read
in the same step), with the loss averaged over the ranks; under
``--grad-compress`` the ring computes its error whenever health is on,
error feedback or not (:255-257), for ``compress_error_norm``. The step
still makes one all-reduce of its scalars: the metric sums, the ring's
error and ZeRO-1's shard sums travel in one vector. With
``skip_nonfinite`` a ``SkipGuard`` saves the BatchNorm buffers before the
forward and the params (ZeRO-1: this rank's param shards), every optimizer
slot and both step counts before the update, and after it selects the old
values when ``all_finite`` is false; ZeRO-1 selects before its all-gather,
which then sends the restored shards. The error-feedback residual keeps
its old value the same way. No step builder reads a device value on the
host: the guard's ``ok`` stays on the device.

The step variants (the JAX builders of these names): ``augment`` and
``mixup_alpha`` in ``make_train_step`` (the in-step data path,
``data/augment.py``); ``scan``/``make_scan_train_step``, K calls of the one
step body over K stacked batches (``--steps-per-call``; the semantics of
the JAX ``lax.scan``, not yet one captured graph); the accumulating step,
``make_grad_accum_train_step``, which shares ``sync_and_update``;
``make_predict_step``. Health rides in every one of them.

Not ported yet: zero3 and auxiliary losses (the MoE router's).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpu_ddp_torch.data import augment as augment_ops
from tpu_ddp_torch.health.stats import (
    HealthConfig,
    SkipGuard,
    health_stats,
    leaf_norms,
    tree_select_,
)
from tpu_ddp_torch.models.resnet import BatchNorm
from tpu_ddp_torch.parallel.collectives import (
    all_reduce_mean_,
    all_reduce_sum_,
    rank_mean,
    sync_gradients,
)
from tpu_ddp_torch.parallel.runtime import rank, world_size
from tpu_ddp_torch.train.losses import cross_entropy_loss, masked_accuracy
from tpu_ddp_torch.train.optim import OptState, Optimizer
from tpu_ddp_torch.train.state import COUNTS, SLOTS, TrainState

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


def _opt_tensors(opt_state: OptState) -> list:
    """Every tensor of ``opt_state``: each slot's leaves, then the counts."""
    out = [t for slot in SLOTS for t in (getattr(opt_state, slot) or {}).values()]
    return out + [getattr(opt_state, c) for c in COUNTS if getattr(opt_state, c) is not None]


class StepHealth:
    """The flight recorder's part of one step builder (module docstring):
    ``before_forward`` and ``before_update`` take what the step is about to
    overwrite, ``finish`` forms the stats and applies the skip-step guard.
    Its guard's buffers live across the builder's steps."""

    def __init__(self, config: HealthConfig):
        self.config = config
        self.guard = SkipGuard() if config.skip_nonfinite else None
        self._param_norms: Optional[torch.Tensor] = None

    def before_forward(self, model: torch.nn.Module) -> None:
        """Save the BatchNorm buffers, which the forward moves."""
        if self.guard is not None:
            self.guard.save("buffers", [b for _, b in model.named_buffers()])

    @torch.no_grad()
    def before_update(self, state: TrainState, params: Dict[str, torch.Tensor],
                      zero1=None) -> None:
        """The old params' per-leaf norms, and under the guard the tensors
        the update writes in place: the params (ZeRO-1: this rank's param
        shards, which the all-gather sends), every optimizer slot and the
        counts."""
        self._param_norms = leaf_norms(list(params.values()))
        if self.guard is not None:
            held = zero1.param_shards(params) if zero1 is not None else params
            self.guard.save("update", list(held.values()) + _opt_tensors(state.opt_state))

    @torch.no_grad()
    def finish(self, sums: torch.Tensor, grads, updates, err_state, *,
               compress=None, zero1=None) -> dict:
        """The stats of the synchronised ``grads`` (ZeRO-1: this rank's
        shards) and the applied ``updates``, and the ring's error; ``sums``
        (the step's metric sums, its loss first) are summed over the ranks in
        place, in the same all-reduce. Then the guard's select."""
        cfg = self.config
        err_sq = None if err_state is None else compress.local_error_sq(err_state)
        # K1's updates are contiguous; the plain chain's keep a conv grad's
        # channels-last layout, whose norm would sum in another order
        updates = {n: u.contiguous() for n, u in updates.items()}
        if zero1 is not None:
            stats = zero1.health_stats(
                sums=sums, grad_shards=grads, param_norms=self._param_norms,
                update_shards=updates, per_layer=cfg.per_layer, compress_error_sq=err_sq)
        else:
            n = world_size()
            if n > 1:
                all_reduce_sum_([sums] + ([] if err_sq is None else [err_sq]))
            stats = health_stats(loss=rank_mean(sums[0], n), grads=grads, updates=updates,
                                 param_norms=self._param_norms, per_layer=cfg.per_layer,
                                 compress_error_sq=err_sq)
        if self.guard is not None:
            self.guard.select(stats["all_finite"])
        return stats


def sync_and_update(tx: Optimizer, state: TrainState, grads: Dict[str, torch.Tensor],
                    params: Dict[str, torch.Tensor], sums: torch.Tensor, *,
                    compress=None, zero1=None, health: Optional[StepHealth] = None):
    """The tail every data-parallel step shares: average ``grads`` (this
    rank's) over the ranks and update ``params`` and ``state`` in place, by
    ZeRO-1's sharded update, or the compressed ring, or the all-reduce
    (nothing at one rank), then ``tx``; thread the error-feedback residual
    and count the step (module docstring). ``sums`` are the step's metric
    sums on this rank (its loss first), summed over the ranks in place.
    Returns ``metrics["health"]`` under ``health``, else None."""
    ef = compress is not None and compress.config.error_feedback
    want_err = compress is not None and (ef or health is not None)
    residual = state.grad_residual if ef else None
    err_state = stats = None
    if health is not None:
        health.before_update(state, params, zero1)

    def record(grads_seen, updates, err):
        nonlocal stats
        stats = health.finish(sums, grads_seen, updates, err, compress=compress, zero1=zero1)

    if zero1 is not None:
        _, _, err_state = zero1.sharded_update(
            grads, params, state.opt_state, residual=residual, with_error=want_err,
            before_gather=record if health is not None else None)
    else:
        if compress is not None:
            grads, err_state = compress.all_reduce_mean(grads, residual,
                                                        with_error=want_err)
        elif world_size() > 1:
            grads = sync_gradients(grads)
        updates = tx.apply(grads, state.opt_state, params)
        if health is not None:
            record(grads, updates, err_state)
    if health is None and world_size() > 1:
        all_reduce_sum_([sums])
    if ef:
        if health is not None and health.guard is not None:
            tree_select_(stats["all_finite"], list(err_state.values()),
                         [residual[n] for n in err_state])
        state.grad_residual = err_state
    state.step += 1
    return stats


def _forward(model: torch.nn.Module, images: torch.Tensor, remat: bool) -> torch.Tensor:
    """The train-mode forward, its whole graph checkpointed under ``remat``
    for a model without per-block recompute."""
    if resolve_remat(model, remat):
        return checkpointed_forward(model, images)
    return model(images)


def _augmented(batch: Batch, step: torch.Tensor, *, augment: bool, seed: int,
               mixup_alpha: float) -> Batch:
    """``batch`` with the JAX step's in-step data path applied (:209-226):
    crop and flip, then mixup, whose partner labels and lambda ride along
    as ``_mix_label`` and ``_mix_lam``. The draws are keyed on ``(seed,
    step, rank)`` on the device (``data/augment.py``)."""
    rows, r = batch["image"].shape[0], rank()
    out = dict(batch)
    if augment:
        offsets, flip = augment_ops.crop_flip_draws(seed, step, r, rows)
        out["image"] = augment_ops.crop_flip(out["image"], offsets, flip)
    if mixup_alpha > 0:
        perm, lam = augment_ops.mixup_draws(seed, step, r, rows, alpha=mixup_alpha,
                                            valid=batch.get("mask"))
        out["image"] = augment_ops.mix(out["image"], perm, lam)
        out["_mix_label"], out["_mix_lam"] = batch["label"][perm], lam
    return out


def _metric_sums(loss: torch.Tensor, logits: torch.Tensor, batch: Batch,
                 compute_accuracy: bool) -> torch.Tensor:
    """``(loss, correct, count)`` of this rank's rows: the metric sums a
    step all-reduces (the counts 0 without accuracy)."""
    correct = count = torch.zeros_like(loss)
    if compute_accuracy:
        correct, count = masked_accuracy(logits, batch["label"], batch.get("mask"))
    return torch.stack([loss, correct, count])


def _step_metrics(sums: torch.Tensor, n: int, compute_accuracy: bool, stats) -> dict:
    """A step's metrics from its metric sums over the ranks (loss, correct,
    count) and its health stats."""
    metrics = {"loss": rank_mean(sums[0], n)}
    if compute_accuracy:
        metrics["accuracy"] = sums[1] / torch.clamp_min(sums[2], 1.0)
    if stats is not None:
        metrics["health"] = stats
    return metrics


def make_train_step(tx: Optimizer, *, compress=None, zero1=None,
                    loss_fn: Callable = cross_entropy_loss,
                    compute_accuracy: bool = True,
                    remat: bool = False,
                    health: Optional[HealthConfig] = None,
                    augment: bool = False, augment_seed: int = 0,
                    mixup_alpha: float = 0.0) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, batch) -> (state, {"loss", "accuracy"})`` (no
    ``accuracy`` when ``compute_accuracy`` is False; ``health`` too under
    ``health``); ``state`` is updated in place and returned. ``batch`` holds
    this rank's rows. ``compress`` (a ``parallel.compression.GradCompressor``)
    replaces the gradient all-reduce with its compressed ring; ``zero1`` (a
    ``parallel.zero.Zero1Partition`` built over ``tx``, with ``compress``
    attached when both are given) shards the update; ``remat`` recomputes
    the forward in the backward; ``health`` adds the flight recorder
    (module docstring). ``augment`` crops and flips the images and
    ``mixup_alpha > 0`` mixes them, with draws keyed on ``(augment_seed,
    state.step, rank)``; the loss is then ``lam * loss(y) + (1 - lam) *
    loss(y[perm])``, the reported loss too, and the accuracy counts the
    true labels (the JAX ``_make_shard_step`` :179-226)."""
    recorder = StepHealth(health) if health is not None else None

    def train_step(state: TrainState, batch: Batch):
        n = world_size()
        model = state.model
        model.train()
        params = state.params()
        if augment or mixup_alpha > 0:
            batch = _augmented(batch, state.step, augment=augment, seed=augment_seed,
                               mixup_alpha=mixup_alpha)
        if recorder is not None:
            recorder.before_forward(model)
        logits = _forward(model, batch["image"], remat)
        mask = batch.get("mask")
        loss = loss_fn(logits, batch["label"], mask)
        if mixup_alpha > 0:
            lam = batch["_mix_lam"]
            loss = lam * loss + (1.0 - lam) * loss_fn(logits, batch["_mix_label"], mask)
        if n > 1:
            all_reduce_mean_([b for _, b in model.named_buffers()])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            sums = _metric_sums(loss.detach(), logits, batch, compute_accuracy)
        stats = sync_and_update(tx, state, grads, params, sums, compress=compress,
                                zero1=zero1, health=recorder)
        with torch.no_grad():
            return state, _step_metrics(sums, n, compute_accuracy, stats)

    return train_step


def _stack(trees: list):
    """Dicts of equal structure, their tensor leaves stacked on a new
    leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def scan(step: Callable, steps_per_call: int) -> Callable[[TrainState, Batch], tuple]:
    """``multi(state, batches)``: ``step`` run ``steps_per_call`` times,
    over ``batches[k]`` for each k in order, where every tensor of
    ``batches`` has a leading (K,) axis (K stacked batches of this rank's
    rows); the metrics leaves, ``health`` included, gain the same leading
    axis. The JAX ``make_scan_train_step`` (:393-459) as a loop over the one
    step body: the state (ZeRO-1's shards, the error-feedback residual, the
    skip guard's buffers) is carried in place, the draws of
    ``augment``/``mixup`` are keyed on each step's ``state.step``, so a call
    is bitwise ``steps_per_call`` single steps, and nothing in it reads a
    device value on the host."""
    def multi_step(state: TrainState, batches: Batch):
        got = batches["image"].shape[0]
        if got != steps_per_call:
            raise ValueError(f"stacked batches of {got} steps for a scan of {steps_per_call}")
        outs = []
        for k in range(steps_per_call):
            state, metrics = step(state, {key: v[k] for key, v in batches.items()})
            outs.append(metrics)
        with torch.no_grad():
            return state, _stack(outs)

    return multi_step


def make_scan_train_step(tx: Optimizer, *, steps_per_call: int,
                         **kwargs) -> Callable[[TrainState, Batch], tuple]:
    """``scan`` of ``make_train_step(tx, **kwargs)`` (``--steps-per-call``)."""
    return scan(make_train_step(tx, **kwargs), steps_per_call)


def make_grad_accum_train_step(tx: Optimizer, *, accum_steps: int, compress=None, zero1=None,
                               loss_fn: Callable = cross_entropy_loss,
                               compute_accuracy: bool = True, remat: bool = False,
                               health: Optional[HealthConfig] = None
                               ) -> Callable[[TrainState, Batch], tuple]:
    """One optimizer step over this rank's rows split into ``accum_steps``
    microbatches of ``rows / accum_steps`` (``--grad-accum-steps``; the JAX
    ``make_grad_accum_train_step`` :462-656). Each microbatch runs its
    forward and backward alone (activations of one microbatch live at a
    time); BatchNorm normalises each by its own statistics and chains its
    running buffers through them, averaged over the ranks once after the
    loop. The gradients are summed in microbatch order and divided by K,
    then one ``sync_and_update``: one all-reduce, one compressed ring or one
    ZeRO-1 reduce-scatter, and one optimizer update (K1 once), per
    accumulated batch. ``loss`` is the microbatches' mean loss averaged over
    the ranks, ``accuracy`` the correct count over the count of all of
    them; ``health`` holds the stats of the accumulated gradient."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    recorder = StepHealth(health) if health is not None else None

    def train_step(state: TrainState, batch: Batch):
        rows = batch["image"].shape[0]
        if rows % accum_steps:
            raise ValueError(
                f"per-shard batch {rows} not divisible by accum_steps {accum_steps}")
        m = rows // accum_steps
        n = world_size()
        model = state.model
        model.train()
        params = state.params()
        leaves = list(params.values())
        if recorder is not None:
            recorder.before_forward(model)
        acc = total = None
        for k in range(accum_steps):
            micro = {key: v[k * m:(k + 1) * m] for key, v in batch.items()}
            logits = _forward(model, micro["image"], remat)
            loss = loss_fn(logits, micro["label"], micro.get("mask"))
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                term = _metric_sums(loss.detach(), logits, micro, compute_accuracy)
                if acc is None:
                    acc, total = list(grads), term
                else:
                    torch._foreach_add_(acc, grads)
                    total = total + term
        if n > 1:
            all_reduce_mean_([b for _, b in model.named_buffers()])
        with torch.no_grad():
            grads = {name: g / accum_steps for name, g in zip(params, acc)}
            sums = torch.cat([total[:1] / accum_steps, total[1:]])
        stats = sync_and_update(tx, state, grads, params, sums, compress=compress,
                                zero1=zero1, health=recorder)
        with torch.no_grad():
            return state, _step_metrics(sums, n, compute_accuracy, stats)

    return train_step


def _eval_logits(model: torch.nn.Module, images: torch.Tensor,
                 params: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The eval-mode forward (running-stats BatchNorm), with ``params`` (the
    EMA shadow) in place of the model's when given."""
    model.eval()
    return model(images) if params is None else functional_call(model, params, (images,))


def make_predict_step() -> Callable[..., torch.Tensor]:
    """``predict(state, batch, params=None) -> logits`` of this rank's rows:
    the eval-mode forward, ``params`` (the EMA shadow) in place of the
    model's when given (the JAX ``make_predict_step`` :705-726; the trainer
    gathers the ranks' rows, ``Trainer.predict``)."""

    @torch.no_grad()
    def predict_step(state: TrainState, batch: Batch,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        return _eval_logits(state.model, batch["image"], params)

    return predict_step


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
        logits = _eval_logits(state.model, batch["image"], params)
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
