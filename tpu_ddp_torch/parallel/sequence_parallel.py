"""Sequence-parallel (SP) training of the ViT on the data x sequence grid.

Counterpart of ``tpu_ddp/parallel/sequence_parallel.py``
(``make_sp_train_step`` :36). The ranks form the grid of
``parallel/mesh.py``: the batch rows split over ``data`` and each image's
rows over ``sequence``, so a rank takes its data shard's rows and, of each,
its stripe of ``H / n`` image rows (``image_stripe``; the JAX batch spec
``P(data, sequence)``); labels and mask are the data shard's. The model
runs sequence-parallel over the rank's ring (``ViT.set_sequence_parallel``
for the step's forward): ring attention, and the mean-pool closed by the
ring's mean. Each rank's memory for attention is O(T * T / n) and for the
activations O(T / n).

**Gradients.** ``torch.distributed`` carries no autograd, so each
collective on the loss path has an explicit backward, and the convention
is the JAX package's on jax 0.4 (its ``GRAD_SYNC_IN_AD`` false branch,
:95-106): the pool's mean over the ring has the same mean as its backward
(``collectives.group_mean``), the ring's k/v rotation has the ring's
second pass (``parallel/ring_attention.py``). The n ranks of a ring then
hold the same loss and the same cotangent of the pooled features, so each
rank's gradient for a param before the pool is n times its own partial (the
true partial carries the pool's 1/n) and the head's is its data shard's
whole gradient, the same on every rank of the ring. One mean over ALL the
ranks, data x sequence, is then the exact gradient of the mean loss over
the data shards; that is the all-reduce mean the data-parallel step makes
already (``train/steps.py::sync_and_update``), so the update, ``--kernels``
(K1) and the flight recorder run as they do there, with no collective of
their own. The chosen convention is held to the JAX step's gradients on
the CPU (``tests/test_torch_sequence_parallel.py``).

``metrics["loss"]`` is the JAX step's, the mean over the data shards: the
step's loss is the same on the n ranks of a ring, and the mean over all
ranks counts each data shard n times over n * D ranks. There is no
``accuracy``, as in the JAX step.

**Overlays** (``zero1``, a ``parallel.zero.Zero1Partition``, and
``compress``, a ``parallel.compression.GradCompressor``: ``--zero1`` and
``--grad-compress``; the JAX :87-124). Both are built over
``mesh.data_group()`` (``D`` shards). The one mean over all the ranks is
then taken in two halves: first the mean over the sequence ring (one
all-reduce of every gradient), after which the ranks of a ring hold the
same gradients, then the data half over the data group alone: the
partition's reduce-scatter, or the compressed ring
(``train/steps.py::sync_and_update`` with ``group``). The optimizer state
is scattered over ``data`` and replicated over ``sequence``, and so is
the error-feedback residual: the data group at each sequence index runs
the same arithmetic on the same inputs. The flight recorder's sums go
over the data group, where the gradients are already complete over the
ring, so its stats are true globals (the JAX comment at :126-131).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from tpu_ddp_torch.health.stats import HealthConfig
from tpu_ddp_torch.parallel.collectives import all_reduce_mean_, group_size, rank_mean
from tpu_ddp_torch.parallel.mesh import Mesh
from tpu_ddp_torch.train.losses import cross_entropy_loss
from tpu_ddp_torch.train.optim import Optimizer
from tpu_ddp_torch.train.state import TrainState
from tpu_ddp_torch.train.steps import StepHealth, sync_and_update

Batch = Dict[str, torch.Tensor]


def sync_group(grads: Dict[str, torch.Tensor], mesh: Mesh, zero1=None, compress=None):
    """The group ``sync_and_update`` averages ``grads`` over (module
    docstring): all the ranks (None) without an overlay; with one, the
    data group, after ``grads`` are averaged over the sequence ring here,
    in place."""
    if zero1 is None and compress is None:
        return None
    if group_size(mesh.sequence_group()) > 1:
        all_reduce_mean_(list(grads.values()), mesh.sequence_group())
    return mesh.data_group()


@contextlib.contextmanager
def sequence_parallel(model: torch.nn.Module, mesh: Mesh, flash: bool = False):
    """``model`` sequence-parallel over this rank's ring for the block's
    duration, the plain module again after it."""
    model.set_sequence_parallel(mesh.sequence_group(), flash)
    try:
        yield model
    finally:
        model.set_sequence_parallel(None)


def image_stripe(images: torch.Tensor, mesh: Mesh, patch_size: int) -> torch.Tensor:
    """This rank's stripe of NHWC ``images``: rows ``[s * H / n, (s + 1) *
    H / n)`` for the rank at place s of a ring of n. H must divide by
    ``patch_size * n`` (each stripe whole patches)."""
    n, s, H = mesh.sequence_size, mesh.sequence_index, images.shape[1]
    if H % (patch_size * n):
        raise ValueError(f"image height {H} must divide by patch {patch_size} x "
                         f"{n} sequence ranks")
    rows = H // n
    return images[:, s * rows:(s + 1) * rows]


def make_sp_train_step(tx: Optimizer, mesh: Mesh, *, sp_flash: bool = False,
                       loss_fn: Callable = cross_entropy_loss,
                       health: Optional[HealthConfig] = None, zero1=None,
                       compress=None) -> Callable[[TrainState, Batch], tuple]:
    """``step(state, batch) -> (state, {"loss"})`` (and ``health`` under
    ``health``) for the ViT in ``state.model``, updated in place; ``batch``
    holds this rank's data shard with each image cut to its stripe
    (``image_stripe``), and the shard's labels and mask. ``sp_flash``: the
    ring's flash tiles (K4-K6); ``zero1`` and ``compress`` the overlays,
    built over ``mesh.data_group()``. Module docstring for the rest."""
    recorder = StepHealth(health) if health is not None else None

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        params = state.params()
        if recorder is not None:
            recorder.before_forward(model)
        with sequence_parallel(model, mesh, sp_flash):
            logits = model(batch["image"])
        loss = loss_fn(logits, batch["label"], batch.get("mask"))
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        sums = loss.detach().reshape(1)
        group = sync_group(grads, mesh, zero1, compress)
        stats = sync_and_update(tx, state, grads, params, sums, compress=compress,
                                zero1=zero1, health=recorder, group=group)
        metrics = {"loss": rank_mean(sums[0], group_size(group))}
        if stats is not None:
            metrics["health"] = stats
        return state, metrics

    return train_step
