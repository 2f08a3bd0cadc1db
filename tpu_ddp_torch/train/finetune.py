"""Fine-tuning: a partial restore into a fresh state, with the head swapped.

Counterpart of ``tpu_ddp/train/finetune.py`` (``load_pretrained_for_finetune``
:30): the reference fine-tune script's workflow (``ppe_main_ddp.py``) of
loading pretrained weights with ``strict=False``, swapping the classifier
head for a new class count and training from there, with ``--freeze`` and
``--loss bce`` on top (``train/optim.py``, ``train/losses.py``).
``--pretrained-dir`` names either a FILE, a torchvision-layout state dict
(``.pt``/``.pth``/``.npz``) imported by ``checkpoint/import_foreign.py``, or a
DIRECTORY of this port's checkpoints (``checkpoint/manager.py``; a JAX
trainer's checkpoint carried across by ``checkpoint/convert.py::from_jax``
reads the same), of which only the model state is used.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from tpu_ddp_torch.checkpoint.manager import Checkpointer, merge_params
from tpu_ddp_torch.parallel.runtime import is_primary_process
from tpu_ddp_torch.train.optim import Optimizer
from tpu_ddp_torch.train.state import (
    TrainState,
    create_train_state,
    full_model_state,
    load_model_state_,
    split_checkpoint,
)

log = logging.getLogger(__name__)


def pretrained_model_state(path: str, model: torch.nn.Module,
                           step: Optional[int] = None) -> dict:
    """The flat model state (params and BatchNorm buffers) that ``path``
    holds: a foreign file's import (its ``unmapped`` keys logged), or the
    model part of a checkpoint directory's ``step`` (default: its latest)."""
    if os.path.isfile(path):
        from tpu_ddp_torch.checkpoint.import_foreign import import_state_dict

        params, batch_stats, report = import_state_dict(path, model)
        if report["unmapped"] and is_primary_process():
            log.info("foreign import: %d keys mapped, %d unmapped (e.g. %s)",
                     report["mapped"], len(report["unmapped"]),
                     report["unmapped"][:3])
        return {**params, **batch_stats}
    ckpt = Checkpointer(path)
    try:
        restore_step = ckpt.latest_step() if step is None else step
        if restore_step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
        return split_checkpoint(ckpt.restore(restore_step))["model"]
    finally:
        ckpt.close()


def load_pretrained_for_finetune(path: str, model: torch.nn.Module, tx: Optimizer,
                                 device: torch.device, *, step: Optional[int] = None,
                                 zero1=None) -> TrainState:
    """A fresh state for ``model`` (its own seeded init, the optimizer state
    built on it, under ZeRO-1 in ``zero1``'s shards, under ZeRO-3 the params
    too), then every restored
    tensor whose name and shape still match merged into the model in place
    (``merge_params``; under ZeRO-3 against the gathered fresh params, a
    collective, and into the shards): ``load_state_dict(strict=False)`` plus the head
    swap; a head of another width, or a 7x7 stem against a CIFAR stem,
    keeps the fresh init. The optimizer state is fresh and the step 0, as
    in the JAX package (:41-45), whose EMA shadow, too, starts from the
    fresh init."""
    state = create_train_state(model, tx, device, zero1=zero1)
    restored = pretrained_model_state(path, state.model, step)
    fresh = full_model_state(state, zero1)
    merged = merge_params(restored, fresh)
    load_model_state_(state, merged, zero1)
    return state
