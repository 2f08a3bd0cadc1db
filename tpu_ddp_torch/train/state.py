"""Train state: step, model (params and BatchNorm buffers) and optimizer
state, travelling together.

Counterpart of ``tpu_ddp/train/state.py`` (``TrainState`` :24,
``create_train_state`` :52). JAX's state is an immutable pytree; here the
model's tensors and the optimizer state are updated in place by the step.
``grad_residual`` is this rank's error-feedback residual of the compressed
gradient ring (``parallel/compression.py``): one f32 ``(padded,)`` tensor
per param, or ``None`` without error feedback.

``checkpoint_state`` and ``split_checkpoint`` are the checkpoint's one
layout (the JAX trainer's ``_ckpt_state``, :2585-2601): a flat dict, keyed
``step``, ``model/<name>`` (params and BatchNorm buffers), ``opt/<slot>/<name>``
and ``opt/count``, ``opt/sched_count`` (the optimizer state in the
replicated layout), and the error-feedback residual: from one rank
``grad_residual/<name>``, in param layout, and from several
``grad_residual_rows``, every rank's leaf-major residual, whose sum in rank
order is the param-layout residual (see
``parallel/compression.py::GradCompressor.shard_residual``). The data order
comes from ``(seed, epoch)`` (``data/loader.py``), and the in-step draws of
augment and mixup from ``(seed, step, rank)`` (``data/augment.py``), so no
loader or generator state is saved.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from tpu_ddp_torch.train.optim import OptState, Optimizer

#: the ``OptState`` fields that hold one tensor a param, and the counters
SLOTS = ("trace", "mu", "nu", "ema")
COUNTS = ("count", "sched_count")


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


def checkpoint_state(step: int, model_state: Dict[str, torch.Tensor],
                     opt_state: OptState,
                     residual: Optional[Dict[str, torch.Tensor]] = None,
                     residual_rows: Optional[torch.Tensor] = None) -> dict:
    """The checkpoint's flat dict (module docstring) of a state in the
    replicated layout, with the param-layout ``residual`` or the
    ``residual_rows`` of several ranks. The tensors are the caller's, views included:
    ``Checkpointer.save`` copies each into storage of its own."""
    out = {"step": int(step)}
    out.update({f"model/{k}": v for k, v in model_state.items()})
    for slot in SLOTS:
        for name, t in (getattr(opt_state, slot) or {}).items():
            out[f"opt/{slot}/{name}"] = t
    for slot in COUNTS:
        if getattr(opt_state, slot) is not None:
            out[f"opt/{slot}"] = getattr(opt_state, slot)
    for name, t in (residual or {}).items():
        out[f"grad_residual/{name}"] = t
    if residual_rows is not None:
        out["grad_residual_rows"] = residual_rows
    return out


def split_checkpoint(flat: dict) -> dict:
    """``checkpoint_state``'s inverse: ``{"step", "model", "opt_state",
    "grad_residual", "grad_residual_rows"}``, the last two None when the
    checkpoint has none."""
    out = {"step": int(flat["step"]), "model": {}, "opt_state": OptState(),
           "grad_residual": None, "grad_residual_rows": flat.get("grad_residual_rows")}
    opt = out["opt_state"]
    for key, value in flat.items():
        head, _, rest = key.partition("/")
        if head == "model":
            out["model"][rest] = value
        elif head == "grad_residual":
            out["grad_residual"] = out["grad_residual"] or {}
            out["grad_residual"][rest] = value
        elif head == "opt":
            slot, _, name = rest.partition("/")
            if slot in COUNTS:
                setattr(opt, slot, value)
            else:
                if getattr(opt, slot) is None:
                    setattr(opt, slot, {})
                getattr(opt, slot)[name] = value
    return out


@torch.no_grad()
def copy_opt_state_(dst: OptState, src: OptState) -> None:
    """Copy ``src`` into ``dst``'s tensors in place (they may be views that
    K1 or ZeRO-1's rows read). Raises when the two hold different slots or
    leaves: a checkpoint of another optimizer recipe."""
    for slot in SLOTS + COUNTS:
        want, got = getattr(dst, slot), getattr(src, slot)
        if (want is None) != (got is None) or (
                slot in SLOTS and want is not None and set(want) != set(got)):
            raise ValueError(
                f"the checkpoint's optimizer state does not match this run's: "
                f"slot {slot!r} is {'absent' if got is None else 'present'} in the "
                f"checkpoint and {'absent' if want is None else 'present'} here, "
                "or holds other leaves (another --optimizer, --momentum, "
                "--schedule or --ema-decay)")
        if want is None:
            continue
        if slot in COUNTS:
            want.copy_(got)
        else:
            for name, t in want.items():
                t.copy_(got[name])
