"""Train state: step, model (params and BatchNorm buffers) and optimizer
state, travelling together.

Counterpart of ``tpu_ddp/train/state.py`` (``TrainState`` :24,
``create_train_state`` :52). JAX's state is an immutable pytree; here the
model's tensors and the optimizer state are updated in place by the step.
``grad_residual`` is this rank's error-feedback residual of the compressed
gradient ring (``parallel/compression.py``): one f32 ``(padded,)`` tensor
per param, or ``None`` without error feedback. Under ZeRO-3
(``parallel/zero.py::Zero3Partition``) ``param_shards`` holds this rank's
param shards, the params' only storage between steps: the module's
parameters are empty placeholders then, and ``full_model_state`` and
``load_model_state_`` read and write the params through the shards.

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

``StateLayout`` is how a rank holds the state against that one layout: cut
over a model group (``tp``, ``parallel/tensor_parallel.py``'s
``TensorParallel``; over an expert group the same class; a pipeline stage,
``parallel/pipeline.py``'s ``PipelineLayout``), the optimizer state (and under ZeRO-3 the params)
scattered over a data group (``zero``, a ``Zero1Partition`` or
``Zero3Partition``), both, or neither (a replicated run). The trainer
saves, restores, checks and evaluates every family through it.
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
    param_shards: Optional[Dict[str, torch.Tensor]] = None

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def scattered(zero) -> bool:
    """Whether ``zero`` (a partition or None) keeps the params scattered
    (ZeRO-3)."""
    return getattr(zero, "scattered_params", False)


def create_train_state(model: nn.Module, tx: Optimizer,
                       device: torch.device, zero1=None) -> TrainState:
    """Move ``model`` (initialised from its own seeded generator) to
    ``device`` and build the optimizer state for its params: replicated, or
    under ZeRO-1 (``zero1``, a ``parallel.zero.Zero1Partition``) this rank's
    shards of it, built in shard space. Under ZeRO-3 (a ``Zero3Partition``)
    the params then move into this rank's shards too, and the module keeps
    placeholders: the full init copy is transient."""
    model = model.to(device)
    params = dict(model.named_parameters())
    state = TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        model=model,
        opt_state=tx.init(params) if zero1 is None else zero1.init_opt_state(params),
    )
    if scattered(zero1):
        state.param_shards = zero1.shard_model_(model)
    return state


def full_model_state(state: TrainState, zero=None) -> Dict[str, torch.Tensor]:
    """The model's state dict (params and BatchNorm buffers) with the params
    whole: under ZeRO-3 gathered from the ranks' shards (a collective, every
    rank calls it), else the module's own tensors."""
    out = state.model.state_dict()
    if scattered(zero):
        full = zero.deshard_params(state.param_shards)
        out = type(out)((k, full.get(k, v)) for k, v in out.items())
    return out


@torch.no_grad()
def load_model_state_(state: TrainState, model_state: Dict[str, torch.Tensor],
                      zero=None) -> None:
    """Write a flat model state (``full_model_state``'s layout: a checkpoint's,
    a fine-tune's merge) into ``state`` in place: ``load_state_dict``, or
    under ZeRO-3 the buffers into the module and this rank's slice of each
    param into its shard. Raises on missing or unexpected keys, as
    ``load_state_dict`` does."""
    if not scattered(zero):
        state.model.load_state_dict(model_state)
        return
    current = state.model.state_dict()      # the placeholders and the buffers
    if set(model_state) != set(current):
        raise RuntimeError(
            f"model state mismatch: missing {sorted(set(current) - set(model_state))}, "
            f"unexpected {sorted(set(model_state) - set(current))}")
    for name, t in current.items():
        if name not in zero.param_slots:
            t.copy_(model_state[name])
    zero.load_params_(state.param_shards, {n: model_state[n] for n in zero.param_slots})


def map_opt_slots(opt_state: OptState, fn) -> OptState:
    """``opt_state`` with every param-shaped slot mapped by ``fn`` (a cut's
    ``scatter`` or ``gather``); the counts as they are."""
    out = OptState()
    for slot in SLOTS:
        value = getattr(opt_state, slot)
        setattr(out, slot, None if value is None else fn(value))
    for slot in COUNTS:
        setattr(out, slot, getattr(opt_state, slot))
    return out


@dataclasses.dataclass
class StateLayout:
    """A rank's layout of a ``TrainState`` (module docstring): ``tp`` (a
    ``TensorParallel`` or None) and ``zero`` (a ZeRO partition or None).
    The checkpoint keeps the one replicated layout: the methods here gather
    on save and cut on restore."""

    tp: Optional[object] = None
    zero: Optional[object] = None

    @property
    def split(self) -> bool:
        """Whether the ranks hold different params (a model cut, ZeRO-3)."""
        return self.tp is not None or scattered(self.zero)

    def model_state(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The whole model state dict (a collective when ``split``: every
        rank calls it)."""
        local = full_model_state(state, self.zero)
        return self.tp.gather(local) if self.tp is not None else local

    def load_model_state_(self, state: TrainState, whole: Dict[str, torch.Tensor]) -> None:
        """Write a whole model state (a checkpoint's) into this rank's
        layout, in place; no collective."""
        local = self.tp.scatter(whole) if self.tp is not None else whole
        load_model_state_(state, local, self.zero)

    def deshard_opt_state(self, opt_state: OptState) -> OptState:
        """This rank's optimizer state -> the replicated layout (a
        collective under a cut)."""
        if self.zero is not None:
            opt_state = self.zero.deshard_opt_state(opt_state)
        return self.tp.opt_state(opt_state, self.tp.gather) if self.tp is not None else opt_state

    def shard_opt_state(self, opt_state: OptState) -> OptState:
        """A replicated-layout optimizer state -> this rank's (no
        collective)."""
        if self.tp is not None:
            opt_state = self.tp.opt_state(opt_state, self.tp.scatter)
        return self.zero.shard_opt_state(opt_state) if self.zero is not None else opt_state

    def eval_params(self, state: TrainState, ema: bool) -> Optional[Dict[str, torch.Tensor]]:
        """The weights evaluation reads in place of the module's (the JAX
        ``_eval_source_state`` :2615-2640): the EMA shadow under ``ema``
        (gathered from its shards under ZeRO), the params gathered from
        their shards under ZeRO-3, else None; a collective under ZeRO. Under
        a model cut they are this rank's leaves, which its cut model reads;
        under a pipeline stage (``tp`` with an ``eval_params`` of its own)
        the whole params (or shadow) gathered over the pipeline."""
        if hasattr(self.tp, "eval_params"):
            return self.tp.eval_params(state, ema)
        if ema:
            shadow = state.opt_state.ema
            return shadow if self.zero is None else self.zero.gather_params(shadow)
        if scattered(self.zero):
            return self.zero.deshard_params(state.param_shards)
        return None

    def local_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """What this rank holds of the params: its shards under ZeRO-3,
        else its leaves."""
        return state.param_shards if scattered(self.zero) else state.params()

    def _global_numel(self, name: str, t: torch.Tensor, zero_cut: bool) -> tuple:
        """``(numel, cut)``: the elements of leaf ``name``'s whole tensor,
        of which this rank holds ``t``, and whether the layout cuts it
        (over the data group by ZeRO when ``zero_cut``, over the model or
        expert group by ``tp``)."""
        numel, cut = t.numel(), False
        if zero_cut and self.zero is not None and name in self.zero.param_slots:
            numel, cut = self.zero.param_slots[name].size, self.zero.n_shards > 1
        cuts = getattr(self.tp, "layout", None) or {}
        if name in cuts and self.tp.size > 1:
            _, idx = cuts[name]
            numel = numel // len(idx[self.tp.index]) * sum(len(i) for i in idx)
            cut = True
        return numel, cut

    def leaves(self, state: TrainState) -> list:
        """Every tensor of this rank's state, by section: ``(section, name,
        tensor, global numel, cut)``, the sections ``params`` (the shards
        under ZeRO-3), ``opt_state`` (each slot's leaves as ``<slot>/<name>``
        and the counts), ``batch_stats`` (the module's buffers) and
        ``step``; ``global numel`` is the whole leaf's element count and
        ``cut`` whether the layout splits it over ranks (a pipeline stage
        holds its blocks whole). The graph lint's state
        (``analysis/lint.py``: DON001, SHD001)."""
        out = []
        for name, t in self.local_params(state).items():
            out.append(("params", name, t, *self._global_numel(name, t, scattered(self.zero))))
        opt = state.opt_state
        for slot in SLOTS:
            for name, t in (getattr(opt, slot) or {}).items():
                out.append(("opt_state", f"{slot}/{name}", t,
                            *self._global_numel(name, t, True)))
        for slot in COUNTS:
            if getattr(opt, slot) is not None:
                out.append(("opt_state", slot, getattr(opt, slot),
                            getattr(opt, slot).numel(), False))
        for name, t in state.model.named_buffers():
            out.append(("batch_stats", name, t, *self._global_numel(name, t, False)))
        out.append(("step", "step", state.step, state.step.numel(), False))
        return out


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
