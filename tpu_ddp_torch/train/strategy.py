"""Parallelism routing: ``--parallelism`` and ``--mesh`` to a strategy.

Counterpart of ``tpu_ddp/train/strategy.py`` for the families the port
runs. ``PARALLELISMS``, ``parse_mesh_arg``, ``infer_parallelism`` and
``default_mesh_sizes`` (:140-149) are the JAX functions: naming a non-data
mesh axis picks its family (``sequence`` picks ``sp``), and a bare
``--parallelism sp`` runs on ``{"data": -1, "sequence": 2}``.
``build_strategy`` builds a family's state and steps on the rank grid
(``parallel/mesh.py``), with the JAX guards and messages (:332-351). ``dp``
stays in the ``Trainer``, as in JAX (:296-297).

``sp`` (the JAX :353-414) takes a ViT: the train step is
``parallel/sequence_parallel.py::make_sp_train_step``, which gets each
image cut to the rank's stripe (``image_stripe``, the JAX batch spec
``P(data, sequence)``); the state is the plain module's, replicated on
every rank (the params' shapes are the same either way); evaluation and
prediction run the plain module on whole images, each rank on its data
shard's rows, replicated over the ring (the JAX :400-411). ``--zero1`` and
``--grad-compress`` (the JAX :368-398) build the partition and the
compressor over ``mesh.data_group()``: the optimizer state and the
error-feedback residual scattered over data and replicated over sequence;
the trainer de-shards them for checkpoints as under dp.

``fsdp``, ``tp`` and ``fsdp_tp`` (the JAX :504-537) are the GSPMD family
of ``parallel/tensor_parallel.py``: the ViT and the MoE ViT with Megatron
rules (the MoE ViT's experts replicated), the conv families (NetResDeep,
the ResNet family, WideResNet) with channel rules (``_tp_rules_for``), fsdp
for any model. ``ep`` (the JAX :540-550) takes the MoE ViT, its experts cut
over the expert group (``parallel/expert_parallel.py``), through the same
step. Their eval and predict steps (``_gspmd_eval_predict``, the JAX :188)
run the sharded model on each data shard's rows, the counts summed over the
data group once; the strategy's ``layout`` gathers the state whole for
checkpoints and cuts it again on restore. A model with auxiliary losses
(the MoE ViT) adds ``aux_weight`` times them to the loss in every family.

``pp`` (the JAX :420-500) takes a ViT whose depth divides into the stages:
each rank of a pipeline holds its stage (``parallel/pipeline.py``), the
step runs ``--pp-schedule`` (gpipe or 1f1b) over ``--microbatches``, and
the schedule's line is printed (``pp_schedule_line``). A fine-tune's
``initial_state`` is laid out the same way, its optimizer state fresh (the
trainer builds it so). Evaluation and prediction run the plain module on
the params gathered over the pipeline once a pass (the JAX
``prepare_eval``), each rank on its data shard's rows, the counts summed
over the data group.

``MODE_AXIS`` (the JAX :60) names each family's sharded non-data axis.
``build_step_program`` builds the train step of a ``TrainConfig`` as a run
builds it, through a ``Trainer`` over this process's group, with its first
batch on the device: the step ``analysis/explain.py`` and ``comms
exposure`` run (the counterpart of the JAX ``build_abstract_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpu_ddp_torch.parallel.mesh import (
    AXIS_ORDER,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    Mesh,
)
from tpu_ddp_torch.train.losses import cross_entropy_loss

PARALLELISMS = ("dp", "fsdp", "tp", "fsdp_tp", "pp", "sp", "ep")

#: strategy -> the sharded non-data mesh axis (the JAX ``MODE_AXIS``)
MODE_AXIS = {
    "tp": MODEL_AXIS,
    "fsdp_tp": MODEL_AXIS,
    "pp": PIPELINE_AXIS,
    "sp": SEQUENCE_AXIS,
    "ep": EXPERT_AXIS,
}

# Which mesh axis (other than data) each inferred mode keys on.
_AXIS_TO_MODE = {
    MODEL_AXIS: "tp",
    PIPELINE_AXIS: "pp",
    SEQUENCE_AXIS: "sp",
    EXPERT_AXIS: "ep",
}


def parse_mesh_arg(text: str) -> dict:
    """'data=2,sequence=4' -> {'data': 2, 'sequence': 4}. Axes must come
    from the mesh's named-axis set; -1 ("rest of the devices") allowed on
    one axis."""
    sizes: dict = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--mesh entry {part!r} is not axis=size")
        axis, _, val = part.partition("=")
        axis = axis.strip()
        if axis not in AXIS_ORDER:
            raise ValueError(
                f"unknown mesh axis {axis!r}; choose from {AXIS_ORDER}"
            )
        sizes[axis] = int(val)
    if not sizes:
        raise ValueError(f"--mesh {text!r} names no axes")
    return sizes


def infer_parallelism(mesh_sizes: Optional[dict], explicit: Optional[str]) -> str:
    """Explicit flag wins; otherwise the first non-data axis sized >1 (or -1)
    picks its mode; a pure data mesh is dp. Two sharded non-data axes is an
    unsupported combination (each strategy owns its own step builder)."""
    if explicit:
        if explicit not in PARALLELISMS:
            raise ValueError(
                f"unknown parallelism {explicit!r}; choose from {PARALLELISMS}"
            )
        return explicit
    if not mesh_sizes:
        return "dp"
    active = [
        a for a in _AXIS_TO_MODE
        if mesh_sizes.get(a, 1) != 1
    ]
    if len(active) > 1:
        raise ValueError(
            f"mesh shards multiple non-data axes {active}; pick one "
            "parallelism family per run (combine any of them with data "
            "parallelism instead)"
        )
    return _AXIS_TO_MODE[active[0]] if active else "dp"


def default_mesh_sizes(parallelism: str) -> dict:
    """Mesh used when --mesh is omitted: 2-way on the mode's axis, data
    takes the rest (fsdp/dp are 1-D data meshes)."""
    return {
        "dp": {"data": -1},
        "fsdp": {"data": -1},
        "tp": {"data": -1, "model": 2},
        "fsdp_tp": {"data": -1, "model": 2},
        "pp": {"data": -1, "pipeline": 2},
        "sp": {"data": -1, "sequence": 2},
        "ep": {"data": -1, "expert": 2},
    }[parallelism]


def _tp_rules_for(model, parallelism: str):
    """The JAX ``_tp_rules_for`` (:250): Megatron rules for the ViT,
    channel rules for the conv families; any other model raises rather
    than train replicated while reporting tensor parallelism."""
    from tpu_ddp_torch.models.moe import MoEViT
    from tpu_ddp_torch.models.resnet import NetResDeep
    from tpu_ddp_torch.models.resnet_family import ResNet, WideResNet
    from tpu_ddp_torch.models.vit import ViT
    from tpu_ddp_torch.parallel.tensor_parallel import CNN_TP_RULES, VIT_TP_RULES

    if isinstance(model, (ViT, MoEViT)):
        return VIT_TP_RULES
    if isinstance(model, (NetResDeep, ResNet, WideResNet)):
        return CNN_TP_RULES
    raise ValueError(
        f"--parallelism {parallelism} has no partition-rule set for "
        f"{type(model).__name__}; supported families: ViT/MoEViT "
        "(Megatron rules) and NetResDeep/ResNet/WideResNet "
        "(channel-sharding rules)"
    )


def _require_model(model, kinds: tuple, parallelism: str) -> None:
    """The JAX ``_require_model`` (:234): a ViT or an MoE ViT."""
    from tpu_ddp_torch.models.moe import MoEViT
    from tpu_ddp_torch.models.vit import ViT

    by_name = {"vit": ViT, "moe": MoEViT}
    allowed = tuple(by_name[k] for k in kinds)
    if not isinstance(model, allowed):
        names = " or ".join(a.__name__ for a in allowed)
        raise ValueError(
            f"--parallelism {parallelism} needs a {names} model (its "
            f"partition rules key on that family's parameter paths); got "
            f"{type(model).__name__}. Pick e.g. --model vit_s4"
            + (" / vit_moe_s4" if "moe" in kinds else "")
        )


def pp_schedule_line(n_stages: int, n_microbatches: int, schedule: str) -> str:
    """The line the pp strategy prints (the JAX :466-476)."""
    from tpu_ddp_torch.parallel.pipeline import pp_schedule_stats

    stats = pp_schedule_stats(n_stages, n_microbatches, schedule)
    return (f"pp strategy: schedule={stats['schedule']} "
            f"stages={n_stages} microbatches="
            f"{n_microbatches} bubble={stats['bubble_fraction']:.1%} "
            f"in-flight={stats['in_flight_microbatches']} "
            f"recompute={stats['recompute']}")


@dataclasses.dataclass
class Strategy:
    """What the ``Trainer`` takes from a family: its state and steps, the
    state's ``layout`` (``train/state.py::StateLayout``: sp's partition over
    the data group, a GSPMD family's cut, pp's stage), sp's compressor, and
    the line the family printed (pp's schedule)."""

    state: object
    train_step: Callable
    eval_step: Callable
    predict_step: Callable
    layout: object
    compress: Optional[object] = None
    line: Optional[str] = None


def check_strategy(parallelism: str, model: torch.nn.Module, *, remat: bool = False,
                   grad_accum_steps: int = 1, zero1: bool = False,
                   grad_compress: Optional[dict] = None) -> None:
    """``build_strategy``'s guards, in the JAX order (:332-351), before
    anything is built: the flags a family refuses and the model the family
    needs (a ViT for sp and pp, the MoE ViT for ep, a rule set for tp and
    fsdp_tp)."""
    if (remat or grad_accum_steps > 1) and parallelism in ("pp", "sp"):
        raise ValueError(
            "--remat/--grad-accum-steps are not supported with "
            f"--parallelism {parallelism} (pp schedules microbatches "
            "itself; sp's ring step owns its memory story)"
        )
    if zero1 and parallelism not in ("dp", "sp"):
        raise ValueError(
            f"--zero1 is not supported with --parallelism {parallelism}: "
            "fsdp/fsdp_tp already scatter the optimizer state (ZeRO-3 "
            "subsumes ZeRO-1), and tp/pp/ep own their state layout. Use "
            "--zero1 with dp or sp."
        )
    if grad_compress and parallelism not in ("dp", "sp"):
        raise ValueError(
            f"--grad-compress is not supported with --parallelism "
            f"{parallelism}: the fsdp/tp/pp/ep families' gradient "
            "movement is GSPMD-internal, not a pmean this router owns. "
            "Use --grad-compress with dp or sp."
        )
    if parallelism not in PARALLELISMS:
        raise ValueError(f"unknown parallelism {parallelism!r}")
    if parallelism == "dp":
        raise ValueError("dp runs in the Trainer, not through build_strategy")
    if parallelism in ("sp", "pp"):
        _require_model(model, ("vit",), parallelism)
    elif parallelism == "ep":
        _require_model(model, ("moe",), "ep")
    elif parallelism in ("tp", "fsdp_tp"):
        _tp_rules_for(model, parallelism)


def _gspmd_eval_predict(mesh: Mesh, *, loss_fn: Callable, compute_accuracy: bool):
    """Eval and predict of the GSPMD families (the JAX :188): the sharded
    model in eval mode on this rank's data shard's rows, the eval sums
    summed over the data group once (the model group's ranks hold the same
    rows and the same logits)."""
    from tpu_ddp_torch.train.steps import make_eval_step, make_predict_step

    return (make_eval_step(loss_fn, compute_accuracy=compute_accuracy,
                           group=mesh.data_group()),
            make_predict_step())


def build_strategy(parallelism: str, mesh: Mesh, model: torch.nn.Module, tx,
                   device: torch.device, *, loss_fn: Callable = cross_entropy_loss,
                   compute_accuracy: bool = True, sp_flash: bool = False,
                   initial_state=None, remat: bool = False, grad_accum_steps: int = 1,
                   health=None, zero1: bool = False,
                   grad_compress: Optional[dict] = None, aux_weight: float = 0.01,
                   n_microbatches: int = 4, pp_schedule: str = "gpipe") -> Strategy:
    """The strategy of ``parallelism`` (not dp) on ``mesh`` (module
    docstring), after ``check_strategy``. ``initial_state``: a replicated
    state to lay out instead of a fresh one (the trainer's, the fine-tune
    path's); ``health`` a ``HealthConfig`` or None; ``grad_compress`` the
    ``GradCompression`` fields (``mode``, ``block``, ``error_feedback``,
    ``kernels``); ``aux_weight`` the auxiliary losses' weight;
    ``n_microbatches`` and ``pp_schedule`` pp's."""
    from tpu_ddp_torch.parallel import tensor_parallel as tpar
    from tpu_ddp_torch.parallel.sequence_parallel import image_stripe, make_sp_train_step
    from tpu_ddp_torch.train.state import StateLayout, create_train_state
    from tpu_ddp_torch.train.steps import make_eval_step, make_predict_step

    check_strategy(parallelism, model, remat=remat, grad_accum_steps=grad_accum_steps,
                   zero1=zero1, grad_compress=grad_compress)
    state = initial_state or create_train_state(model, tx, device)
    if parallelism == "pp":
        return _pp_strategy(state, tx, mesh, loss_fn=loss_fn,
                            compute_accuracy=compute_accuracy, health=health,
                            n_microbatches=n_microbatches, schedule=pp_schedule)
    if parallelism != "sp":
        kw = dict(loss_fn=loss_fn, compute_accuracy=compute_accuracy, remat=remat,
                  grad_accum_steps=grad_accum_steps, health=health, aux_weight=aux_weight)
        if parallelism == "fsdp":
            step, state, layout = tpar.make_fsdp_train_step(state, tx, mesh, **kw)
        elif parallelism == "ep":
            from tpu_ddp_torch.parallel.expert_parallel import make_ep_train_step

            step, state, layout = make_ep_train_step(state, tx, mesh, **kw)
        else:
            build = (tpar.make_tp_train_step if parallelism == "tp"
                     else tpar.make_fsdp_tp_train_step)
            step, state, layout = build(state, tx, mesh,
                                        rules=_tp_rules_for(model, parallelism), **kw)
        eval_step, predict_step = _gspmd_eval_predict(
            mesh, loss_fn=loss_fn, compute_accuracy=compute_accuracy)
        return Strategy(state=state, train_step=step, eval_step=eval_step,
                        predict_step=predict_step, layout=layout)
    part = comp = None
    params = state.params()
    if zero1:
        from tpu_ddp_torch.parallel.zero import Zero1Partition

        part = Zero1Partition(tx, params, mesh.data_size, rank=mesh.data_index,
                              group=mesh.data_group())
        state = part.shard_state(state)
    if grad_compress:
        from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

        comp = GradCompressor(GradCompression(**grad_compress), params, mesh.data_size,
                              group=mesh.data_group())
        if part is not None:
            part.set_compression(comp)
        if comp.config.error_feedback:
            # scattered over data, replicated over sequence (the JAX :385-397)
            state.grad_residual = comp.init_residual(device)
    inner = make_sp_train_step(tx, mesh, sp_flash=sp_flash, loss_fn=loss_fn,
                               health=health, zero1=part, compress=comp)
    patch = model.patch_size

    def train_step(state, batch):
        return inner(state, dict(batch, image=image_stripe(batch["image"], mesh, patch)))

    return Strategy(state=state, train_step=train_step,
                    eval_step=make_eval_step(loss_fn, compute_accuracy=compute_accuracy),
                    predict_step=make_predict_step(), layout=StateLayout(zero=part),
                    compress=comp)


def _pp_strategy(state, tx, mesh: Mesh, *, loss_fn: Callable, compute_accuracy: bool,
                 health, n_microbatches: int, schedule: str) -> Strategy:
    """The pp family (module docstring): the replicated ``state`` laid out
    for this rank's stage in place, the schedule's step, and evaluation on
    a whole copy of the module taken before the cut."""
    import copy

    from tpu_ddp_torch.parallel import pipeline as ppl
    from tpu_ddp_torch.parallel.runtime import is_primary_process
    from tpu_ddp_torch.train.state import StateLayout
    from tpu_ddp_torch.train.steps import make_eval_step, make_predict_step

    ppl.check_clip(tx)
    plain = copy.deepcopy(state.model)
    layout = ppl.layout_pipeline(state, tx, mesh)
    step = ppl.make_pp_train_step(state.model, tx, mesh, n_microbatches=n_microbatches,
                                  schedule=schedule, loss_fn=loss_fn,
                                  compute_accuracy=compute_accuracy, health=health)
    line = pp_schedule_line(mesh.pipeline_size, n_microbatches, schedule)
    if is_primary_process():
        print(line, flush=True)
    return Strategy(state=state, train_step=step,
                    eval_step=make_eval_step(loss_fn, compute_accuracy=compute_accuracy,
                                             group=mesh.data_group(), model=plain),
                    predict_step=make_predict_step(model=plain),
                    layout=StateLayout(tp=layout), line=line)


@dataclasses.dataclass
class StepProgram:
    """A run's train step and its first batch (``build_step_program``):
    ``step()`` runs one optimizer step in place and returns its metrics;
    ``leaves()`` is the rank's state by section
    (``train/state.py::StateLayout.leaves``); ``close()`` releases the
    trainer. ``in_place=False`` is the graph lint's injected fault
    (``analysis/lint.py``, DON001): the step then leaves its new params,
    optimizer state and BatchNorm statistics in fresh tensors, as an
    out-of-place update (``p.data = new``) would, and the old ones are
    freed after it."""

    trainer: object
    batch: dict
    in_place: bool = True

    def step(self) -> dict:
        t = self.trainer
        t.state, metrics = t.train_step(t.state, self.batch)
        if not self.in_place:
            with torch.no_grad():
                for section, name, leaf, _, _ in self.leaves():
                    if section in ("params", "batch_stats"):
                        leaf.data = leaf.data.clone()
                opt = t.state.opt_state
                for slot in ("trace", "mu", "nu", "ema"):
                    if getattr(opt, slot):
                        setattr(opt, slot, {n: v.clone() for n, v in getattr(opt, slot).items()})
        return metrics

    def leaves(self) -> list:
        return self.trainer.layout.leaves(self.trainer.state)

    def close(self) -> None:
        self.trainer.close()


def build_step_program(config, *, model: Optional[torch.nn.Module] = None,
                       loss_fn: Optional[Callable] = None,
                       in_place: bool = True) -> StepProgram:
    """The train step of ``config`` (a ``TrainConfig``) built as a run
    builds it, by a ``Trainer`` over this process's group (``model``: one
    to train in place of the config's; ``loss_fn``: a loss in place of
    the config's), with its loader's first batch of epoch 1 on the device;
    ``in_place`` as ``StepProgram``'s."""
    from tpu_ddp_torch.train.trainer import Trainer

    trainer = Trainer(config, model=model, loss_fn=loss_fn)
    loader = trainer.train_loader
    loader.set_epoch(1)
    batch = next(iter(loader.epoch_batches()))
    return StepProgram(trainer, trainer.to_device(batch), in_place)
