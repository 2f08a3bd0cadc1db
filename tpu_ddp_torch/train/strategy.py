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
every rank (the params' shapes are the same either way), so checkpoints
keep the replicated layout; evaluation and prediction run the plain module
on whole images, each rank on its data shard's rows, replicated over the
ring (the JAX :400-411). ``--zero1`` and ``--grad-compress`` under sp are
deferred (``ROADMAP.md`` §1 item 1) and raise. The other families (fsdp,
tp, fsdp_tp, pp, ep) are not ported yet (``ROADMAP.md`` §1 item 2) and
raise.
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
#: the families the port runs
PORTED = ("dp", "sp")

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


def _require_model(model, kinds: tuple, parallelism: str) -> None:
    """The JAX ``_require_model`` (:234) for the families the port has: a
    ViT (the MoE family is not ported)."""
    from tpu_ddp_torch.models.vit import ViT

    by_name = {"vit": ViT}
    allowed = tuple(by_name[k] for k in kinds)
    if not isinstance(model, allowed):
        names = " or ".join(a.__name__ for a in allowed)
        raise ValueError(
            f"--parallelism {parallelism} needs a {names} model (its "
            f"partition rules key on that family's parameter paths); got "
            f"{type(model).__name__}. Pick e.g. --model vit_s4"
        )


@dataclasses.dataclass
class Strategy:
    """What the ``Trainer`` takes from a family: its state and steps."""

    state: object
    train_step: Callable
    eval_step: Callable
    predict_step: Callable


def check_strategy(parallelism: str, model: torch.nn.Module, *, remat: bool = False,
                   grad_accum_steps: int = 1, zero1: bool = False,
                   grad_compress: Optional[dict] = None) -> None:
    """``build_strategy``'s guards, in the JAX order (:332-351), before
    anything is built: the flags a family refuses, the families not ported,
    the model the family needs, and sp's deferred overlays."""
    from tpu_ddp_torch.parallel.sequence_parallel import DEFERRED

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
    if parallelism not in PORTED:
        raise ValueError(
            f"--parallelism {parallelism} is not ported yet: the port runs dp "
            "and sp (ROADMAP.md §1 item 2 queues the GSPMD families, the "
            "pipeline and experts)")
    if parallelism == "dp":
        raise ValueError("dp runs in the Trainer, not through build_strategy")
    _require_model(model, ("vit",), "sp")
    if zero1 or grad_compress:
        raise ValueError(DEFERRED)


def build_strategy(parallelism: str, mesh: Mesh, model: torch.nn.Module, tx,
                   device: torch.device, *, loss_fn: Callable = cross_entropy_loss,
                   compute_accuracy: bool = True, sp_flash: bool = False,
                   initial_state=None, remat: bool = False, grad_accum_steps: int = 1,
                   health=None, zero1: bool = False,
                   grad_compress: Optional[dict] = None) -> Strategy:
    """The strategy of ``parallelism`` (not dp) on ``mesh`` (module
    docstring), after ``check_strategy``. ``initial_state``: a state to lay
    out instead of a fresh one (the fine-tune path); ``health`` a
    ``HealthConfig`` or None."""
    from tpu_ddp_torch.parallel.sequence_parallel import image_stripe, make_sp_train_step
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.steps import make_eval_step, make_predict_step

    check_strategy(parallelism, model, remat=remat, grad_accum_steps=grad_accum_steps,
                   zero1=zero1, grad_compress=grad_compress)
    state = initial_state or create_train_state(model, tx, device)
    inner = make_sp_train_step(tx, mesh, sp_flash=sp_flash, loss_fn=loss_fn,
                               health=health)
    patch = model.patch_size

    def train_step(state, batch):
        return inner(state, dict(batch, image=image_stripe(batch["image"], mesh, patch)))

    return Strategy(state=state, train_step=train_step,
                    eval_step=make_eval_step(loss_fn, compute_accuracy=compute_accuracy),
                    predict_step=make_predict_step())
