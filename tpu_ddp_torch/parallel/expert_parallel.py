"""Expert parallelism (``--parallelism ep``): the MoE ViT's experts cut over
the ``expert`` axis.

Counterpart of ``tpu_ddp/parallel/expert_parallel.py`` (``MOE_EP_RULES``
:33, ``make_ep_train_step`` :41). The JAX package annotates the stacked
expert weights ``P('expert', ...)`` and lets GSPMD partition the dispatch
and combine products; the batch is sharded over ``data`` only, so every
rank of an expert group holds the same tokens. Here the layout is
``parallel/tensor_parallel.py``'s ``TensorParallel`` over the expert axis,
read from the same rules: each rank keeps ``E / ep`` consecutive experts'
rows of ``w_up``, ``b_up``, ``w_down`` and ``b_down`` (their leading axis),
the router and everything else whole. The MoE layer computes its routing
whole, runs this rank's experts on their slots and sums the combine over
the expert group in one autograd all-reduce (``models/moe.py``): at this
layout no all-to-all is needed, the tokens are already on every rank.

The step is the GSPMD family's ``make_sharded_train_step``: the global
masked-mean task loss plus ``aux_weight`` times the load-balance loss, the
data group's gradient reduction, K1 (under ``--kernels``) on each rank's
leaves, the clip's and lamb's norms over whole leaves (the expert leaves'
squares summed over the expert group, the replicated ones counted once),
the DP health schema, ``metrics["aux_loss"]``. Checkpoints gather the
experts whole (``StateLayout``), so ep, dp and fsdp runs of the MoE ViT
resume from each other's.
"""

from __future__ import annotations

from typing import Callable, Tuple

from tpu_ddp_torch.parallel.mesh import EXPERT_AXIS, Mesh
from tpu_ddp_torch.parallel.partitioning import PartitionRule
from tpu_ddp_torch.train.state import StateLayout, TrainState

# Layout for models/moe.py's MoEMlp (the JAX :33-38; paths like
# block_1/moe/w_up). The router stays replicated.
MOE_EP_RULES = (
    PartitionRule(r"moe/w_up$", (EXPERT_AXIS, None, None)),
    PartitionRule(r"moe/b_up$", (EXPERT_AXIS, None)),
    PartitionRule(r"moe/w_down$", (EXPERT_AXIS, None, None)),
    PartitionRule(r"moe/b_down$", (EXPERT_AXIS, None)),
)


def layout_experts(state: TrainState, mesh: Mesh, rules=MOE_EP_RULES) -> StateLayout:
    """Cut a replicated ``state`` of an MoE ViT over the expert group, in
    place (the experts' rows and their optimizer slots); returns its
    ``StateLayout``."""
    from tpu_ddp_torch.models.moe import MoEMlp
    from tpu_ddp_torch.parallel.tensor_parallel import TensorParallel

    model = state.model
    for m in model.modules():
        if isinstance(m, MoEMlp) and m.num_experts % mesh.expert_size:
            raise ValueError(f"{m.num_experts} experts do not divide over "
                             f"expert={mesh.expert_size} ranks")
    ep = TensorParallel(model, rules, mesh.expert_size, mesh.expert_index,
                        mesh.expert_group(), axis=EXPERT_AXIS)
    ep.shard_model_(model)
    state.opt_state = ep.opt_state(state.opt_state, ep.scatter)
    return StateLayout(tp=ep)


def make_ep_train_step(state: TrainState, tx, mesh: Mesh, *, rules=MOE_EP_RULES,
                       aux_weight: float = 0.01,
                       **kwargs) -> Tuple[Callable, TrainState, StateLayout]:
    """Expert-parallel (DP x EP on ``data`` x ``expert``) step for the
    replicated ``state`` of an MoE ViT, which is laid out in place. Returns
    ``(step, state, layout)``; ``kwargs`` as
    ``tensor_parallel.make_sharded_train_step``'s."""
    from tpu_ddp_torch.parallel.tensor_parallel import make_sharded_train_step

    layout = layout_experts(state, mesh, rules)
    step = make_sharded_train_step(tx, mesh, layout, aux_weight=aux_weight, **kwargs)
    return step, state, layout
