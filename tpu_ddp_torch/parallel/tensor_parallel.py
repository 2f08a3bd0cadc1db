"""Tensor parallelism (Megatron), FSDP and their 2-D composition: the
GSPMD families (``--parallelism tp``, ``fsdp``, ``fsdp_tp``).

Counterpart of ``tpu_ddp/parallel/tensor_parallel.py`` (``VIT_TP_RULES``
:45, ``CNN_TP_RULES`` :65, ``make_sharded_train_step`` :84,
``make_tp_train_step`` :252, ``make_fsdp_tp_train_step`` :283,
``make_fsdp_train_step`` :320). The JAX package annotates the params with
``PartitionSpec``s and lets the XLA partitioner insert the collectives;
PyTorch has no partitioner this port leans on, so the layout here is
explicit and the collectives are written out, on the rank grid of
``parallel/mesh.py`` (``model`` innermost).

**The layout** (``TensorParallel``) is read from the rules' specs
(``parallel/partitioning.py::specs_for_params`` over the JAX paths and
shapes of the port's params, ``jax_view``), not written a second time: a
leaf whose spec names ``model`` at a JAX dimension is cut along the
matching torch dimension, and each rank of the model group keeps its rows
as the ``nn.Parameter`` itself (``p.data``), so names, the optimizer state
and K1 see ordinary local leaves. The cut is contiguous and as even as the
size allows (``np.array_split``), except in attention: a rank holds whole
heads, its heads' q, k and v columns of ``qkv`` (and of its bias) and the
matching input rows of ``proj``, as Megatron does, because JAX's
contiguous column block of ``qkv`` would cut q from k at ``model=2``. The
heads split as evenly as their count allows (ViT-S/4's 3 heads at
``model=2``: 2 and 1). A stored shard is therefore a permutation of the
JAX one; ``gather`` and ``scatter`` map between a rank's leaves and the
whole ones by the index lists.

**The arithmetic** is GSPMD's global one, with the model-axis collectives
as ``torch.autograd.Function``s over ``mesh.model_group()``:
``copy_to_model`` (identity; the backward all-reduces),
``reduce_from_model`` (all-reduce; the backward is the identity) and
``gather_from_model`` (all-gather along a dimension; the backward
reduce-scatters). The modules whose weight is cut change class (their
parameters and names stay): ``ColumnParallelDense`` (``qkv``, ``mlp_up``,
``fc1``: whole input, cut output, its bias cut with it),
``RowParallelDense`` (``proj``, ``mlp_down``, ``fc2``, the ResNet family's
``head``: cut input, one all-reduce, the whole bias added once after it)
and ``ColumnParallelConv2d`` (every conv of the conv families: its output
channels cut; an input whose channels are cut is all-gathered first).
BatchNorm after a cut conv normalises its own channels, so the conv
families' activations stay channel-cut through the blocks, residuals
included; ``fc1`` gathers the flattened channels, the pooled head takes
them cut. Replicated params (LayerNorms, ``pos_embed``, ``patch_embed``,
the ViT's ``head``) get whole gradients on every model rank, never summed
over it. The model is the same module object, so evaluation and
``predict`` run it sharded.

**The step** (``make_sharded_train_step``): the loss is the masked mean
over the GLOBAL batch, each rank's masked sum over the count summed over
the data group, so the data group's reduction of the gradients is their
SUM; BatchNorm takes its statistics over the data group
(``models/resnet.py::sync_stats``), as over the global batch. ``tp``: one
all-reduce of the gradients over the data group, then ``tx`` (K1 under
``--kernels``) on the local leaves. ``fsdp``: ``Zero3Partition`` over the
data group (``parallel/zero.py``, its reduction a sum: ``average =
False``), the params streamed block by block. ``fsdp_tp``: the same
partition over each rank's tensor-parallel leaves. The clip's norm is the
global one: the squares of the model-cut leaves summed over the model
group, the replicated ones counted once, and under fsdp over the data
group first (``leaf_sums``); lamb's trust ratios take the same sums, so
each is the whole leaf's, as under GSPMD. ``--remat`` and ``--grad-accum-steps`` compose; a microbatch
is the JAX step's, a slice of the GLOBAL batch (rows ``[k * B / K, (k + 1)
* B / K)``, cut over the data group), so under accumulation the data
group first all-gathers its batch (``_microbatches``), and each
microbatch's loss is its own masked mean and its BatchNorm statistics its
own. ``--health`` gives the DP schema with global norms. A model with
auxiliary losses (the MoE ViT) adds ``aux_weight`` times their mean over
the global batch (the JAX :131-152, :197-217), reported as ``aux_loss``.
``TensorParallel`` also cuts over the expert axis
(``parallel/expert_parallel.py``), whose rules cut only the MoE experts.

Deliberate differences from the JAX package (``ROADMAP.md`` §3): the
head-aligned qkv shards; FSDP keeps ZeRO-3's flat chunks where
``fsdp_specs`` leaves small and indivisible leaves replicated (memory,
not arithmetic); K1 runs the update where the JAX GSPMD step calls
``tx.update`` (K1 is bitwise its plain version).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.health.stats import HealthConfig, assemble_stats, leaf_norms, leaf_peaks
from tpu_ddp_torch.models.layers import Conv2d, Dense
from tpu_ddp_torch.models.moe import sown_aux_losses
from tpu_ddp_torch.models.resnet import BatchNorm
from tpu_ddp_torch.parallel.collectives import (
    _all_reduce_flat,
    all_gather_bytes,
    all_reduce_sum_,
    group_size,
    rank_mean,
    reduce_scatter_sum,
)
from tpu_ddp_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, Mesh
from tpu_ddp_torch.parallel.partitioning import PartitionRule, specs_for_params
from tpu_ddp_torch.train.losses import combine_aux_loss, cross_entropy_loss
from tpu_ddp_torch.train.state import StateLayout, TrainState, map_opt_slots
from tpu_ddp_torch.train.steps import (
    StepHealth,
    _forward,
    _metric_sums,
    _step_metrics,
    streamed,
)

Tree = Dict[str, torch.Tensor]

# Megatron-style layout for models/vit.py's ViT (the JAX :45)
VIT_TP_RULES = (
    PartitionRule(r"attn/qkv/kernel$", (None, MODEL_AXIS)),
    PartitionRule(r"attn/qkv/bias$", (MODEL_AXIS,)),
    PartitionRule(r"attn/proj/kernel$", (MODEL_AXIS, None)),
    PartitionRule(r"mlp_up/kernel$", (None, MODEL_AXIS)),
    PartitionRule(r"mlp_up/bias$", (MODEL_AXIS,)),
    PartitionRule(r"mlp_down/kernel$", (MODEL_AXIS, None)),
)

# Channel sharding for the conv families (NetResDeep, the ResNet family and
# WideResNet; the JAX :65): every conv out-channel-cut (HWIO: O), BatchNorm
# with its channels, the dense head closed Megatron-style
CNN_TP_RULES = (
    PartitionRule(r"(conv[^/]*|Conv_\d+)/kernel$", (None, None, None, MODEL_AXIS)),
    PartitionRule(r"(conv[^/]*|Conv_\d+)/bias$", (MODEL_AXIS,)),
    PartitionRule(r"(batch_norm|BatchNorm_\d+|stem_bn|final_bn)/(scale|bias)$",
                  (MODEL_AXIS,)),
    PartitionRule(r"fc1/kernel$", (None, MODEL_AXIS)),
    PartitionRule(r"fc1/bias$", (MODEL_AXIS,)),
    PartitionRule(r"fc2/kernel$", (MODEL_AXIS, None)),
    PartitionRule(r"head/kernel$", (MODEL_AXIS, None)),
)


# ---- the model axis's collectives ---------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce_flat([x], group).view(x.shape)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model group's equal pieces laid side by side along ``dim``, in
    rank order; the backward reduce-scatters the gradient back."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        n = group_size(group)
        rows = all_gather_bytes(x.contiguous().view(-1), group).view(n, *x.shape)
        out = rows.movedim(0, dim)
        return out.reshape(*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        dim, shape = ctx.dim, ctx.shape
        n = group_size(ctx.group)
        g = g.reshape(*shape[:dim], n, shape[dim], *shape[dim + 1:]).movedim(dim, 0)
        return reduce_scatter_sum(g.contiguous().view(-1), ctx.group).view(shape), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over the model group ``group``."""
    return x if group_size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the model group; the gradient passes as it is."""
    return x if group_size(group) == 1 else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model group's equal pieces of a tensor cut along ``dim``, whole;
    the gradient is reduce-scattered back to the pieces."""
    return x if group_size(group) == 1 else _GatherFromModel.apply(x, dim, group)


# ---- the layers whose weight is cut ----------------------------------------------


class ColumnParallelDense(Dense):
    """A ``Dense`` holding its output rows' cut: the input whole (a
    flattened channel-cut activation, ``fc1``'s, is gathered first), the
    output cut (module docstring)."""

    tp_group = None
    channels: Optional[int] = None   # the channels of a flattened input

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_features:
            n = x.shape[0]
            local = self.channels // group_size(self.tp_group)
            x = gather_from_model(x.reshape(n, -1, local), 2, self.tp_group).reshape(n, -1)
        else:
            x = copy_to_model(x, self.tp_group)
        return super().forward(x)


class RowParallelDense(Dense):
    """A ``Dense`` holding its input columns' cut: the partial product, one
    all-reduce over the model group, then the whole bias (module
    docstring)."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight if dt == torch.float32 else self.weight.to(dt)
        y = reduce_from_model(F.linear(x.to(dt), w), self.tp_group)
        return y if self.bias is None else y + self.bias.to(dt)


class ColumnParallelConv2d(Conv2d):
    """A ``Conv2d`` holding its output channels' cut; an input whose
    channels are cut (fewer than ``in_channels``) is gathered over the model
    group first (module docstring)."""

    tp_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.in_channels:
            x = gather_from_model(x.permute(0, 2, 3, 1), 3, self.tp_group).permute(0, 3, 1, 2)
        else:
            x = copy_to_model(x, self.tp_group)
        return super().forward(x)


# ---- the layout -------------------------------------------------------------------


def jax_view(model: nn.Module) -> Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...]]]:
    """``{name: (path, jax_shape, dims)}`` for every param of ``model``: its
    JAX tree path (``/`` between the keys, ``kernel``, ``scale`` or
    ``embedding`` for ``weight``), its JAX shape, and ``dims[d]``, the
    torch dimension of JAX dimension d (``checkpoint/convert.py``'s
    transposes)."""
    out = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            leaf, dims = pname, tuple(range(p.ndim))
            if pname == "weight":
                if isinstance(m, nn.Conv2d):
                    leaf, dims = "kernel", (2, 3, 1, 0)
                elif isinstance(m, nn.Linear):
                    leaf, dims = "kernel", (1, 0)
                elif isinstance(m, nn.Embedding):
                    leaf = "embedding"
                else:
                    leaf = "scale"
            path = "/".join(mname.split(".") + [leaf]) if mname else leaf
            out[name] = (path, tuple(p.shape[d] for d in dims), dims)
    return out


def even_split(size: int, parts: int) -> List[np.ndarray]:
    """Indices ``0 .. size - 1`` cut into ``parts`` contiguous runs, as even
    as the size allows."""
    return np.array_split(np.arange(size), parts)


def head_split(num_heads: int, head_dim: int, parts: int, copies: int) -> List[np.ndarray]:
    """Each rank's whole heads' indices in a dimension of ``copies`` blocks
    of ``num_heads * head_dim`` (qkv: 3 blocks, q, k and v; proj's input:
    1), the heads as even as their count allows."""
    if parts > num_heads:
        raise ValueError(f"model={parts} ranks for {num_heads} attention heads: a "
                         "tensor-parallel rank holds whole heads")
    width = num_heads * head_dim
    out = []
    for heads in np.array_split(np.arange(num_heads), parts):
        cols = np.arange(heads[0] * head_dim, (heads[-1] + 1) * head_dim)
        out.append(np.concatenate([c * width + cols for c in range(copies)]))
    return out


class TensorParallel:
    """The ``axis`` layout (the model axis; the expert axis for
    ``parallel/expert_parallel.py``) of ``model``'s params under ``rules``
    over the ``size`` ranks of ``group``, this rank at ``index`` (module
    docstring). ``layout[name] = (dim, indices)``: the torch dimension cut
    and each rank's indices along it (params, and a cut BatchNorm's running
    buffers); a name not in it is replicated. Built from the whole model,
    before ``shard_model_`` cuts it."""

    def __init__(self, model: nn.Module, rules, size: int, index: int, group,
                 axis: str = MODEL_AXIS):
        from tpu_ddp_torch.models.vit import MultiHeadSelfAttention

        self.size, self.index, self.group, self.axis = size, index, group, axis
        self.once: Dict[tuple, torch.Tensor] = {}    # ``_model_once``'s masks
        view = jax_view(model)
        specs = specs_for_params({path: shape for path, shape, _ in view.values()}, rules)
        heads = {}
        for mname, m in model.named_modules():
            if isinstance(m, MultiHeadSelfAttention) and axis == MODEL_AXIS:
                cut = lambda copies, m=m: head_split(m.num_heads, m.head_dim, size, copies)  # noqa: E731
                heads[f"{mname}.qkv.weight"] = heads[f"{mname}.qkv.bias"] = cut(3)
                heads[f"{mname}.proj.weight"] = cut(1)
        params = dict(model.named_parameters())
        self.layout: Dict[str, Tuple[int, List[torch.Tensor]]] = {}
        for name, (path, _, dims) in view.items():
            spec = specs[path]
            if axis not in spec:
                continue
            dim = dims[spec.index(axis)]
            cut = heads.get(name) or even_split(params[name].shape[dim], size)
            self.layout[name] = (dim, [torch.as_tensor(i, dtype=torch.int64) for i in cut])
        for mname, m in model.named_modules():
            if isinstance(m, BatchNorm) and f"{mname}.weight" in self.layout:
                for buf in ("running_mean", "running_var"):
                    self.layout[f"{mname}.{buf}"] = self.layout[f"{mname}.weight"]

    def sharded(self, name: str) -> bool:
        return name in self.layout

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's cut of the whole ``t`` (``name``'s), a new tensor;
        ``t`` itself where ``name`` is replicated."""
        if name not in self.layout:
            return t
        dim, idx = self.layout[name]
        return t.index_select(dim, idx[self.index].to(t.device)).contiguous()

    def scatter(self, tree: Tree) -> Tree:
        """Whole leaves -> this rank's (no collective)."""
        return {n: self.local(n, t) for n, t in tree.items()}

    @torch.no_grad()
    def gather(self, tree: Tree) -> Tree:
        """This rank's leaves -> the whole ones on every rank of the model
        group (one all-gather a cut leaf; a collective, every rank of the
        group calls it with the same names in the same order)."""
        out = {}
        for name, t in tree.items():
            if name not in self.layout or self.size == 1:
                out[name] = t
                continue
            dim, idx = self.layout[name]
            lens = [len(i) for i in idx]
            pad = list(t.shape)
            pad[dim] = max(lens) - t.shape[dim]
            piece = torch.cat([t, t.new_zeros(pad)], dim) if pad[dim] else t
            rows = all_gather_bytes(piece.contiguous().view(-1), self.group)
            rows = rows.view(self.size, *piece.shape)
            shape = list(t.shape)
            shape[dim] = sum(lens)
            whole = t.new_empty(shape)
            for r, i in enumerate(idx):
                whole.index_copy_(dim, i.to(t.device), rows[r].narrow(dim, 0, lens[r]))
            out[name] = whole
        return out

    @torch.no_grad()
    def shard_model_(self, model: nn.Module) -> None:
        """Cut ``model`` in place: each cut param and buffer keeps this
        rank's rows, and the modules whose weight is cut change class
        (module docstring). The conv families' ``fc1`` learns the channel
        count of the last cut conv before it, to gather its flattened
        input; under the expert axis each MoE layer learns its experts
        (``models/moe.py::set_expert_parallel``)."""
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name in self.layout:
                t.data = self.local(name, t.data)
        if self.axis == EXPERT_AXIS:
            from tpu_ddp_torch.models.moe import set_expert_parallel

            set_expert_parallel(model, self.group, self.size, self.index)
            return
        channels = None
        for mname, m in model.named_modules():
            dim = self.layout.get(f"{mname}.weight", (None,))[0]
            if dim is None:
                continue
            if isinstance(m, nn.Conv2d):
                if dim != 0:
                    raise ValueError(f"{mname}: only a conv's output channels are cut")
                if m.out_channels % self.size:
                    raise ValueError(
                        f"{mname} has {m.out_channels} output channels, not divisible "
                        f"by model={self.size}: a cut activation is gathered in equal "
                        "pieces")
                m.__class__, channels = ColumnParallelConv2d, m.out_channels
            elif isinstance(m, nn.Linear):
                m.__class__ = ColumnParallelDense if dim == 0 else RowParallelDense
                if dim == 0:
                    m.channels = channels
            else:
                continue
            m.tp_group = self.group

    def opt_state(self, opt_state, fn):
        """``opt_state`` with every param-shaped slot mapped by ``fn``
        (``scatter`` or ``gather``); the counts as they are."""
        return map_opt_slots(opt_state, fn)


def sync_batch_norm_(model: nn.Module, group) -> None:
    """Every BatchNorm of ``model`` takes its batch statistics over the
    ranks of ``group`` (the data group: the GSPMD families' global batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.axis_name, m.sync_group = DATA_AXIS, group


# ---- the laid-out state ------------------------------------------------------------


def layout_state(state: TrainState, tx, mesh: Mesh, *, rules=None,
                 fsdp: bool = False) -> Tuple[TrainState, StateLayout]:
    """Lay a replicated ``state`` (whole model, ``tx.init``'s state) out for
    this rank, in place: cut over the model group under ``rules``, then
    under ``fsdp`` scattered over the data group (``Zero3Partition`` over
    the leaves it holds, the optimizer state in its shard space; its
    reduction a sum, its norms ``leaf_sums``'s), with BatchNorm's
    statistics over the data group. The checkpoint's layout stays the
    replicated one (``train/state.py::StateLayout``)."""
    from tpu_ddp_torch.parallel.zero import Zero3Partition

    model = state.model
    tp = None
    if rules is not None:
        tp = TensorParallel(model, rules, mesh.model_size, mesh.model_index,
                            mesh.model_group())
        tp.shard_model_(model)
        state.opt_state = tp.opt_state(state.opt_state, tp.scatter)
    sync_batch_norm_(model, mesh.data_group())
    zero = None
    if fsdp:
        zero = Zero3Partition(tx, dict(model.named_parameters()), mesh.data_size,
                              rank=mesh.data_index, group=mesh.data_group(),
                              average=False, leaf_sums=leaf_sums(tp, mesh, fsdp))
        state.opt_state = zero.shard_opt_state(state.opt_state)
        state.param_shards = zero.shard_model_(model)
    return state, StateLayout(tp, zero)


# ---- the step ------------------------------------------------------------------------


def _model_once(tp: Optional[TensorParallel], names, device) -> Optional[torch.Tensor]:
    """``(L,)`` 1.0 where leaf ``names[i]`` is summed over the model group:
    a cut leaf, or a replicated one on the group's first rank (so it counts
    once), on ``device`` (kept while the same names come back); None
    without a model axis."""
    if tp is None or tp.size == 1:
        return None
    key = (tuple(names), device)
    if key not in tp.once:
        tp.once[key] = torch.tensor([float(tp.sharded(n) or tp.index == 0) for n in names],
                                    device=device)
    return tp.once[key]


def leaf_sums(tp: Optional[TensorParallel], mesh: Mesh, fsdp: bool) -> Callable:
    """``train/optim.py``'s ``LeafSums`` of the layout: per-leaf values of
    this rank summed over the ranks that split the leaves, the data group
    under ``fsdp`` (every leaf is a shard there), then the cut's group (the
    model group; under ep the expert group), each replicated leaf counted
    once (``_model_once``)."""
    def sums(vec: torch.Tensor, names) -> torch.Tensor:
        if fsdp and mesh.data_size > 1:
            all_reduce_sum_([vec], mesh.data_group())
        once = _model_once(tp, names, vec.device)
        if once is not None:
            vec = vec * once
            all_reduce_sum_([vec], tp.group)
        return vec

    return sums


class GspmdHealth(StepHealth):
    """The flight recorder of the GSPMD step: the DP schema from each
    leaf's squares and non-finite flags summed over the ranks that split it
    (``sums``, ``leaf_sums``'s), the loss the data group's global one."""

    def __init__(self, config: HealthConfig, sums: Callable):
        super().__init__(config)
        self.sums = sums

    @torch.no_grad()
    def finish(self, loss: torch.Tensor, grads: Tree, updates: Tree) -> dict:
        names = list(grads)
        gs = [grads[n] for n in names]
        us = [updates[n].contiguous() for n in names]
        g, u, p = leaf_norms(gs), leaf_norms(us), self._param_norms
        bad = lambda xs, norms: (~torch.isfinite(leaf_peaks(xs)) | torch.isnan(norms)).float()  # noqa: E731
        vec = self.sums(torch.stack([g * g, u * u, p * p, bad(gs, g), bad(us, u)]), names)
        pl = None
        if self.config.per_layer:
            pl = {"grad_norm": dict(zip(names, torch.sqrt(vec[0]).unbind())),
                  "param_norm": dict(zip(names, torch.sqrt(vec[2]).unbind()))}
        stats = assemble_stats(loss=loss, grad_sq=vec[0].sum(), grad_bad=(vec[3] > 0).sum(),
                               param_sq=vec[2].sum(), update_sq=vec[1].sum(),
                               update_bad=(vec[4] > 0).sum(), per_layer=pl)
        if self.guard is not None:
            self.guard.select(stats["all_finite"])
        return stats


def _global_loss(loss_fn: Callable, logits: torch.Tensor, batch, group,
                 compute_accuracy: bool, sown=None, aux_weight: float = 0.0):
    """This rank's part of the masked mean loss over the global batch: its
    masked sum over the count summed over the data group ``group`` (one
    all-reduce, outside autograd), as ``loss_fn`` times its own count over
    the global one; with the model's ``sown`` auxiliary losses, their mean
    over the global batch is the mean of the data group's, so this rank's
    part adds ``aux_weight * aux / D`` (``combine_aux_loss``). Returns the
    objective and the metric sums (the task loss's part, and the aux's)."""
    mask = batch.get("mask")
    local = loss_fn(logits, batch["label"], mask)
    with torch.no_grad():
        count = (mask.to(torch.float32).sum() if mask is not None else
                 torch.full((), float(logits.shape[0]), device=logits.device))
        total = count.clone()
        if group_size(group) > 1:
            all_reduce_sum_([total], group)
        scale = torch.clamp_min(count, 1.0) / torch.clamp_min(total, 1.0)
    loss = local * scale
    objective = loss
    _, aux = combine_aux_loss(loss, sown or {}, aux_weight)
    if aux is not None:             # this rank's part of the global batch's mean
        aux = rank_mean(aux, group_size(group))
        objective = loss + aux_weight * aux
    with torch.no_grad():
        sums = _metric_sums(loss.detach(), logits, batch, compute_accuracy, aux)
    return objective, sums


def _microbatches(batch, count: int, mesh: Mesh) -> list:
    """This rank's rows of each of the ``count`` microbatches of the global
    batch (module docstring): the data group's batches all-gathered, global
    microbatch k's rows cut over the data group, this rank's piece."""
    if count == 1:
        return [batch]
    D, d = mesh.data_size, mesh.data_index
    rows = batch["image"].shape[0]
    if D > 1:
        whole = {}
        for key, v in batch.items():
            flat = v.to(torch.float32) if v.dtype == torch.bool else v
            got = all_gather_bytes(flat.contiguous().view(-1), mesh.data_group())
            whole[key] = got.view(D * rows, *v.shape[1:]).to(v.dtype)
        batch = whole
    m = rows // count                      # this rank's rows of a microbatch
    return [{key: v[k * m * D + d * m:k * m * D + (d + 1) * m] for key, v in batch.items()}
            for k in range(count)]


def make_sharded_train_step(tx, mesh: Mesh, layout: StateLayout, *,
                            loss_fn: Callable = cross_entropy_loss,
                            compute_accuracy: bool = True, remat: bool = False,
                            grad_accum_steps: int = 1,
                            health: Optional[HealthConfig] = None,
                            aux_weight: float = 0.01) -> Callable:
    """``step(state, batch) -> (state, {"loss", "accuracy"})`` (``health``
    too under ``health``, ``aux_loss`` for a model with auxiliary losses,
    weighed by ``aux_weight``) for a state laid out by ``layout_state``;
    ``batch`` holds this rank's data shard's rows (the same on every rank
    of its model group). ``state`` is updated in place. Module docstring
    for the arithmetic."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    data, zero = mesh.data_group(), layout.zero
    sums_fn = leaf_sums(layout.tp, mesh, zero is not None)
    recorder = GspmdHealth(health, sums_fn) if health is not None else None
    A = grad_accum_steps

    def train_step(state: TrainState, batch):
        rows = batch["image"].shape[0]
        if rows % A:
            raise ValueError(f"per-shard batch {rows} not divisible by grad_accum_steps {A}")
        model = state.model
        model.train()
        params = state.params()
        leaves = list(params.values())
        if recorder is not None:
            recorder.before_forward(model)
        acc = total = None
        with streamed(zero, state):
            for micro in _microbatches(batch, A, mesh):
                logits = _forward(model, micro["image"], remat)
                loss, sums = _global_loss(loss_fn, logits, micro, data, compute_accuracy,
                                          sown_aux_losses(model), aux_weight)
                grads = torch.autograd.grad(loss, leaves)
                if acc is None:
                    acc, total = list(grads), sums
                else:
                    with torch.no_grad():
                        torch._foreach_add_(acc, grads)
                        total = total + sums
        with torch.no_grad():
            grads = dict(zip(params, acc if A == 1 else [g / A for g in acc]))
            sums = total if A == 1 else torch.cat([total[:1] / A, total[1:3], total[3:] / A])
            if group_size(data) > 1:
                all_reduce_sum_([sums], data)
        held = state.param_shards if zero is not None else params
        stats = None
        if recorder is not None:
            recorder.before_update(state, held, zero)

        def record(grads_seen, updates, _err=None):
            nonlocal stats
            stats = recorder.finish(sums[0], grads_seen, updates)

        if zero is not None:
            zero.sharded_update(grads, held, state.opt_state,
                                before_gather=record if recorder is not None else None)
        else:
            with torch.no_grad():
                if group_size(data) > 1:
                    all_reduce_sum_(list(grads.values()), data)
            updates = tx.apply(grads, state.opt_state, params, leaf_sums=sums_fn)
            if recorder is not None:
                record(grads, updates)
        state.step += 1
        with torch.no_grad():
            return state, _step_metrics(sums, 1, compute_accuracy, stats)

    return train_step


def make_tp_train_step(state: TrainState, tx, mesh: Mesh, *, rules=VIT_TP_RULES,
                       **kwargs) -> Tuple[Callable, TrainState, StateLayout]:
    """Tensor-parallel (DP x TP on ``data`` x ``model``) step for the
    replicated ``state``, which is laid out in place (``rules=CNN_TP_RULES``
    for the conv families). Returns ``(step, state, layout)``; ``kwargs``
    as ``make_sharded_train_step``'s."""
    state, layout = layout_state(state, tx, mesh, rules=rules)
    return make_sharded_train_step(tx, mesh, layout, **kwargs), state, layout


def make_fsdp_tp_train_step(state: TrainState, tx, mesh: Mesh, *, rules=VIT_TP_RULES,
                            **kwargs) -> Tuple[Callable, TrainState, StateLayout]:
    """2-D FSDP x TP: the tensor-parallel leaves, each scattered over the
    data group (module docstring). As ``make_tp_train_step``."""
    state, layout = layout_state(state, tx, mesh, rules=rules, fsdp=True)
    return make_sharded_train_step(tx, mesh, layout, **kwargs), state, layout


def make_fsdp_train_step(state: TrainState, tx, mesh: Mesh,
                         **kwargs) -> Tuple[Callable, TrainState, StateLayout]:
    """ZeRO-3/FSDP: params and optimizer state scattered over the data
    group, the params streamed block by block. As ``make_tp_train_step``."""
    state, layout = layout_state(state, tx, mesh, fsdp=True)
    return make_sharded_train_step(tx, mesh, layout, **kwargs), state, layout
