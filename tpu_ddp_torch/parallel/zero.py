"""ZeRO-1: the optimizer update sharded over the data-parallel ranks
(``--zero1``), and ZeRO-3: the params scattered too (``--zero3``).

Counterpart of ``tpu_ddp/parallel/zero.py`` (``Zero1Partition`` :114,
``clip_by_global_norm_sharded`` :724). Plain DP averages the full gradients
and has every rank apply the same full update to a full optimizer state.
Under ZeRO-1 each step instead

1. reduce-scatters the gradients: rank r receives the gradient averaged
   over the ranks for its 1/N slice of every leaf only;
2. runs the optimizer on that slice of the params and of the optimizer
   state, which lives sharded for good (1/N of its bytes a rank);
3. all-gathers the updated params, so the next forward sees them whole.

The arithmetic is that of the replicated update, element for element.

Update space: each leaf is flattened and zero-padded to a multiple of N
(``_flat_leaf``, shared with ``parallel/compression.py``); rank r owns
elements ``[r*S, (r+1)*S)`` of every leaf, ``S = padded / N``. The port
moves all leaves at once: the gradients go into one chunk-major buffer
(``collectives.ChunkMajor``: row r holds every leaf's r-th chunk), so the
step makes one reduce-scatter and one all-gather, not one a leaf. This
rank's param shards live in one persistent row of that layout, which the
all-gather sends; K1 (``ops/fused_update.py``) updates them in place and
masks each shard's pad (its ``valid`` column). With a ``GradCompressor``
attached (``set_compression``) the reduce-scatter is its quantized ring,
one ring over all leaves, whose sum lands in the same gradient row.

Freezing (``--freeze``, the optimizer's freeze predicate, keyed by leaf
name as the JAX ``Zero1Partition``'s path-keyed labels are, :28-37): a frozen
leaf has no slot in the sharded trace, mu or nu, whose rows lay out the
trainable leaves alone; its shards go through K1's frozen rows (``u`` zero,
whatever the pad mask says), and the clip's norm sums the trainable shards.
The EMA row keeps every leaf.

The ranks are those of ``group`` (a ``torch.distributed`` process group;
None: the default group), the JAX package's ``data`` axis: the whole world
under data parallelism, ``mesh.data_group()`` on a rank grid
(``parallel/mesh.py``), where the state is then replicated over the other
axes (``--zero1`` under sequence parallelism, ``--parallelism fsdp`` and
``fsdp_tp``); with one rank nothing here calls a collective.
``average=False`` makes the gradients' reduction a SUM (the GSPMD steps of
``parallel/tensor_parallel.py`` divide by the global count in the loss
already), and ``leaf_sums`` (``train/optim.py``) sums each leaf's squares
over every rank that holds a piece of it (there: over the model group too),
for the clip's norm and lamb's trust ratios, which the update then takes
over whole leaves. DP's ``--zero1`` and ``--zero3`` build no such sums and
refuse lamb, as the JAX package does (``make_optimizer``'s ``zero1_axis``).

The flight recorder (``health_stats``, the JAX :297): the shard-local sums
of the gradient and update shards go over the ranks in the step's one
all-reduce, and ``sharded_update``'s ``before_gather`` lets the step's
skip-step guard put the shards back before the all-gather sends them
(``train/steps.py``).

ZeRO-3 (``Zero3Partition``, the JAX :496-721) keeps the params themselves
as 1/N shards between steps, in the same per-leaf padded update space: the
shards are the state (``TrainState.param_shards``), K1 updates them in
place, and nothing is gathered after the update. The forward gathers them
block by block (``param_blocks``: one block a top-level module name), one
all-gather a block on the prefetch schedule (``collectives.BlockGather``).

Where the module's parameters live under ZeRO-3: between steps each
``nn.Parameter`` of the model holds an empty placeholder; the step's
``stream_params`` points each block's parameters at freshly gathered
full-shape tensors (``.data``) when the forward first enters the block (a
forward pre-hook on the block's module; the root's pre-hook for params
that sit on the root, such as the ViT's ``pos_embed``), and puts the
placeholders back after the backward. The alternative, ``functional_call``
over the gathered tree, would need every block's tensor before the forward
starts, so every gather would be in flight (or done) at once and the
prefetch schedule could not bound them to two; with the placeholders the
Parameter objects stay the autograd leaves the step differentiates, the
module code is unchanged, and the gather stays outside autograd, as the
JAX gather stays outside ``value_and_grad`` (``tpu_ddp/train/steps.py``
:231-241): the backward returns full-shape local gradients, which
``reduce_scatter_mean`` consumes, with no second gather. A block entered
twice (NetResDeep's tied ``resblock``, a recompute under ``--remat``) is
gathered once.

Not ported: the mesh's specs and shardings (``state_specs``,
``state_shardings``, ``_jitted``; the port's state is per rank anyway).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from tpu_ddp_torch.health.stats import assemble_stats, leaf_norms, nonfinite_leaves
from tpu_ddp_torch.ops.fused_update import shard_valid
from tpu_ddp_torch.parallel.collectives import (
    BlockGather,
    ChunkMajor,
    all_gather_bytes,
    all_reduce_sum_,
    group_rank,
    group_size,
    rank_mean,
    reduce_scatter_sum,
)
from tpu_ddp_torch.parallel.compression import _flat_leaf, _leaf_slot, _unflat_leaf
from tpu_ddp_torch.train.optim import OptState

DATA_AXIS = "data"

Tree = Dict[str, torch.Tensor]

#: the ``OptState`` fields that stay whole on every rank (int32 step counts)
REPLICATED_SLOTS = ("count", "sched_count")


def sharded_global_norm(shards, group=None) -> torch.Tensor:
    """The global norm of a tree that lives as 1/N shards over the ranks
    (of ``group``; None: all): each shard's float32 sum of squares, summed,
    summed over the ranks, then ``sqrt`` (the JAX
    ``clip_by_global_norm_sharded``'s norm, :735-739). The pad elements are
    zero and add nothing."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32))) for x in shards)
    if group_size(group) > 1:
        all_reduce_sum_([sq], group)
    return torch.sqrt(sq)


def clip_by_global_norm_sharded(updates: Tree, max_norm: float,
                                g_norm: Optional[torch.Tensor] = None) -> Tree:
    """``optax.clip_by_global_norm`` for gradients living as 1/N shards: the
    norm is ``g_norm`` when given, else ``sharded_global_norm`` over all the
    ranks (squared shards summed before the ``sqrt``), so every rank clips
    by the true global norm."""
    if g_norm is None:
        g_norm = sharded_global_norm(updates.values())
    trigger = g_norm < max_norm
    return {n: torch.where(trigger, t, (t / g_norm) * max_norm)
            for n, t in updates.items()}


class Zero1Partition:
    """The static partition of a model's update space over ``n_shards``
    ranks, and this rank's working buffers.

    ``tx`` is the ``Optimizer`` built with ``zero1_axis``;
    ``params_template`` maps leaf names to anything with a ``shape``;
    ``group`` is the ranks' process group (None: the default group) and
    ``rank`` defaults to this process's place in it; ``average`` and
    ``leaf_sums`` as in the module docstring. The
    decay mask is ``tx.decay_mask``, which both the plain chain and K1
    read; when ``tx`` has none (legal at weight decay 0), it is set here
    to ``ndim >= 2`` of the template's original shapes. A compressor is
    attached with ``set_compression``."""

    #: whether the params live as this rank's shards between steps (ZeRO-3)
    scattered_params = False
    #: this rank's persistent rows (``_buffers``)
    _ROWS = ("grad", "param")

    def __init__(self, tx, params_template, n_shards: int,
                 rank: Optional[int] = None, group=None, *, average: bool = True,
                 leaf_sums: Optional[Callable] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.tx = tx
        self.n_shards = n_shards
        self.group = group
        self.rank = group_rank(group) if rank is None else rank
        #: the gradients' reduction: the mean over the ranks, or (False) the sum
        self.average = average
        #: the per-leaf sums over the ranks (module docstring); None: the
        #: clip's norm is ``sharded_global_norm`` over ``group``
        self.leaf_sums = leaf_sums
        self.param_slots = {name: _leaf_slot(leaf, n_shards)
                            for name, leaf in params_template.items()}
        self.names = list(self.param_slots)
        self.layout = ChunkMajor([s.size for s in self.param_slots.values()],
                                 n_shards)
        if tx.decay_mask is None:
            tx.decay_mask = {n: len(s.shape) >= 2
                             for n, s in self.param_slots.items()}
        self.compress = None
        self._bufs: Optional[dict] = None
        self._seen: tuple = ()
        self._layouts = {tuple(self.names): self.layout}

    def set_compression(self, compress) -> None:
        """Attach a ``GradCompressor``: the gradients' reduce-scatter then
        runs its quantized ring (wire bytes ~4x fewer in int8) while the
        shard update stays f32. It must have been built over the same
        leaves, in the same order, and rank count (the same padding), so
        that its shard row is this partition's gradient row."""
        if (compress.n_shards != self.n_shards
                or list(compress.slots) != self.names
                or any(compress.slots[n].padded != s.padded
                       for n, s in self.param_slots.items())):
            raise ValueError(
                f"GradCompressor layout (n_shards={compress.n_shards}) does "
                f"not match this partition (n_shards={self.n_shards})")
        self.compress = compress

    # ---- the flat update space ------------------------------------------

    def shard_size(self, name: str) -> int:
        return self.param_slots[name].padded // self.n_shards

    def flatten(self, tree: Tree) -> Tree:
        """Original-shaped leaves -> per-leaf ``(padded,)``."""
        return {n: _flat_leaf(x, self.param_slots[n]) for n, x in tree.items()}

    def unflatten(self, flat_tree: Tree) -> Tree:
        """Per-leaf ``(padded,)`` -> original shapes (unpad + reshape)."""
        return {n: _unflat_leaf(x, self.param_slots[n]) for n, x in flat_tree.items()}

    def local_shard(self, flat_tree: Tree) -> Tree:
        """This rank's slice of each ``(padded,)`` leaf."""
        out = {}
        for n, x in flat_tree.items():
            s = self.shard_size(n)
            out[n] = x[self.rank * s:(self.rank + 1) * s]
        return out

    def valid(self) -> List[int]:
        """Each leaf's live elements in this rank's shard, in leaf order
        (K1's ``valid`` column): those before the leaf's pad."""
        return [shard_valid(slot.size, self.rank * self.shard_size(n),
                            self.shard_size(n))
                for n, slot in self.param_slots.items()]

    def mask_pad(self, shard_tree: Tree) -> Tree:
        """Zero the pad of each shard (the JAX ``mask_pad``)."""
        out = {}
        for n, x in shard_tree.items():
            slot, s = self.param_slots[n], self.shard_size(n)
            if slot.padded == slot.size:
                out[n] = x
                continue
            gidx = self.rank * s + torch.arange(s, device=x.device)
            out[n] = torch.where(gidx < slot.size, x, torch.zeros_like(x))
        return out

    # ---- the step's collectives and buffers -----------------------------

    def _buffers(self, device) -> dict:
        """This rank's persistent buffers, zero where nothing writes (pads,
        gaps): the averaged gradient shards and the param shards, one row
        of the layout each, with their per-leaf views; the chunk-major
        gradients (``send``) are added by the uncompressed reduce-scatter."""
        if self._bufs is None:
            self._bufs = {}
            for key in self._ROWS:
                self._bufs[key], self._bufs[key + "_views"] = self._new_row(device)
        return self._bufs

    def _layout_for(self, names) -> ChunkMajor:
        """The chunk-major layout of the leaves ``names`` (in leaf order):
        ``layout`` for all of them, else one of their own (the trainable
        leaves' slots under a freeze)."""
        key = tuple(names)
        if key not in self._layouts:
            self._layouts[key] = ChunkMajor(
                [self.param_slots[n].size for n in key], self.n_shards)
        return self._layouts[key]

    def _new_row(self, device, names=None) -> tuple:
        """A fresh zero row of the layout of ``names`` (default: every
        leaf) and its per-leaf views."""
        names = self.names if names is None else list(names)
        layout = self._layout_for(names)
        row = torch.zeros(layout.width, dtype=torch.float32, device=device)
        return row, dict(zip(names, layout.views(row)))

    @torch.no_grad()
    def _slice_into(self, views: Tree, tree: Tree) -> None:
        """Copy this rank's slice of each original-shaped leaf of ``tree``
        into ``views``; the pad is not written (it stays zero)."""
        for n, view in views.items():
            x, s = tree[n].reshape(-1), self.shard_size(n)
            live = shard_valid(x.numel(), self.rank * s, s)
            view[:live].copy_(x[self.rank * s:self.rank * s + live])

    def reduce_scatter_mean(self, grads: Tree, residual: Optional[Tree] = None,
                            with_error: bool = False):
        """Local full-shaped grads -> ``(shards, err_state)``: this rank's
        slice of the gradient AVERAGED over the ranks, the sum and then a
        true division by the rank count as ``all_reduce_mean_`` does (the
        sum alone when ``average`` is False). With a compressor attached,
        its quantized ring instead, with ``residual``/``with_error`` for
        error feedback; ``err_state`` is None otherwise."""
        device = next(iter(grads.values())).device
        bufs = self._buffers(device)
        if self.compress is not None:
            _, err_state = self.compress.reduce_scatter_mean_flat(
                self.compress.flatten(grads), residual, with_error=with_error,
                out=bufs["grad"])
            return dict(bufs["grad_views"]), err_state
        if "send" not in bufs:
            bufs["send"] = torch.zeros(self.n_shards, self.layout.width,
                                       dtype=torch.float32, device=device)
        send = bufs["send"]
        self.layout.pack_(send, [grads[n] for n in self.names])
        total = (reduce_scatter_sum(send.view(-1), self.group) if self.n_shards > 1
                 else send[0])
        if self.average:
            n = torch.full((), self.n_shards, dtype=total.dtype, device=total.device)
            torch.div(total, n, out=bufs["grad"])
        else:
            bufs["grad"].copy_(total)
        return dict(bufs["grad_views"]), None

    def param_shards(self, params: Tree) -> Tree:
        """This rank's param shards: persistent views of one buffer that
        the all-gather sends and K1 updates in place, so the same tensors
        come back every step. They are sliced anew from ``params`` only
        when a param was written since the last all-gather (its version
        counter moved: a load, say)."""
        bufs = self._buffers(next(iter(params.values())).device)
        seen = tuple(params[n]._version for n in self.names)
        if seen != self._seen:
            self._slice_into(bufs["param_views"], params)
            self._seen = seen
        return bufs["param_views"]

    def _gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(width,)`` row, ``(n, width)``."""
        return all_gather_bytes(row, self.group) if self.n_shards > 1 else row.view(1, -1)

    @torch.no_grad()
    def gather_params_(self, params: Tree) -> None:
        """The step's all-gather: every rank's param shards into the full
        ``params``, in place."""
        rows = self._gather_rows(self._bufs["param"])
        self.layout.unpack_(rows, [params[n] for n in self.names])
        self._seen = tuple(params[n]._version for n in self.names)

    @torch.no_grad()
    def gather_params(self, shard_tree: Tree) -> Tree:
        """Per-rank shards -> the full original-shaped tree on every rank
        (one all-gather; a collective, every rank calls it). It is also the
        JAX ``deshard_params``: a rank holds only its own shards, so
        de-sharding is a gather here. ``shard_tree`` may hold a subset of
        the leaves (a slot of the trainable ones)."""
        names = [n for n in self.names if n in shard_tree]
        if not names:
            return {}
        device = shard_tree[names[0]].device
        row, views = self._new_row(device, names)
        for n, view in views.items():
            view.copy_(shard_tree[n])
        rows = self._gather_rows(row)
        out = {n: torch.empty(self.param_slots[n].shape, dtype=torch.float32,
                              device=device) for n in names}
        self._layout_for(names).unpack_(rows, [out[n] for n in names])
        return out

    def sharded_update(self, grads: Tree, params: Tree, opt_state: OptState,
                       residual: Optional[Tree] = None, with_error: bool = False,
                       before_gather: Optional[Callable] = None):
        """The ZeRO-1 update tail of a step: ``grads`` are this rank's
        local (unsynced) full-shaped gradients, ``params`` the replicated
        params, ``opt_state`` this rank's shard of the state. Reduce-scatter,
        the update of the shards (K1 when ``tx`` has it, else the plain
        chain, the pad mask and ``p + u``), then one all-gather into
        ``params``; ``params`` and ``opt_state`` change in place.
        ``before_gather(grad_shards, update_shards, err_state)`` runs
        between the update and the all-gather. Returns ``(grad_shards,
        update_shards, err_state)``."""
        gsh, err_state = self.reduce_scatter_mean(grads, residual, with_error)
        psh = self.param_shards(params)
        updates = self._update_shards(gsh, psh, opt_state)
        if before_gather is not None:
            before_gather(gsh, updates, err_state)
        self.gather_params_(params)
        return gsh, updates, err_state

    def _update_shards(self, gsh: Tree, psh: Tree, opt_state: OptState) -> Tree:
        """The update of this rank's shards ``psh`` in place by the averaged
        gradient shards ``gsh``: K1 when ``tx`` has it, else the plain chain,
        the pad mask and ``p + u``. Returns the masked updates."""
        fused = self.tx.fused
        g_norm = None
        if self.tx.recipe.grad_clip_norm > 0:          # over the trainable shards
            frozen = self.tx.frozen_mask(psh)
            tr = {n: g for n, g in gsh.items() if not frozen[n]}
            if self.leaf_sums is not None and tr:
                g_norm = self.tx.clip_norm(tr, self.leaf_sums)
            elif tr or fused is not None:
                g_norm = (sharded_global_norm(tr.values(), self.group) if tr else
                          torch.zeros((), device=next(iter(gsh.values())).device))
        if fused is not None:
            updates = fused.apply_sharded(gsh, opt_state, psh, self, g_norm)
        else:
            updates = self.mask_pad(self.tx.update(gsh, opt_state, psh, g_norm=g_norm,
                                                   leaf_sums=self.leaf_sums))
            with torch.no_grad():
                for n, u in updates.items():
                    psh[n].copy_(psh[n] + u)
        return updates

    def health_stats(self, *, sums: torch.Tensor, grad_shards: Tree,
                     param_norms: torch.Tensor, update_shards: Tree,
                     per_layer: bool = False,
                     compress_error_sq: Optional[torch.Tensor] = None) -> dict:
        """The flight recorder's schema (``health/stats.py``) from this
        rank's gradient and update shards (the JAX ``health_stats``, :297):
        their shard-local sums of squares and non-finite counts (and each
        leaf's gradient sum of squares under ``per_layer``), this rank's
        ``compress_error_sq`` and the step's metric ``sums`` (its loss
        first) are summed over the ranks in ONE all-reduce, ``sums`` in
        place; the loss is ``sums[0]`` over the rank count. ``param_norms``
        are the old replicated params' per-leaf norms (``leaf_norms``, in
        leaf order), which need no reduction; under ZeRO-3
        (``scattered_params``) the old param SHARDS' norms, whose squares
        travel in the same all-reduce (the JAX Zero3 ``health_stats``,
        :594). The update shards are pad-masked, as ``sharded_update``
        returns them."""
        gs = [grad_shards[n] for n in self.names]
        us = [update_shards[n] for n in self.names]
        g, u = leaf_norms(gs), leaf_norms(us)
        g_sq = g * g
        local = [torch.sum(g_sq), nonfinite_leaves(gs, g),
                 torch.sum(u * u), nonfinite_leaves(us, u)]
        if compress_error_sq is not None:
            local.append(compress_error_sq)
        p_sq = param_norms * param_norms
        if self.scattered_params:
            local.append(torch.sum(p_sq))
        vec = torch.stack(local)
        k = len(local)
        if per_layer:
            vec = torch.cat([vec, g_sq] + ([p_sq] if self.scattered_params else []))
        if self.n_shards > 1:
            all_reduce_sum_([sums, vec], self.group)
        param_sq = vec[k - 1] if self.scattered_params else torch.sum(p_sq)
        pl = None
        if per_layer:
            L = len(self.names)
            p_norms = (torch.sqrt(vec[k + L:]) if self.scattered_params else param_norms)
            pl = {"grad_norm": dict(zip(self.names, torch.sqrt(vec[k:k + L]).unbind())),
                  "param_norm": dict(zip(self.names, p_norms.unbind()))}
        return assemble_stats(
            loss=rank_mean(sums[0], self.n_shards), grad_sq=vec[0], grad_bad=vec[1],
            param_sq=param_sq, update_sq=vec[2],
            update_bad=vec[3], per_layer=pl,
            compress_error_sq=vec[4] if compress_error_sq is not None else None)

    # ---- the optimizer state in shard space -----------------------------

    def _sharded_slots(self) -> List[str]:
        r = self.tx.recipe
        slots = (["mu", "nu"] if r.optimizer in ("adamw", "lamb") else
                 ["trace"] if r.momentum > 0 else [])
        return slots + (["ema"] if r.ema_decay else [])

    def _slot_names(self, slot: str) -> List[str]:
        """The leaves a slot holds: all for the EMA, the trainable ones
        for the moments."""
        if slot == "ema":
            return self.names
        frozen = self.tx.frozen_mask(self.param_slots)
        return [n for n in self.names if not frozen[n]]

    def init_opt_state(self, params: Tree) -> OptState:
        """Fresh optimizer state built directly in shard space (the full
        replicated state is never made): zero moments, the EMA shadow from
        this rank's slice of ``params``, one row a slot (of the slot's
        leaves: ``_slot_names``)."""
        r = self.tx.recipe
        device = next(iter(params.values())).device
        state = OptState()
        for slot in self._sharded_slots():
            _, views = self._new_row(device, self._slot_names(slot))
            if slot == "ema":
                self._slice_into(views, params)
            setattr(state, slot, views)
        count = lambda: torch.zeros((), dtype=torch.int32, device=device)  # noqa: E731
        if r.optimizer in ("adamw", "lamb"):
            state.count = count()
        if callable(r.lr):
            state.sched_count = count()
        return state

    def shard_opt_state(self, opt_state: OptState) -> OptState:
        """Original-layout state (a replicated run's, or one carried from
        the JAX package by ``checkpoint/convert.py::from_jax``) -> this
        rank's shard layout. No collective."""
        state = OptState()
        device = next((t.device for slot in self._sharded_slots()
                       for t in getattr(opt_state, slot).values()), None)
        for slot in self._sharded_slots():
            full = getattr(opt_state, slot)
            _, views = self._new_row(device, self._slot_names(slot))
            self._slice_into(views, full)
            setattr(state, slot, views)
        for slot in REPLICATED_SLOTS:
            value = getattr(opt_state, slot)
            setattr(state, slot, None if value is None else value.clone())
        return state

    def deshard_opt_state(self, opt_state: OptState) -> OptState:
        """Sharded state -> the original layout a replicated run holds
        (unpad + reshape after one all-gather a slot; a collective)."""
        state = OptState()
        for slot in self._sharded_slots():
            setattr(state, slot, self.gather_params(getattr(opt_state, slot)))
        for slot in REPLICATED_SLOTS:
            value = getattr(opt_state, slot)
            setattr(state, slot, None if value is None else value.clone())
        return state

    def deshard_state(self, state):
        """``TrainState`` -> the same state with its optimizer state in the
        layout a replicated run holds and checkpoints (a collective; the
        params are whole on every rank already)."""
        return dataclasses.replace(state, opt_state=self.deshard_opt_state(state.opt_state))

    def shard_state(self, state):
        """Original-layout ``TrainState`` (a restored checkpoint's) -> this
        rank's training layout (no collective)."""
        return dataclasses.replace(state, opt_state=self.shard_opt_state(state.opt_state))

    # ---- accounting -----------------------------------------------------

    def accounting(self) -> dict:
        """Optimizer-state bytes a rank, replicated against sharded,
        from the layout alone (the JAX ``accounting``'s keys and numbers;
        the port's alignment gaps between leaves are not counted)."""
        r = self.tx.recipe
        repl = shard = pad = 0
        for name in self._sharded_slots():
            for n in self._slot_names(name):
                slot = self.param_slots[n]
                repl += slot.size * 4
                shard += self.shard_size(n) * 4
                pad += (slot.padded - slot.size) * 4
        scalars = int(r.optimizer in ("adamw", "lamb")) + int(callable(r.lr))
        repl += 4 * scalars
        shard += 4 * scalars
        return {
            "n_shards": self.n_shards,
            "optimizer_state_bytes_replicated": int(repl),
            "optimizer_state_bytes_per_device_sharded": int(shard),
            "padding_overhead_bytes_total": int(pad),
            "sharding_factor": round(repl / shard, 2) if shard else None,
        }


# ---- ZeRO-3 -------------------------------------------------------------------


def param_blocks(params_template) -> tuple:
    """The prefetch blocks: the leaves of ``params_template`` (names ->
    leaves) grouped by their top-level module name (the part before the
    first dot; a param on the root is a block of its own), in the order of
    the names' first appearance. Returns ``(block_names, blocks)``, where
    ``blocks[k]`` lists the leaf indices of block k (the JAX
    ``param_blocks``, :467, whose names these are; JAX orders the blocks by
    ``tree_flatten``, which sorts the names, where ``named_parameters``
    order is the forward's order of first use for the port's models: the
    root's own params, then the children as the forward calls them)."""
    names: list = []
    blocks: list = []
    index: dict = {}
    for i, name in enumerate(params_template):
        top = name.split(".", 1)[0]
        k = index.get(top)
        if k is None:
            k = index[top] = len(blocks)
            names.append(top)
            blocks.append([])
        blocks[k].append(i)
    return names, blocks


class Zero3Partition(Zero1Partition):
    """ZeRO-3 parameter streaming (the JAX ``Zero3Partition``, :496-721;
    module docstring): the params live between steps as this rank's 1/N
    shards in ZeRO-1's per-leaf padded update space, and the forward
    gathers them block by block.

    What changes from ``Zero1Partition``: this rank's param shards sit in
    one row (``shard_params``) that holds each block's ``ChunkMajor`` row
    one after another, so a block's all-gather sends one contiguous slice;
    ``stream_params`` gathers them for a forward and backward;
    ``sharded_update`` takes the shards themselves and gathers nothing
    after the update; ``health_stats`` sums the param norms over the ranks
    too. The gradients' reduce-scatter, the pad mask (``valid()``), K1 and
    the compressed ring are ZeRO-1's. ``prefetch=False`` (the JAX injection
    argument) serializes the gathers. Checkpoints keep the one de-sharded
    layout: ``deshard_params`` and ``deshard_state`` for the params and
    the optimizer state (``train/state.py::full_model_state``)."""

    scattered_params = True
    #: no param row of ZeRO-1's layout: the shards' row is ``shard_params``'s
    _ROWS = ("grad",)

    def __init__(self, tx, params_template, n_shards: int,
                 rank: Optional[int] = None, prefetch: bool = True, group=None,
                 **kwargs):
        super().__init__(tx, params_template, n_shards, rank, group, **kwargs)
        self.prefetch = prefetch
        self.block_names, self.blocks = param_blocks(params_template)
        self.block_layouts = [
            ChunkMajor([self.param_slots[self.names[i]].size for i in blk], n_shards)
            for blk in self.blocks]
        starts, width = [], 0
        for lay in self.block_layouts:
            starts.append(width)
            width += lay.width
        self.block_starts, self.row_width = starts, width
        self._row: Optional[torch.Tensor] = None

    # ---- the scattered params -------------------------------------------

    @torch.no_grad()
    def shard_params(self, params: Tree) -> Tree:
        """Original-shaped ``params`` -> this rank's shards: per-leaf views
        of a new row (the pads zero), the training layout (the JAX
        ``shard_params``). The partition keeps the row: it is what
        ``stream_params`` gathers, so one partition serves one state."""
        device = next(iter(params.values())).device
        self._row = torch.zeros(self.row_width, dtype=torch.float32, device=device)
        views = {}
        for blk, lay, start in zip(self.blocks, self.block_layouts, self.block_starts):
            row = self._row[start:start + lay.width]
            views.update(zip((self.names[i] for i in blk), lay.views(row)))
        shards = {n: views[n] for n in self.names}
        self._slice_into(shards, params)
        return shards

    @torch.no_grad()
    def shard_model_(self, model: torch.nn.Module) -> Tree:
        """``shard_params`` of ``model``'s params, whose storage is then
        released: each ``nn.Parameter`` keeps an empty placeholder, so the
        full init copy is transient (the JAX trainer's :1171-1234)."""
        params = dict(model.named_parameters())
        shards = self.shard_params(params)
        for p in params.values():
            p.data = placeholder(p)
        return shards

    @torch.no_grad()
    def load_params_(self, shards: Tree, params: Tree) -> None:
        """Write this rank's slice of the original-shaped ``params`` (a
        restored checkpoint's, a fine-tune's merge) into ``shards``, in
        place; the pads stay zero. No collective."""
        self._slice_into(shards, params)

    def deshard_params(self, shards: Tree) -> Tree:
        """This rank's shards -> the whole original-shaped params on every
        rank (one all-gather; a collective)."""
        return self.gather_params(shards)

    def stream_params(self, model: torch.nn.Module, shards: Tree,
                      prefetch: Optional[bool] = None) -> "ParamStream":
        """A context in which ``model``'s params are gathered from ``shards``
        (``shard_params``'s) block by block as the forward first enters
        each block, on the prefetch schedule (``prefetch``, default the
        partition's); see ``ParamStream``."""
        if shards[self.names[0]].untyped_storage().data_ptr() != \
                self._row.untyped_storage().data_ptr():
            raise ValueError("stream_params: the shards are not this partition's "
                             "(shard_params made them for another state)")
        return ParamStream(self, model, self.prefetch if prefetch is None else prefetch)

    # ---- the step's update ----------------------------------------------

    def reduce_scatter_mean(self, grads: Tree, residual: Optional[Tree] = None,
                            with_error: bool = False):
        """ZeRO-1's reduce-scatter; its full-size chunk-major send buffer
        is not kept between steps (ZeRO-3 keeps nothing full-size)."""
        out = super().reduce_scatter_mean(grads, residual, with_error)
        self._bufs.pop("send", None)
        return out

    def sharded_update(self, grads: Tree, shards: Tree, opt_state: OptState,
                       residual: Optional[Tree] = None, with_error: bool = False,
                       before_gather: Optional[Callable] = None):
        """The ZeRO-3 update tail (the JAX :572): ``grads`` are this rank's
        local full-shaped gradients from the backward, ``shards`` this
        rank's param shards, the state itself. Reduce-scatter, then the
        update of the shards in place (K1 or the plain chain, ZeRO-1's),
        and nothing gathered after it. ``before_gather(grad_shards,
        update_shards, err_state)`` runs after the update, where ZeRO-1's
        would (the health record and the skip guard). Returns
        ``(grad_shards, update_shards, err_state)``."""
        gsh, err_state = self.reduce_scatter_mean(grads, residual, with_error)
        updates = self._update_shards(gsh, shards, opt_state)
        if before_gather is not None:
            before_gather(gsh, updates, err_state)
        return gsh, updates, err_state

    # ---- accounting -----------------------------------------------------

    def accounting(self) -> dict:
        """ZeRO-1's optimizer-state table and the params' (the JAX
        ``accounting``, :685, keys and numbers): replicated against 1/N
        param bytes a rank, the pad, and the prefetch high-water, the
        largest gathered bytes of two adjacent blocks. ``block_names`` are
        listed in the JAX order (sorted); the high-water follows the port's
        block order (``param_blocks``), so it alone may differ from JAX's."""
        acct = super().accounting()
        repl = shard = pad = 0
        block_bytes = []
        for blk in self.blocks:
            b = 0
            for i in blk:
                slot = self.param_slots[self.names[i]]
                repl += slot.size * 4
                shard += slot.padded // self.n_shards * 4
                pad += (slot.padded - slot.size) * 4
                b += slot.padded * 4
            block_bytes.append(b)
        high = (max(a + b for a, b in zip(block_bytes, block_bytes[1:]))
                if len(block_bytes) > 1 else sum(block_bytes))
        acct.update({
            "params_bytes_replicated": int(repl),
            "params_bytes_per_device_sharded": int(shard),
            "params_padding_overhead_bytes_total": int(pad),
            "n_blocks": len(self.blocks),
            "block_names": sorted(self.block_names),
            "prefetch_buffer_bytes": int(high),
        })
        return acct


def placeholder(p: torch.Tensor) -> torch.Tensor:
    """The empty tensor a scattered param holds between steps."""
    return torch.empty(0, dtype=p.dtype, device=p.device)


class ParamStream:
    """``Zero3Partition.stream_params``'s context: on entry block 0's gather
    is issued (``collectives.BlockGather``); a forward pre-hook on each
    block's module (the root's for params on the root) waits for the block
    when the forward first enters it, which issues the next block's gather
    first, and points the block's parameters at full-shape views of one
    buffer unpacked from the gathered rows (``ChunkMajor.leaves``). On
    exit it waits for every block not entered yet, the hooks go and the
    parameters get their placeholders
    back, so the gathered tensors live from a block's first use to the end
    of the backward. The hooks do nothing for a block already gathered: a
    tied block entered again, a recompute under remat."""

    def __init__(self, part: Zero3Partition, model: torch.nn.Module, prefetch: bool):
        self.part, self.model = part, model
        named = dict(model.named_parameters())
        self.params = [[named[part.names[i]] for i in blk] for blk in part.blocks]
        self.shapes = [[part.param_slots[part.names[i]].shape for i in blk]
                       for blk in part.blocks]
        self.gather = BlockGather(part._row, part.block_starts,
                                  [lay.width for lay in part.block_layouts],
                                  part.n_shards, prefetch, part.group)
        self._handles: list = []

    def __enter__(self) -> "ParamStream":
        children = dict(self.model.named_children())
        on_root = []
        for k, name in enumerate(self.part.block_names):
            if name in children:
                self._handles.append(children[name].register_forward_pre_hook(
                    lambda module, args, k=k: self.use(k)))
            else:
                on_root.append(k)
        if on_root:
            last = max(on_root)
            self._handles.append(self.model.register_forward_pre_hook(
                lambda module, args: self.use(last)))
        self.gather.start()
        return self

    @torch.no_grad()
    def use(self, k: int) -> None:
        """Block k is about to be used: wait for it (and any block before
        it not waited for) and point its parameters at the gathered
        values."""
        for j, rows in self.gather.wait(k):
            leaves = self.part.block_layouts[j].leaves(rows)
            for p, shape, t in zip(self.params[j], self.shapes[j], leaves):
                p.data = t.view(shape)

    def __exit__(self, exc_type, exc, tb) -> None:
        for handle in self._handles:
            handle.remove()
        self._handles.clear()
        if exc_type is None and self.part.blocks:   # a block never entered too
            self.use(len(self.part.blocks) - 1)
        with torch.no_grad():
            for ps in self.params:
                for p in ps:
                    p.data = placeholder(p)
