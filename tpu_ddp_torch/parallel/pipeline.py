"""Pipeline parallelism over the ``pipeline`` axis: GPipe and 1F1B for the
ViT family (``--parallelism pp``, ``--microbatches``, ``--pp-schedule``).

Counterpart of ``tpu_ddp/parallel/pipeline.py`` (``to_pipeline_params``
:56, ``from_pipeline_params`` :67, ``_vit_pieces`` :75, ``_pp_health_stats``
:116, ``pp_schedule_stats`` :161, ``make_pp_train_step`` :196,
``make_pp_1f1b_train_step`` :425, ``create_pp_train_state`` :663). The JAX
step is one ``lax.scan`` over ticks with a ``ppermute`` a tick, whose bubble
ticks compute masked-out values; here each stage is a rank of its pipeline
group (``parallel/mesh.py``; stage s is the rank at pipeline index s, as in
the JAX mesh), the ticks are a Python loop, activations and cotangents move
between neighbours with one non-blocking ``batch_isend_irecv`` a tick
(``collectives.post``), and a bubble tick computes nothing. Results are the
same. The JAX ``create_pp_train_state`` (:663) is ``create_train_state``
and then ``layout_pipeline``: the optimizer state built on the whole
params and filtered to the stage's, the same zeros.

**The layout** (``PipelineLayout``). Stage s of S holds blocks
``[s * d / S, (s + 1) * d / S)`` of the ViT's d, under their own names
(``block_<i>.…``), and the replicated ``patch_embed``, ``pos_embed``,
``ln_f`` and ``head``; the other blocks are taken out of its module, so
its params, the optimizer state and K1 see only what the stage holds. The
JAX state stacks the blocks into one ``blocks`` tree (``to_pipeline_params``,
used to carry a JAX pp state across); the checkpoint keeps the one plain
layout, which ``gather`` (one all-gather over the pipeline of every block
leaf) and ``scatter`` (a filter by name) map to and from. Evaluation and
``predict`` run the plain module on the gathered params, once a pass (the
JAX ``prepare_eval``).

**The pieces** (``_vit_pieces``): ``embed`` (patch conv, ``pos_embed``),
``apply_stage`` (the stage's blocks in turn), ``apply_head`` (``ln_f``, the
token mean, ``head``, float32).

**GPipe** (``make_pp_train_step``). Tick t of ``M + S - 1``: stage s runs
micro ``t - s`` forward (stage 0 embeds it; the others take it from stage
``s - 1``), keeping its graph; the last stage then applies the head to all
``M`` outputs at once and takes the loss over the local batch. The backward
runs the ticks in reverse: each stage differentiates its micro's output
with the cotangent from stage ``s + 1`` (the last: from the loss) and
sends the input's cotangent down. ``M`` micro graphs live at once.

**1F1B** (``make_pp_1f1b_train_step``). Cycle c of ``M + 2(S - 1)``: stage s
runs the forward of micro ``c - s`` without a graph, storing only its input
in one of ``min(M, 2S - 1)`` slots, and the backward of micro
``c - 2(S - 1) + s``, which recomputes the stage forward from the stored
input under autograd (the last stage first takes the head and the micro's
loss, ``loss_fn(micro) * count_micro / count_local``, on the output of this
cycle's forward: there ``b == f``); stage 0 closes the chain through the
embed. Each cycle posts the activation up and the cotangent down as one
pair. K4 runs twice a block and micro (forward and recompute), K5 and K6
once.

**Reduction**, the same under both schedules (the JAX :614-628, with
``GRAD_SYNC_IN_AD``): the replicated leaves' gradients, non-zero on one
stage only, are summed over the pipeline and then averaged over the data
group; the blocks' averaged over the data group only. The loss is the local
masked mean averaged over the data group; the logits reach every stage
(summed over the pipeline, zeros off the last stage) for the accuracy.

**The optimizer** runs on each stage's leaves, as the JAX step runs ``tx``
on each stage's local tree (:330, :629), with two consequences the port
keeps: weight decay's ``ndim >= 2`` mask sees the stacked blocks, so every
block leaf is decayed (``pipeline_decay_mask``); lamb's trust ratios are
each stacked leaf's over the stage's blocks (``stage_leaf_sums``). The
clip is refused (``check_clip``): the JAX step takes its norm over the
stage's own leaves, and its replication check refuses the replicated
leaves that then differ between stages.

**Health** (``PipelineHealth``, the JAX ``_pp_health_stats``): the blocks'
squares and non-finite counts summed over the pipeline, the replicated
leaves' counted once; every stage reports the same numbers, per-layer
entries for the blocks under ``blocks.<leaf>``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from tpu_ddp_torch.health.stats import (
    HealthConfig,
    assemble_stats,
    leaf_norms,
    leaf_peaks,
)
from tpu_ddp_torch.parallel.collectives import (
    all_gather_bytes,
    all_reduce_mean_,
    all_reduce_sum_,
    group_size,
    post,
    rank_mean,
)
from tpu_ddp_torch.parallel.mesh import Mesh
from tpu_ddp_torch.train.losses import cross_entropy_loss
from tpu_ddp_torch.train.state import TrainState, map_opt_slots
from tpu_ddp_torch.train.steps import StepHealth, _metric_sums, _step_metrics

Tree = Dict[str, torch.Tensor]
_BLOCK = re.compile(r"^block_(\d+)\.(.*)$")
#: the tags of the two directions a tick moves tensors in
_UP, _DOWN = 0, 1


def _block(name: str):
    """``(i, rest)`` of a ``block_<i>.rest`` name, else None."""
    m = _BLOCK.match(name)
    return (int(m.group(1)), m.group(2)) if m else None


def to_pipeline_params(params: Tree, depth: int) -> Tree:
    """Plain ViT params (flat, the port's names) -> the pipeline layout of
    the JAX package: ``block_<i>.<leaf>`` stacked into ``blocks.<leaf>``
    with a leading depth axis, everything else as it is."""
    out = {n: t for n, t in params.items() if _block(n) is None}
    leaves = [b[1] for b in map(_block, params) if b is not None and b[0] == 0]
    for rest in leaves:
        out[f"blocks.{rest}"] = torch.stack([params[f"block_{i}.{rest}"]
                                             for i in range(depth)])
    return out


def from_pipeline_params(pp_params: Tree, depth: int) -> Tree:
    """``to_pipeline_params``' inverse."""
    out = {n: t for n, t in pp_params.items() if not n.startswith("blocks.")}
    for n, t in pp_params.items():
        if n.startswith("blocks."):
            for i in range(depth):
                out[f"block_{i}.{n[len('blocks.'):]}"] = t[i]
    return out


def pp_schedule_stats(n_stages: int, n_microbatches: int, schedule: str) -> dict:
    """The schedule's bubble fraction and in-flight microbatch bound (the
    JAX :161-193, unchanged): gpipe ``(S-1)/(M+S-1)`` and M; 1f1b
    ``2(S-1)/(M+2(S-1))`` and ``min(M, 2S-1)``, with the recompute."""
    s, m = n_stages, n_microbatches
    if schedule == "gpipe":
        return {
            "schedule": "gpipe",
            "bubble_fraction": round((s - 1) / (m + s - 1), 4),
            "in_flight_microbatches": m,
            "recompute": False,
        }
    if schedule == "1f1b":
        return {
            "schedule": "1f1b",
            "bubble_fraction": round(2 * (s - 1) / (m + 2 * (s - 1)), 4),
            "in_flight_microbatches": min(m, 2 * s - 1),
            "recompute": True,
        }
    raise ValueError(f"unknown pp schedule {schedule!r}")


def check_clip(tx) -> None:
    """The clip under pp raises (module docstring)."""
    if tx.recipe.grad_clip_norm > 0:
        raise ValueError(
            "--grad-clip-norm is not supported with --parallelism pp: the JAX "
            "pp step takes the clip's norm over each stage's own leaves, so the "
            "replicated embed and head would update differently on each stage, "
            "which its replication check refuses")


def pipeline_decay_mask(params: Tree) -> Dict[str, bool]:
    """The decay mask of the JAX pp step's optimizer: ``ndim >= 2`` of the
    stacked tree, true for every block leaf."""
    return {n: _block(n) is not None or p.ndim >= 2 for n, p in params.items()}


def _stacked(names) -> Dict[str, List[int]]:
    """``{leaf: [i, ...]}``: the positions in ``names`` of each block leaf
    (``block_<i>.<leaf>``), the JAX stacked ``blocks.<leaf>``'s pieces."""
    groups: Dict[str, List[int]] = {}
    for i, n in enumerate(names):
        b = _block(n)
        if b is not None:
            groups.setdefault(b[1], []).append(i)
    return groups


def stage_leaf_sums(vec: torch.Tensor, names) -> torch.Tensor:
    """``train/optim.py``'s ``LeafSums`` of a stage: each block leaf's value
    summed over the stage's blocks of the same leaf (the JAX stacked
    leaf's), the replicated leaves' as they are."""
    out = vec.clone()
    for cols in _stacked(names).values():
        idx = torch.tensor(cols, device=vec.device)
        out[..., idx] = vec.index_select(-1, idx).sum(-1, keepdim=True)
    return out


class PipelineLayout:
    """Stage ``index`` of ``size`` of ``model`` (a ViT) over ``group`` (the
    pipeline group), in the ``train/state.py::StateLayout`` place of a model
    cut (module docstring). Built from the whole model; ``stage_model_``
    takes the other stages' blocks out of it."""

    def __init__(self, model: nn.Module, size: int, index: int, group):
        self.depth = len(model.blocks)
        if self.depth % size:
            raise ValueError(f"depth {self.depth} not divisible by {size} stages")
        self.size, self.index, self.group = size, index, group
        self.per_stage = self.depth // size
        self.first = index * self.per_stage

    def local(self, i: int) -> bool:
        return self.first <= i < self.first + self.per_stage

    def stage_model_(self, model: nn.Module) -> None:
        """Keep this stage's blocks in ``model``, in place."""
        for i in range(self.depth):
            if not self.local(i):
                delattr(model, f"block_{i}")
        model.blocks = model.blocks[self.first:self.first + self.per_stage]

    def scatter(self, tree: Tree) -> Tree:
        """Whole leaves -> this stage's (no collective)."""
        return {n: t for n, t in tree.items()
                if _block(n) is None or self.local(_block(n)[0])}

    @torch.no_grad()
    def gather(self, tree: Tree) -> Tree:
        """This stage's leaves -> every stage's, whole on every rank (one
        all-gather over the pipeline of this stage's block leaves in one
        buffer; a collective). The stages hold the same leaves block for
        block, so stage s's j-th block is block ``s * d / S + j``."""
        names = [n for n in tree if _block(n) is not None]
        if self.size == 1 or not names:
            return dict(tree)
        flat = torch.cat([tree[n].reshape(-1).to(torch.float32) for n in names])
        rows = all_gather_bytes(flat, self.group)
        blocks = {}
        for s in range(self.size):
            offset = 0
            for n in names:
                i, rest = _block(n)
                t = tree[n]
                piece = rows[s, offset:offset + t.numel()].view(t.shape).to(t.dtype)
                blocks[f"block_{i - self.first + s * self.per_stage}.{rest}"] = piece
                offset += t.numel()
        out = {}
        for n, t in tree.items():
            if _block(n) is None:
                out[n] = t
            elif n == names[0]:
                out.update(sorted(blocks.items(), key=lambda kv: _block(kv[0])[0]))
        return out

    def opt_state(self, opt_state, fn):
        """``opt_state`` with every param-shaped slot mapped by ``fn``
        (``scatter`` or ``gather``); the counts as they are."""
        return map_opt_slots(opt_state, fn)

    def eval_params(self, state: TrainState, ema: bool) -> Tree:
        """The whole params evaluation reads (the EMA shadow's under
        ``ema``), gathered over the pipeline (a collective)."""
        return self.gather(state.opt_state.ema if ema else state.params())


def _vit_pieces(model: nn.Module):
    """``(embed, apply_stage, apply_head)`` of a stage's module (the JAX
    ``_vit_pieces``; the same as ``ViT.forward``'s parts)."""
    from tpu_ddp_torch.models.vit import run_blocks

    def embed(images: torch.Tensor) -> torch.Tensor:        # (mb, H, W, C) -> (mb, T, C)
        x = model.patch_embed(images.permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(images.shape[0], -1, model.hidden_dim)
        return x + model.pos_embed.to(x.dtype)

    def apply_stage(x: torch.Tensor) -> torch.Tensor:
        return run_blocks(model.blocks, x, False)

    def apply_head(x: torch.Tensor) -> torch.Tensor:        # (mb, T, C) -> (mb, classes)
        return model.head(model.ln_f(x).mean(dim=1)).float()

    return embed, apply_stage, apply_head


class PipelineHealth(StepHealth):
    """The flight recorder of the pp step (module docstring), with the DP
    schema; its skip-step guard as every other family's."""

    def __init__(self, config: HealthConfig, group):
        super().__init__(config)
        self.group = group

    @torch.no_grad()
    def finish(self, loss: torch.Tensor, grads: Tree, updates: Tree) -> dict:
        names = list(grads)
        gs = [grads[n] for n in names]
        us = [updates[n].contiguous() for n in names]
        g, u, p = leaf_norms(gs), leaf_norms(us), self._param_norms
        bad = lambda xs, norms: (~torch.isfinite(leaf_peaks(xs)) | torch.isnan(norms)).float()  # noqa: E731
        vec = torch.stack([g * g, u * u, p * p, bad(gs, g), bad(us, u)])
        # each stacked leaf's columns summed over the stage, then the pipeline
        stacked = _stacked(names)
        per_leaf = torch.stack([vec[:, cols].sum(1) for cols in stacked.values()], 1)
        if group_size(self.group) > 1:
            all_reduce_sum_([per_leaf], self.group)
        rest = [i for i, n in enumerate(names) if _block(n) is None]
        rest_cols = vec[:, rest]
        pl = None
        if self.config.per_layer:
            pl = {}
            for key, row in (("grad_norm", 0), ("param_norm", 2)):
                norms = dict(zip((names[i] for i in rest), torch.sqrt(rest_cols[row]).unbind()))
                norms.update(zip((f"blocks.{leaf}" for leaf in stacked),
                                 torch.sqrt(per_leaf[row]).unbind()))
                pl[key] = norms
        total = rest_cols.sum(1) + per_leaf.sum(1)
        stats = assemble_stats(loss=loss, grad_sq=total[0], grad_bad=total[3],
                               param_sq=total[2], update_sq=total[1],
                               update_bad=total[4], per_layer=pl)
        if self.guard is not None:
            self.guard.select(stats["all_finite"])
        return stats


def _local_rows(batch, n_micro: int):
    rows = batch["image"].shape[0]
    if rows % n_micro:
        raise ValueError(
            f"per-shard batch {rows} not divisible into {n_micro} microbatches")
    return rows // n_micro


def make_pp_train_step(model: nn.Module, tx, mesh: Mesh, *, n_microbatches: int,
                       schedule: str = "gpipe", loss_fn: Callable = cross_entropy_loss,
                       compute_accuracy: bool = True,
                       health: Optional[HealthConfig] = None) -> Callable:
    """``step(state, batch) -> (state, {"loss", "accuracy"})`` (``health``
    too under ``health``) of a stage's state (``PipelineLayout``) under
    ``schedule`` ("gpipe" or "1f1b"); ``batch`` holds this rank's data
    shard's rows, the same on every stage. ``state`` is updated in place.
    Module docstring for the schedules and the arithmetic."""
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp schedule {schedule!r}")
    S, s, M = mesh.pipeline_size, mesh.pipeline_index, n_microbatches
    pipe, data = mesh.pipeline_group(), mesh.data_group()
    embed, apply_stage, apply_head = _vit_pieces(model)
    recorder = PipelineHealth(health, pipe) if health is not None else None
    last = s == S - 1

    def exchange(sends, recvs):
        """One tick's hops: ``sends`` ``(tensor, stage, tag)``, ``recvs``
        ``(like, stage, tag)``; None when there are none."""
        return post(sends, recvs, pipe) if sends or recvs else None

    def accumulate(acc, names, grads):
        for n, g in zip(names, grads):
            if g is not None:
                acc[n] = g if acc.get(n) is None else acc[n] + g

    def gpipe(params, batch, mb):
        names, leaves = list(params), list(params.values())
        images = batch["image"]
        like = torch.empty((mb, *_tokens(model, images), model.hidden_dim),
                           dtype=model.dtype, device=images.device)
        xs: List[Optional[torch.Tensor]] = [None] * M
        outs: List[Optional[torch.Tensor]] = [None] * M
        hop = None
        for t in range(M + S - 1):
            got = hop.wait() if hop is not None else []
            f = t - s
            if 0 <= f < M:
                if s == 0:
                    x = embed(images[f * mb:(f + 1) * mb])
                else:
                    x = got[0].requires_grad_()
                xs[f], outs[f] = x, apply_stage(x)
            nf = f + 1
            hop = exchange(
                [(outs[f].detach(), s + 1, _UP)] if not last and 0 <= f < M else [],
                [(like, s - 1, _UP)] if s > 0 and 0 <= nf < M else [])
        if hop is not None:
            hop.wait()
        acc: Tree = {}
        logits = loss = cots = None
        if last:
            hs = [o.detach().requires_grad_() for o in outs]
            logits = apply_head(torch.cat(hs))
            loss = loss_fn(logits, batch["label"], batch.get("mask"))
            got = torch.autograd.grad(loss, leaves + hs, allow_unused=True)
            accumulate(acc, names, got[:len(names)])
            cots = got[len(names):]
        hop = None
        for t in reversed(range(M + S - 1)):
            got = hop.wait() if hop is not None else []
            f = t - s
            dx = None
            if 0 <= f < M:
                cot = cots[f] if last else got[0]
                inputs = leaves + ([xs[f]] if s > 0 else [])
                grads = torch.autograd.grad(outs[f], inputs, cot, allow_unused=True)
                accumulate(acc, names, grads[:len(names)])
                dx = grads[-1] if s > 0 else None
                xs[f] = outs[f] = None
            nb = f - 1
            hop = exchange([(dx, s - 1, _DOWN)] if dx is not None else [],
                           [(like, s + 1, _DOWN)] if not last and 0 <= nb < M else [])
        if hop is not None:
            hop.wait()
        return acc, logits, loss

    def one_f_one_b(params, batch, mb):
        names, leaves = list(params), list(params.values())
        images, labels, mask = batch["image"], batch["label"], batch.get("mask")
        if mask is None:
            mask = torch.ones(images.shape[0], dtype=torch.bool, device=images.device)
        total = torch.clamp_min(mask.to(torch.float32).sum(), 1.0)
        like = torch.empty((mb, *_tokens(model, images), model.hidden_dim),
                           dtype=model.dtype, device=images.device)
        n_slots = min(M, 2 * S - 1)
        slots: List[Optional[torch.Tensor]] = [None] * n_slots
        acc: Tree = {}
        loss_sum = torch.zeros((), dtype=torch.float32, device=images.device)
        logits_buf = [None] * M
        embed_names = [n for n in names if n.startswith(("patch_embed.", "pos_embed"))]
        embed_leaves = [params[n] for n in embed_names]
        hop = None
        for c in range(M + 2 * (S - 1)):
            got = hop.wait() if hop is not None else []
            f, b = c - s, c - 2 * (S - 1) + s
            do_f, do_b = 0 <= f < M, 0 <= b < M
            act_in = got.pop(0) if s > 0 and do_f else None
            cot_in = got.pop(0) if not last and do_b else None
            act_out = d_x = None
            if do_f:                    # forward: micro f, its input stored
                with torch.no_grad():
                    x_in = embed(images[f * mb:(f + 1) * mb]) if s == 0 else act_in
                    slots[f % n_slots] = x_in
                    act_out = apply_stage(x_in)
            if do_b:                    # backward: micro b, recomputed
                rows = slice(b * mb, (b + 1) * mb)
                if last:                # b == f: head and loss on this forward
                    a = act_out.detach().requires_grad_()
                    logits_b = apply_head(a)
                    count = mask[rows].to(torch.float32).sum()
                    contrib = loss_fn(logits_b, labels[rows], mask[rows]) * count / total
                    got_h = torch.autograd.grad(contrib, leaves + [a], allow_unused=True)
                    accumulate(acc, names, got_h[:len(names)])
                    cot_out = got_h[-1]
                    loss_sum = loss_sum + contrib.detach()
                    logits_buf[b] = logits_b.detach()
                else:
                    cot_out = cot_in
                x = slots[b % n_slots].detach().requires_grad_()
                grads = torch.autograd.grad(apply_stage(x), leaves + [x], cot_out,
                                            allow_unused=True)
                accumulate(acc, names, grads[:len(names)])
                d_x = grads[-1]
                if s == 0:              # the chain closes through the embed
                    e = embed(images[rows])
                    accumulate(acc, embed_names,
                               torch.autograd.grad(e, embed_leaves, d_x))
            nf, nb = f + 1, b + 1
            sends, recvs = [], []
            if do_f and not last:
                sends.append((act_out, s + 1, _UP))
            if do_b and s > 0:
                sends.append((d_x, s - 1, _DOWN))
            if s > 0 and 0 <= nf < M:
                recvs.append((like, s - 1, _UP))
            if not last and 0 <= nb < M:
                recvs.append((like, s + 1, _DOWN))
            hop = exchange(sends, recvs)
        if hop is not None:
            hop.wait()
        logits = torch.cat(logits_buf) if last else None
        return acc, logits, loss_sum if last else None

    run = gpipe if schedule == "gpipe" else one_f_one_b

    def train_step(state: TrainState, batch):
        model.train()
        mb = _local_rows(batch, M)
        params = state.params()
        if recorder is not None:
            recorder.before_forward(model)
        acc, logits, loss = run(params, batch, mb)
        with torch.no_grad():
            # contiguous: a conv grad's layout would make the owner stage's
            # reductions (lamb's norms) sum in another order than the others'
            grads = {n: acc[n].contiguous() if acc.get(n) is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            # the loss and the logits from the last stage, on every stage
            rows = batch["image"].shape[0]
            classes = model.head.out_features
            out = torch.zeros(1 + rows * classes, dtype=torch.float32,
                              device=batch["image"].device)
            if last:
                out[0], out[1:] = loss, logits.reshape(-1)
            replicated = [grads[n] for n in grads if _block(n) is None]
            if S > 1:
                all_reduce_sum_([out] + replicated, pipe)
            if group_size(data) > 1:
                all_reduce_mean_(list(grads.values()), data)
            loss, logits = out[0], out[1:].view(rows, classes)
            sums = _metric_sums(loss, logits, batch, compute_accuracy)
            if group_size(data) > 1:
                all_reduce_sum_([sums], data)
        n = group_size(data)
        stats = None
        if recorder is not None:
            recorder.before_update(state, params)
        updates = tx.apply(grads, state.opt_state, params, leaf_sums=stage_leaf_sums)
        if recorder is not None:
            stats = recorder.finish(rank_mean(sums[0], n), grads, updates)
        state.step += 1
        with torch.no_grad():
            return state, _step_metrics(sums, n, compute_accuracy, stats)

    return train_step


def _tokens(model: nn.Module, images: torch.Tensor) -> tuple:
    """``(T,)``: the tokens of ``images`` under ``model``'s patch."""
    p = model.patch_size
    return ((images.shape[1] // p) * (images.shape[2] // p),)


def layout_pipeline(state: TrainState, tx, mesh: Mesh):
    """Lay a replicated ``state`` of a whole ViT out for this rank's stage,
    in place: the other stages' blocks out of the module and of the
    optimizer state, the JAX pp optimizer's decay mask
    (``pipeline_decay_mask``) unless the optimizer has one. Returns the
    ``PipelineLayout``."""
    layout = PipelineLayout(state.model, mesh.pipeline_size, mesh.pipeline_index,
                            mesh.pipeline_group())
    if tx.decay_mask is None:
        tx.decay_mask = pipeline_decay_mask(state.params())
    layout.stage_model_(state.model)
    state.opt_state = layout.opt_state(state.opt_state, layout.scatter)
    tx.decay_mask = layout.scatter(tx.decay_mask)
    return layout
