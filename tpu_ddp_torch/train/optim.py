"""Optimizer factory: the optax chains of the JAX package, in torch.

Counterpart of ``tpu_ddp/train/optim.py`` (``params_ema`` :28,
``_decay_mask`` :75, ``make_optimizer`` :85, and ``apply_optimizer`` :226,
which is ``Optimizer.apply`` here) for the parts this slice runs: SGD with
or without momentum (optax ``trace``), coupled weight decay under the
``ndim >= 2`` mask, global-norm clipping, AdamW and LAMB with decoupled
masked decay, constant and warmup-cosine schedules, and the EMA of the params.

``Optimizer.apply`` runs the plain chain: stage by stage over all leaves, in
the optax chain's order, with the same arithmetic. With ``kernels=True`` it
sends the update through K1 instead (``ops/fused_update.py``). Both update
the params and the optimizer state in place. ``Optimizer.update`` is the
plain chain alone (optax's ``tx.update``: the state in place, the params
left as they are).

``lamb`` is optax's ``lamb`` (the JAX ``make_optimizer`` :169-175):
``scale_by_adam`` with eps 1e-6, the masked ``add_decayed_weights``,
``scale_by_trust_ratio`` (each leaf's update scaled by ``||p|| / ||u||``,
taken as 1 where either norm is 0), then the learning rate; the clip,
freeze masks and EMA wrap it as they wrap AdamW. Where the leaves are cut
over ranks (tensor parallelism's leaves, FSDP's shards), ``leaf_sums``
gives each leaf's whole norms: the clip's and the trust ratio's squares are
summed over the ranks that hold a leaf's pieces before the ``sqrt``, so
every rank scales its piece by the whole leaf's ratio, as GSPMD does. K1 has no lamb branch in
either package: the JAX package quietly drops its fused update for lamb
(:120-132), the port refuses ``kernels=True`` with lamb instead.

``zero1_axis`` builds the optimizer for ZeRO-1's sharded update space
(``parallel/zero.py``; the port's one axis is the data axis of the default
process group): the chain runs on this rank's 1/N shards, so the clip's
norm is summed over the ranks (``clip_by_global_norm_sharded``) and the
decay mask must be given, computed from the original shapes
(``decay_mask=``), because ``ndim`` means nothing on flat shards.

``freeze_predicate`` (``freeze_all_but`` builds one) freezes leaves by
name, with the semantics of the JAX package's
``optax.multi_transform({"trainable": tx, "frozen": set_to_zero()})``
(:195-206): a frozen leaf has no trace, mu or nu slot; the clip's global
norm runs over the trainable gradients only; a frozen leaf's update is
``+0.0`` and its param becomes ``p + 0.0``; the EMA, outermost, still runs
over every leaf, frozen ones with ``u = 0``; the step counts (AdamW's and the
schedule's) live with the trainable leaves and move every step. Frozen
leaves still get gradients, which the step computes and syncs as for any
other leaf.

"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from tpu_ddp_torch.ops.fused_update import (
    B1,
    B2,
    EPS,
    FusedUpdate,
    UpdateRecipe,
    global_norm,
)

Params = Dict[str, torch.Tensor]
#: ``leaf_sums(vec, names) -> vec``: ``vec`` (k, L) holds per-leaf values of
#: this rank's pieces (column i is leaf ``names[i]``); the result their sums
#: over the ranks that hold each leaf's pieces, each whole leaf counted once
LeafSums = Callable[[torch.Tensor, list], torch.Tensor]

#: optax ``lamb``'s eps (AdamW's is ``EPS``, 1e-8)
LAMB_EPS = 1e-6


@dataclasses.dataclass
class OptState:
    """Optimizer state, one tensor per param name where a slot exists.
    ``count`` is AdamW's step count, ``sched_count`` the schedule's (both
    int32 device scalars, as optax keeps them)."""

    count: Optional[torch.Tensor] = None
    sched_count: Optional[torch.Tensor] = None
    trace: Optional[Params] = None
    mu: Optional[Params] = None
    nu: Optional[Params] = None
    ema: Optional[Params] = None


def freeze_all_but(prefixes: Tuple[str, ...]) -> Callable:
    """``predicate(name, leaf) -> True`` to freeze every param whose
    top-level module name (the first dotted component of its name) starts
    with none of ``prefixes``: ``freeze_all_but(("head",))`` trains only the
    head (the JAX ``freeze_all_but``, :240)."""

    def predicate(name: str, leaf) -> bool:
        del leaf
        top = name.split(".", 1)[0]
        return not any(top.startswith(p) for p in prefixes)

    return predicate


def decay_mask(params: Params) -> Dict[str, bool]:
    """Kernels only (``ndim >= 2``): no decay on BatchNorm scales/offsets
    and biases."""
    return {name: p.ndim >= 2 for name, p in params.items()}


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int) -> Callable:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup, decay_steps)``
    with ``end_value=0`` and ``exponent=1``, as float32 torch ops on the
    count's device: a linear warmup joined to a cosine decay."""
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"cosine schedule needs decay steps > warmup "
                         f"({decay_steps} <= {warmup_steps})")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        if warmup_steps > 0:
            c = torch.clamp(count, 0, warmup_steps)
            frac = 1 - c.to(torch.float32) / warmup_steps
            warm = (init_value - peak_value) * frac + peak_value
        else:
            warm = torch.full((), float(init_value), device=count.device)
        cc = torch.clamp_max((count - warmup_steps).to(torch.float32),
                             float(cos_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * cc / float(cos_steps)))
        decayed = peak_value * ((1 - 0.0) * cosine + 0.0)
        return torch.where(count < warmup_steps, warm, decayed)

    return schedule


class Optimizer:
    """``init(params) -> OptState`` and ``apply(grads, state, params) ->
    updates`` (params and state updated in place). ``fused`` is the
    ``FusedUpdate`` that runs K1, when built with ``kernels=True``.
    ``decay_mask`` (None: ``ndim >= 2`` of the params given) names the
    leaves weight decay applies to; ``zero1_axis`` and ``freeze_predicate``
    (module docstring)."""

    def __init__(self, recipe: UpdateRecipe, kernels: bool = False,
                 decay_mask: Optional[Dict[str, bool]] = None,
                 zero1_axis: Optional[str] = None,
                 freeze_predicate: Optional[Callable] = None):
        self.recipe = recipe
        self.fused = FusedUpdate(recipe) if kernels else None
        self.decay_mask = decay_mask
        self.zero1_axis = zero1_axis
        self.freeze_predicate = freeze_predicate
        self._frozen: Tuple[tuple, Dict[str, bool]] = ((), {})

    def wd_mask(self, params: Params) -> Dict[str, bool]:
        return self.decay_mask if self.decay_mask is not None else decay_mask(params)

    def frozen_mask(self, params: Params) -> Dict[str, bool]:
        """``{name: frozen}`` over ``params``'s names (all False without a
        freeze predicate), kept while the same names come back."""
        names = tuple(params)
        if names != self._frozen[0]:
            pred = self.freeze_predicate
            self._frozen = (names, {n: bool(pred and pred(n, params[n]))
                                    for n in names})
        return self._frozen[1]

    def init(self, params: Params) -> OptState:
        r = self.recipe
        dev = next(iter(params.values())).device
        frozen = self.frozen_mask(params)
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()  # noqa: E731
                         if not frozen[n]}
        count = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        state = OptState()
        if r.optimizer in ("adamw", "lamb"):
            state.count, state.mu, state.nu = count(), zeros(), zeros()
        elif r.momentum > 0:
            state.trace = zeros()
        if callable(r.lr):
            state.sched_count = count()
        if r.ema_decay:
            state.ema = {n: p.detach().clone() for n, p in params.items()}
        return state

    def clip_norm(self, grads: Params, leaf_sums: LeafSums) -> Optional[torch.Tensor]:
        """The clip's global norm of the trainable ``grads``, whose leaves
        are cut over ranks as ``leaf_sums`` sums them; None with the clip
        off or no trainable leaf."""
        frozen = self.frozen_mask(grads)
        names = [n for n in grads if not frozen[n]]
        if self.recipe.grad_clip_norm <= 0 or not names:
            return None
        sq = torch.stack([torch.sum(torch.square(grads[n].to(torch.float32))) for n in names])
        return torch.sqrt(torch.sum(leaf_sums(sq[None], names)))

    @torch.no_grad()
    def apply(self, grads: Params, state: OptState, params: Params,
              g_norm: Optional[torch.Tensor] = None,
              leaf_sums: Optional[LeafSums] = None) -> Params:
        """``update`` and ``p + u`` (or K1), in place; ``g_norm`` and
        ``leaf_sums`` as in ``update``."""
        mask = self.wd_mask(params)
        if self.fused is not None:
            if g_norm is None and leaf_sums is not None:
                g_norm = self.clip_norm(grads, leaf_sums)
            return self.fused.apply(grads, state, params, mask,
                                    self.frozen_mask(params), g_norm=g_norm)
        u = self.update(grads, state, params, g_norm=g_norm, leaf_sums=leaf_sums)
        for n, x in u.items():                      # apply_updates
            params[n].copy_(params[n] + x)
        return u

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params,
               g_norm: Optional[torch.Tensor] = None,
               leaf_sums: Optional[LeafSums] = None) -> Params:
        """The plain chain, one stage at a time over all leaves, in the
        order ``make_optimizer`` chains the optax transforms: returns the
        updates and moves ``state`` in place; ``params`` are read only. The
        chain runs on the trainable leaves; frozen ones get zeros
        (``set_to_zero``) before the EMA. ``g_norm``: the clip's global
        norm of the trainable gradients where the caller forms it (leaves
        that live sharded over ranks: ZeRO's, tensor parallelism's);
        ``leaf_sums`` where the leaves are cut over ranks (module docstring):
        the clip's norm, when no ``g_norm`` is given, and lamb's trust
        ratios are then the whole leaves'."""
        r = self.recipe
        wd = r.weight_decay
        mask = self.wd_mask(params)
        frozen = self.frozen_mask(grads)
        u = {n: g for n, g in grads.items() if not frozen[n]}
        if r.grad_clip_norm > 0 and u:
            if g_norm is None and leaf_sums is not None:
                g_norm = self.clip_norm(grads, leaf_sums)
            if self.zero1_axis is not None or g_norm is not None:
                from tpu_ddp_torch.parallel.zero import clip_by_global_norm_sharded

                u = clip_by_global_norm_sharded(u, r.grad_clip_norm, g_norm)
            else:                                   # clip_by_global_norm
                g_norm = global_norm(u.values())
                u = {n: torch.where(g_norm < r.grad_clip_norm, g,
                                    (g / g_norm) * r.grad_clip_norm)
                     for n, g in u.items()}
        if r.optimizer in ("adamw", "lamb"):        # scale_by_adam
            eps = EPS if r.optimizer == "adamw" else LAMB_EPS
            mu = {n: (1 - B1) * g + B1 * state.mu[n] for n, g in u.items()}
            nu = {n: (1 - B2) * (g * g) + B2 * state.nu[n] for n, g in u.items()}
            count_inc = state.count + 1
            bc1 = 1 - B1 ** count_inc.to(torch.float32)
            bc2 = 1 - B2 ** count_inc.to(torch.float32)
            u = {n: (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2 + 0.0) + eps)
                 for n in u}
            if wd > 0:                              # add_decayed_weights
                u = {n: x + wd * params[n] if mask[n] else x
                     for n, x in u.items()}
            if r.optimizer == "lamb":               # scale_by_trust_ratio
                u = scale_by_trust_ratio(params, u, leaf_sums)
            for n in u:
                state.mu[n].copy_(mu[n])
                state.nu[n].copy_(nu[n])
            state.count.copy_(count_inc)
        else:
            if wd > 0:                              # masked add_decayed_weights
                u = {n: x + wd * params[n] if mask[n] else x
                     for n, x in u.items()}
            if r.momentum > 0:                      # trace
                u = {n: x + r.momentum * state.trace[n] for n, x in u.items()}
                for n, x in u.items():
                    state.trace[n].copy_(x)
        if callable(r.lr):                          # scale_by_schedule
            step = -1 * r.lr(state.sched_count)
            u = {n: step * x for n, x in u.items()}
            state.sched_count += 1
        else:                                       # scale(-lr)
            u = {n: (-1 * r.lr) * x for n, x in u.items()}
        u = {n: u[n] if n in u else torch.zeros_like(g)    # set_to_zero
             for n, g in grads.items()}
        if r.ema_decay:                             # params_ema
            d = r.ema_decay
            for n, x in u.items():
                state.ema[n].copy_(d * state.ema[n] + (1.0 - d) * (params[n] + x))
        return u


def _ratio(p_norm: torch.Tensor, u_norm: torch.Tensor) -> torch.Tensor:
    zero = (p_norm == 0.0) | (u_norm == 0.0)
    return torch.where(zero, torch.ones_like(p_norm), p_norm / (u_norm + 0.0))


def trust_ratio(param: torch.Tensor, update: torch.Tensor) -> torch.Tensor:
    """optax ``scale_by_trust_ratio``'s factor (no min norm, trust
    coefficient 1, eps 0): ``||param|| / ||update||``, and 1 where either
    norm is 0."""
    return _ratio(torch.sqrt(torch.sum(param * param)),
                  torch.sqrt(torch.sum(update * update)))


def scale_by_trust_ratio(params: Params, updates: Params,
                         leaf_sums: Optional[LeafSums] = None) -> Params:
    """Each leaf of ``updates`` times its ``trust_ratio``; under
    ``leaf_sums`` (leaves cut over ranks) the param's and the update's
    squares summed over the ranks that hold the leaf's pieces first, so the
    ratio is the whole leaf's (module docstring)."""
    if leaf_sums is None:
        return {n: x * trust_ratio(params[n], x) for n, x in updates.items()}
    names = list(updates)
    sq = torch.stack([torch.stack([torch.sum(params[n] * params[n]), torch.sum(x * x)])
                      for n, x in updates.items()], 1)
    p_norm, u_norm = torch.sqrt(leaf_sums(sq, names))
    ratio = _ratio(p_norm, u_norm)
    return {n: x * ratio[i] for i, (n, x) in enumerate(updates.items())}


def make_optimizer(
    lr: float = 1e-2,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    schedule: Optional[str] = None,
    total_steps: Optional[int] = None,
    warmup_steps: int = 0,
    grad_clip_norm: float = 0.0,
    freeze_predicate: Optional[Callable] = None,
    optimizer: str = "sgd",
    ema_decay: float = 0.0,
    decay_mask: Optional[Dict[str, bool]] = None,
    zero1_axis: Optional[str] = None,
    kernels: bool = False,
) -> Optimizer:
    """The JAX ``make_optimizer``'s signature and semantics for this slice.
    ``kernels=True`` sends every update through K1; ``decay_mask``,
    ``zero1_axis`` and ``freeze_predicate(name, leaf) -> True to freeze`` as
    in the module docstring."""
    if grad_clip_norm < 0:
        raise ValueError(f"grad_clip_norm must be >= 0, got {grad_clip_norm}")
    if zero1_axis is not None and optimizer == "lamb":
        raise ValueError(
            "--zero1 does not compose with --optimizer lamb: the "
            "layer-wise trust ratio needs whole-parameter norms, which "
            "the 1/N update shards cannot provide")
    if zero1_axis is not None and weight_decay > 0 and decay_mask is None:
        raise ValueError(
            "zero1_axis with weight_decay needs a precomputed decay_mask "
            "(the ndim>=2 heuristic cannot see original shapes on "
            "flattened update-space leaves)")
    if optimizer not in ("sgd", "adamw", "lamb"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if optimizer in ("adamw", "lamb") and momentum > 0:
        raise ValueError(f"--momentum is an SGD knob; {optimizer} has its own "
                         "moment estimates (b1=0.9)")
    if kernels and optimizer == "lamb":
        raise ValueError(
            "--kernels with --optimizer lamb: K1 (ops/csrc/fused_update.cu) has "
            "no lamb branch (nor has the JAX package's fused update); drop "
            "--kernels or use sgd or adamw")
    if ema_decay and not 0.0 < ema_decay < 1.0:
        raise ValueError(f"ema decay must be in (0, 1), got {ema_decay}")
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine schedule needs total_steps")
        lr_sched = warmup_cosine_decay_schedule(0.0, lr, warmup_steps, total_steps)
    elif schedule in (None, "constant"):
        lr_sched = lr
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    recipe = UpdateRecipe(
        optimizer=optimizer, lr=lr_sched, momentum=momentum,
        weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
        ema_decay=ema_decay,
    )
    return Optimizer(recipe, kernels=kernels, decay_mask=decay_mask,
                     zero1_axis=zero1_axis, freeze_predicate=freeze_predicate)
