"""Health stats on the device: the step's half of the numerics flight
recorder.

Counterpart of ``tpu_ddp/health/stats.py`` (``HEALTH_SCALAR_KEYS`` :46,
``HealthConfig`` :60, ``tree_sq``, ``tree_nonfinite``, ``per_layer_sq``,
``assemble_stats`` :119, ``health_stats`` :158, ``tree_select``,
``guard_step`` :198). Trees are dicts of tensors keyed by the port's
parameter names (``conv1.weight``); every stat is a 0-d tensor on the
step's device, and nothing here reads a device value on the host. The step
builders (``train/steps.py``, ``train/lm_steps.py``, ZeRO-1's
``parallel/zero.py``) hand this module the synchronised gradients and the
updates the optimizer applied, so every rank reports the same global
numbers.

Schema (``metrics["health"]``), the JAX package's:

- ``loss``: the step's loss averaged over the ranks (float32);
- ``grad_norm``, ``param_norm``, ``update_norm``: global L2 norms of the
  synchronised gradient, of the params before the update, and of the
  update applied;
- ``update_ratio``: ``update_norm / max(param_norm, 1e-12)``;
- ``loss_finite``, ``grads_finite``, ``updates_finite`` and ``all_finite``
  (the three together: the skip-step gate), bool;
- ``per_layer`` (with ``HealthConfig.per_layer``):
  ``{"grad_norm" | "param_norm": {name: norm}}``;
- ``compress_error_norm`` (under ``--grad-compress``): the L2 norm of the
  quantization error the compressed ring made this step, over the ranks.

Arithmetic. Sums are float32. A tree's per-leaf L2 norms are one
multi-tensor pass (``torch._foreach_norm``: a launch or two for the whole
tree, not several a leaf); its sum of squares is the sum of their squares
(the JAX package sums each leaf's squares: the two agree to float32
rounding), and the per-layer norms are those norms as they are.

Finiteness is an elementwise test, never read off a norm: a leaf is
non-finite when its largest magnitude (a second multi-tensor pass,
``ord=inf``: a max, which cannot overflow) is not finite, or when its L2
norm is NaN (only a NaN element makes it so: squares of finite values
overflow to +inf, never to NaN). So a finite gradient whose norm overflows
to inf reads ``grads_finite`` true. The JAX package counts the non-finite
elements; the port counts the leaves holding one. Both are 0 exactly when
every element is finite, which is all the sentinels read.

The skip-step guard (``SkipGuard``; the JAX ``tree_select`` and
``guard_step``). The JAX step returns new trees and selects between old and
new; the port's step updates in place (K1 writes p, m, v and e; BatchNorm
moves its running buffers in the forward; ZeRO-1 updates its shards and
then gathers them). So the guard copies what the step will overwrite into
buffers of its own, allocated the first time and kept while the same
tensors come back, with multi-tensor copies, and after the update writes
``torch.where(ok, new, old)`` back into each tensor: bitwise the old values
after a non-finite step, bitwise the new ones otherwise, and no host sync
either way. Like ``jnp.where``, these are plain torch ops, outside any
hand-written kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch

#: Keys every step builder's ``metrics["health"]`` carries (``per_layer``
#: too at a per-layer stride, ``compress_error_norm`` under compression).
HEALTH_SCALAR_KEYS = (
    "loss",
    "grad_norm",
    "param_norm",
    "update_norm",
    "update_ratio",
    "loss_finite",
    "grads_finite",
    "updates_finite",
    "all_finite",
)

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """What a step builder computes. ``per_layer`` adds the per-layer norm
    breakdown (the host decides how often to record it). ``skip_nonfinite``
    builds the skip-step guard: a step whose loss, gradient or update is
    not finite leaves the params, the optimizer state (``count`` and
    ``sched_count`` included), the BatchNorm buffers and the error-feedback
    residual as they were; ``state.step`` still advances (the batch was
    consumed)."""

    per_layer: bool = False
    skip_nonfinite: bool = False


def _f32(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [t if t.dtype == torch.float32 else t.float() for t in tensors]


def leaf_norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(L,)`` float32: each leaf's L2 norm, in one multi-tensor pass."""
    return torch.stack(torch._foreach_norm(_f32(tensors)))


def leaf_peaks(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(L,)`` float32: each leaf's largest magnitude (NaN where it holds
    a NaN), in one multi-tensor pass; 0 for an empty leaf."""
    xs = _f32(tensors)
    live = iter(torch._foreach_norm([x for x in xs if x.numel()], math.inf))
    zero = torch.zeros((), dtype=torch.float32, device=xs[0].device)
    return torch.stack([next(live) if x.numel() else zero for x in xs])


def nonfinite_leaves(tensors: Sequence[torch.Tensor],
                     norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0-d float32: how many leaves hold a NaN or an infinity (module
    docstring); ``norms`` are ``leaf_norms(tensors)`` when the caller has
    them."""
    norms = leaf_norms(tensors) if norms is None else norms
    bad = ~torch.isfinite(leaf_peaks(tensors)) | torch.isnan(norms)
    return bad.sum(dtype=torch.float32)


def tree_sq(tree: Tree) -> torch.Tensor:
    """Sum of squares over every leaf (float32)."""
    norms = leaf_norms(list(tree.values()))
    return torch.sum(norms * norms)


def tree_nonfinite(tree: Tree) -> torch.Tensor:
    """The non-finite sentinel's count over a tree (``nonfinite_leaves``)."""
    return nonfinite_leaves(list(tree.values()))


def per_layer_sq(tree: Tree) -> Dict[str, torch.Tensor]:
    """``{name: sum of squares}``, one 0-d view a leaf."""
    norms = leaf_norms(list(tree.values()))
    return dict(zip(tree, (norms * norms).unbind()))


def assemble_stats(*, loss, grad_sq, grad_bad, param_sq, update_sq, update_bad,
                   per_layer: Optional[dict] = None,
                   compress_error_sq=None) -> Dict[str, Any]:
    """The schema dict from reduced scalars (0-d tensors on one device).
    Step builders whose gradients live sharded (ZeRO-1) sum the pieces over
    the ranks first and feed the totals here."""
    loss = loss.to(torch.float32)
    param_norm = torch.sqrt(param_sq)
    update_norm = torch.sqrt(update_sq)
    loss_finite = torch.isfinite(loss)
    grads_finite = grad_bad == 0
    updates_finite = update_bad == 0
    stats: Dict[str, Any] = {
        "loss": loss,
        "grad_norm": torch.sqrt(grad_sq),
        "param_norm": param_norm,
        "update_norm": update_norm,
        "update_ratio": update_norm / torch.clamp_min(param_norm, 1e-12),
        "loss_finite": loss_finite,
        "grads_finite": grads_finite,
        "updates_finite": updates_finite,
        "all_finite": loss_finite & grads_finite & updates_finite,
    }
    if compress_error_sq is not None:
        stats["compress_error_norm"] = torch.sqrt(compress_error_sq.to(torch.float32))
    if per_layer is not None:
        stats["per_layer"] = per_layer
    return stats


def health_stats(*, loss, grads: Tree, updates: Tree, params: Optional[Tree] = None,
                 param_norms: Optional[torch.Tensor] = None, per_layer: bool = False,
                 compress_error_sq=None) -> Dict[str, Any]:
    """The stats of replicated trees: ``grads`` and ``updates`` the
    synchronised values the optimizer consumed and produced, ``params``
    the params before the update (or ``param_norms``, their
    ``leaf_norms`` in ``grads``'s order, taken before an in-place update
    overwrote them), ``loss`` the loss averaged over the ranks. Every rank
    computes the same numbers."""
    g, u = (leaf_norms(list(t.values())) for t in (grads, updates))
    p = leaf_norms([params[n] for n in grads]) if param_norms is None else param_norms
    pl = None
    if per_layer:
        pl = {"grad_norm": dict(zip(grads, g.unbind())),
              "param_norm": dict(zip(grads, p.unbind()))}
    return assemble_stats(
        loss=loss, grad_sq=torch.sum(g * g),
        grad_bad=nonfinite_leaves(list(grads.values()), g),
        param_sq=torch.sum(p * p), update_sq=torch.sum(u * u),
        update_bad=nonfinite_leaves(list(updates.values()), u),
        per_layer=pl, compress_error_sq=compress_error_sq)


class ScalarRead:
    """A step's stats without ``per_layer``, copied to the host in ONE copy
    (the JAX trainer's one ``device_get`` of the scalar subtree a step):
    started at construction (on a card into pinned memory, with an event
    after it, so the host does not wait), read by ``result()`` as Python
    floats and bools."""

    def __init__(self, stats: Dict[str, Any]):
        self.keys = [k for k in stats if k != "per_layer"]
        vec = torch.stack([stats[k].to(torch.float32) for k in self.keys])
        self._event = None
        if vec.is_cuda:
            self._host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
            self._host.copy_(vec, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = vec

    def result(self) -> Dict[str, Any]:
        if self._event is not None:
            self._event.synchronize()
        values = self._host.tolist()
        return {k: (bool(v) if k.endswith("_finite") else v) for k, v in zip(self.keys, values)}


def per_layer_to_host(per_layer: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, dict]:
    """The per-layer norms as Python floats, in one more copy."""
    groups = list(per_layer)
    names = list(per_layer[groups[0]])
    rows = torch.stack([torch.stack([per_layer[g][n] for n in names])
                        for g in groups]).cpu().tolist()
    return {g: dict(zip(names, row)) for g, row in zip(groups, rows)}


class HealthFeed:
    """Feeds a ``health.monitor.HealthMonitor`` each step's stats: the
    scalars in one copy to the host (``ScalarRead``), the per-layer norms
    only on a stride step or when a sentinel tripped, the batch only when
    a dump is written (``batch``: the step's tensors). With ``lag`` a step's
    copy is read only once the next step has been enqueued, so the read does
    not drain the device's queue each step (the ``warn`` and ``skip_step``
    policies: their verdicts change nothing in the loop, and the skip
    itself happened in the step); without it (``halt``) it is read at once,
    so the run stops at the step that tripped. ``flush`` reads what is
    still pending."""

    def __init__(self, monitor, lag: bool):
        self.monitor = monitor
        self.lag = lag
        self._pending: Optional[tuple] = None

    def push(self, step: int, stats: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> str:
        """Start ``step``'s copy; returns the verdict of the step read now
        ("ok" when none is)."""
        read = (step, ScalarRead(stats), stats.get("per_layer"), batch)
        if self.lag:
            read, self._pending = self._pending, read
        return "ok" if read is None else self._consume(*read)

    def flush(self) -> str:
        read, self._pending = self._pending, None
        return "ok" if read is None else self._consume(*read)

    def _consume(self, step, scalars, per_layer, batch) -> str:
        host = scalars.result()
        stride = self.monitor.per_layer_stride
        if per_layer is not None and (not host["all_finite"]
                                      or (stride and step % stride == 0)):
            host["per_layer"] = per_layer_to_host(per_layer)

        def batch_provider():
            return {k: v.cpu().numpy() for k, v in batch.items()}

        return self.monitor.on_step(step, host, batch_provider=batch_provider)


@torch.no_grad()
def tree_select_(ok: torch.Tensor, new: Sequence[torch.Tensor],
                 old: Sequence[torch.Tensor]) -> None:
    """``new[i] = where(ok, new[i], old[i])``, in place, for each pair;
    ``ok`` a 0-d bool tensor on their device."""
    for n, o in zip(new, old):
        torch.where(ok, n, o, out=n)


class SkipGuard:
    """The skip-step guard of a step builder (module docstring):
    ``save(key, tensors)`` before the step moves ``tensors``,
    ``select(ok)`` after it. One object a step builder; its snapshot
    buffers live across steps."""

    def __init__(self):
        self._held: Dict[str, tuple] = {}

    @torch.no_grad()
    def save(self, key: str, tensors: Sequence[torch.Tensor]) -> None:
        """Copy ``tensors`` into this key's snapshot buffers, made anew only
        when other tensors come back under the key; one multi-tensor copy
        a dtype."""
        tensors = list(tensors)
        held = self._held.get(key)
        if held is None or len(held[0]) != len(tensors) or not all(
                a is b for a, b in zip(held[0], tensors)):
            held = (tensors, [torch.empty_like(t) for t in tensors])
            self._held[key] = held
        groups: Dict[tuple, tuple] = {}
        for t, s in zip(*held):
            dst, src = groups.setdefault((t.dtype, t.device), ([], []))
            dst.append(s)
            src.append(t)
        for dst, src in groups.values():
            torch._foreach_copy_(dst, src)

    def select(self, ok: torch.Tensor) -> None:
        """Every saved tensor back to its snapshot unless ``ok``."""
        for tensors, snaps in self._held.values():
            tree_select_(ok, tensors, snaps)
