"""K1: the single-pass fused optimizer update — clip, moments, param update
and EMA in one pass over each parameter leaf.

Counterpart of ``tpu_ddp/ops/fused_update.py``. The optax chain reads and
writes every leaf once per transform; ``fused_update_`` does the whole
update tail in one pass per leaf with the CUDA kernel in
``csrc/fused_update.cu``.

* ``update_math`` is the plain PyTorch version. It follows the JAX
  package's ``_update_math`` (:116) expression for expression, and the
  kernel follows it operation for operation, so on the card the two are
  bitwise equal for the same inputs and the same scalar tensor.
* ``fused_update_`` is the wrapper: for CUDA tensors it launches the kernel
  (and adds one to ``LAUNCHES["fused_update"]``), for CPU tensors it runs
  ``update_math``; anything else raises. It works in place: ``p``, ``m``,
  ``v`` and ``e`` are overwritten, ``u`` is written into its own buffer.
* ``FusedUpdate.apply`` drives it over a parameter dict. Its scalar
  prologue (global norm, schedule step, AdamW bias corrections; the JAX
  prologue at :411-441) runs as torch ops on the device and yields one
  float32[4] device tensor, so the step never waits for the host.

Not ported yet: the ZeRO-1 pad mask (``start``/``mask_size``) and frozen
leaves (``labeler``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from tpu_ddp_torch.ops import LAUNCHES

NAME = "fused_update"

#: AdamW's constants (optax defaults, as ``make_optimizer`` uses them)
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class UpdateRecipe:
    """Static description of the optimizer chain ``make_optimizer`` built.
    ``lr`` is a float or a schedule ``count_tensor -> float32 tensor``."""

    optimizer: str                    # "sgd" | "adamw"
    lr: Any
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    ema_decay: float = 0.0


@dataclasses.dataclass(frozen=True)
class LeafConfig:
    """The static flags and float constants of one leaf's update."""

    kind: str
    momentum: float
    wd: float
    wd_apply: bool
    has_clip: bool
    max_norm: float
    step_const: Optional[float]       # -lr, or None under a schedule
    ema_decay: float
    b1: float
    b2: float
    eps: float

    @classmethod
    def from_recipe(cls, r: UpdateRecipe, wd_apply: bool) -> "LeafConfig":
        return cls(kind=r.optimizer, momentum=r.momentum, wd=r.weight_decay,
                   wd_apply=bool(wd_apply and r.weight_decay > 0),
                   has_clip=r.grad_clip_norm > 0, max_norm=r.grad_clip_norm,
                   step_const=None if callable(r.lr) else -1 * r.lr,
                   ema_decay=r.ema_decay, b1=B1, b2=B2, eps=EPS)

    @property
    def has_m(self) -> bool:
        return self.kind == "adamw" or self.momentum > 0

    @property
    def has_v(self) -> bool:
        return self.kind == "adamw"


def update_math(g, p, m, v, e, scalars: torch.Tensor, cfg: LeafConfig):
    """THE update arithmetic, as plain torch ops. ``scalars`` is the
    float32[4] prologue tensor ``[g_norm, step, bc1, bc2]``. Returns
    ``(u, m_new, v_new, e_new)``; ``p + u`` is the new param."""
    g_norm, step, bc1, bc2 = scalars[0], scalars[1], scalars[2], scalars[3]
    m_new = v_new = e_new = None
    if cfg.has_clip:
        g = torch.where(g_norm < cfg.max_norm, g, (g / g_norm) * cfg.max_norm)
    if cfg.kind == "adamw":
        mu = (1 - cfg.b1) * g + cfg.b1 * m
        nu = (1 - cfg.b2) * (g * g) + cfg.b2 * v
        m_new, v_new = mu, nu
        mu_hat = mu / bc1
        nu_hat = nu / bc2
        u = mu_hat / (torch.sqrt(nu_hat + 0.0) + cfg.eps)   # eps_root == 0.0
        if cfg.wd_apply:
            u = u + cfg.wd * p                              # decoupled decay
    else:
        if cfg.wd_apply:
            g = g + cfg.wd * p                              # coupled decay
        if cfg.momentum > 0:
            u = g + cfg.momentum * m                        # optax trace
            m_new = u
        else:
            u = g
    if cfg.step_const is not None:
        u = cfg.step_const * u                              # scale(-lr)
    else:
        u = step * u                                        # scale_by_schedule
    if cfg.ema_decay:
        e_new = cfg.ema_decay * e + (1.0 - cfg.ema_decay) * (p + u)
    return u, m_new, v_new, e_new


def _check(g, p, m, v, e, u, scalars, cfg: LeafConfig):
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_update_: no kernel for device {p.device}")
    leaves = {"g": g, "p": p, "u": u}
    if cfg.has_m:
        leaves["m"] = m
    if cfg.has_v:
        leaves["v"] = v
    if cfg.ema_decay:
        leaves["e"] = e
    for name, t in leaves.items():
        if t is None:
            raise ValueError(f"fused_update_: operand {name} is missing")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_update_: {name} must be contiguous "
                             f"float32, got {t.dtype}")
        if t.numel() != g.numel() or t.device != p.device:
            raise ValueError(f"fused_update_: {name} has {t.numel()} "
                             f"elements on {t.device}, g has {g.numel()} "
                             f"and p lies on {p.device}")
    ptrs = [t.data_ptr() for t in leaves.values()]
    if g.numel() and len(set(ptrs)) != len(ptrs):
        raise ValueError("fused_update_: operands must not share storage")
    if (scalars.dtype != torch.float32 or scalars.numel() != 4
            or scalars.device != p.device):
        raise ValueError("fused_update_: scalars must be float32[4] on "
                         "the leaves' device")
    return leaves


def fused_update_(g, p, m, v, e, u, scalars: torch.Tensor, cfg: LeafConfig) -> None:
    """One leaf's update, in place (module docstring). CUDA tensors launch
    K1; CPU tensors take ``update_math``; other devices raise."""
    leaves = _check(g, p, m, v, e, u, scalars, cfg)
    if p.device.type == "cuda":
        from tpu_ddp_torch.ops import _build

        lib = _build.load(NAME)
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        rc = lib.tpu_ddp_fused_update(
            ptr(g), ptr(p), ptr(leaves.get("m")), ptr(leaves.get("v")),
            ptr(leaves.get("e")), ptr(u), ptr(scalars), g.numel(),
            int(cfg.kind == "adamw"), int(cfg.kind == "sgd" and cfg.momentum > 0),
            int(cfg.wd_apply), int(cfg.has_clip), int(bool(cfg.ema_decay)),
            int(cfg.step_const is not None),
            cfg.momentum, cfg.wd, cfg.max_norm,
            cfg.step_const if cfg.step_const is not None else 0.0,
            1 - cfg.b1, cfg.b1, 1 - cfg.b2, cfg.b2, cfg.eps,
            cfg.ema_decay, 1.0 - cfg.ema_decay,
            torch.cuda.current_stream(p.device).cuda_stream,
        )
        _build.check(lib, rc, "fused_update_ launch")
        LAUNCHES[NAME] += 1
    else:
        u_new, m_new, v_new, e_new = update_math(g, p, m, v, e, scalars, cfg)
        u.copy_(u_new)
        p.copy_(p + u_new)
        for buf, new in ((m, m_new), (v, v_new), (e, e_new)):
            if new is not None:
                buf.copy_(new)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of per-leaf sums of squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def prologue(recipe: UpdateRecipe, grads, opt_state) -> torch.Tensor:
    """``[g_norm, step, bc1, bc2]`` as one float32[4] tensor on the grads'
    device, from torch ops only (no host sync)."""
    grads = list(grads)
    dev = grads[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    g_norm = global_norm(grads) if recipe.grad_clip_norm > 0 else zero
    step = -1 * recipe.lr(opt_state.sched_count) if callable(recipe.lr) else zero
    bc1 = bc2 = one
    if recipe.optimizer == "adamw":
        count_inc = (opt_state.count + 1).to(torch.float32)
        bc1 = 1 - B1 ** count_inc
        bc2 = 1 - B2 ** count_inc
    return torch.stack([g_norm, step, bc1, bc2]).to(torch.float32)


class FusedUpdate:
    """Drives K1 over a parameter dict: ``apply(grads, opt_state, params,
    wd_mask)`` updates ``params`` and ``opt_state`` in place and returns the
    updates. ``opt_state`` is ``tpu_ddp_torch.train.optim.OptState``;
    ``wd_mask`` names the leaves weight decay applies to."""

    def __init__(self, recipe: UpdateRecipe):
        if recipe.optimizer not in ("sgd", "adamw"):
            raise ValueError(
                f"fused update supports sgd/adamw, got {recipe.optimizer!r}")
        self.recipe = recipe

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor], opt_state,
              params: Dict[str, torch.Tensor],
              wd_mask: Dict[str, bool]) -> Dict[str, torch.Tensor]:
        r = self.recipe
        scalars = prologue(r, grads.values(), opt_state)
        updates = {}
        for name, g in grads.items():
            p = params[name]
            cfg = LeafConfig.from_recipe(r, wd_mask[name])
            m = v = e = None
            if r.optimizer == "adamw":
                m, v = opt_state.mu[name], opt_state.nu[name]
            elif r.momentum > 0:
                m = opt_state.trace[name]
            if r.ema_decay:
                e = opt_state.ema[name]
            u = torch.empty_like(p)
            fused_update_(g.contiguous(), p, m, v, e, u, scalars, cfg)
            updates[name] = u
        if r.optimizer == "adamw":
            opt_state.count += 1
        if callable(r.lr):
            opt_state.sched_count += 1
        return updates
