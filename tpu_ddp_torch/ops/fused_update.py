"""K1: the single-pass fused optimizer update — clip, moments, param update
and EMA in one pass over every parameter leaf of a step, in one launch.

Counterpart of ``tpu_ddp/ops/fused_update.py``. The optax chain reads and
writes every leaf once per transform; K1 does the whole update tail in one
pass with the CUDA kernel in ``csrc/fused_update.cu``, whose one launch
covers up to ``MAX_LEAVES`` leaves.

* ``update_math`` is the plain PyTorch version. It follows the JAX
  package's ``_update_math`` (:116) expression for expression, and the
  kernel follows it operation for operation, so on the card the two are
  bitwise equal for the same inputs and the same scalar tensor.
  ``update_math_masked`` adds ZeRO-1's pad mask, as ``_reference_leaf``
  (:274) does: on a shard that starts at element ``start`` of a leaf of
  ``mask_size`` real elements, ``u`` is zero wherever
  ``start + i >= mask_size``, after the EMA has seen it.
  ``update_math_frozen`` is a frozen leaf's (the JAX package's
  ``set_to_zero`` branch, :453-461): ``u = 0``, ``p + u`` and the EMA of
  ``p + u``; the gradient and the moments are not read.
* ``LeafBatch`` is the wrapper: one step's leaves, validated, planned
  (``chunk_plan``) and given one ``u`` buffer once; ``run(grads, scalars)``
  then checks the grads in one pass and, for CUDA tensors, launches the
  kernel once per ``MAX_LEAVES`` leaves (adding one to
  ``LAUNCHES["fused_update"]`` each time); for CPU tensors it runs
  ``update_math_masked`` leaf by leaf; anything else raises. Each leaf has
  ``valid`` live elements (all of them unless ZeRO-1's pad mask says
  otherwise). It works in place:
  ``p``, ``m``, ``v`` and ``e`` are overwritten, ``u`` is written into its
  own buffer.
* ``fused_update_`` is the one-leaf form of the same entry point.
* ``FusedUpdate.apply`` drives it over a parameter dict, with the batch
  cached across steps. Its scalar prologue (global norm, schedule step,
  AdamW bias corrections; the JAX prologue at :411-441) runs as torch ops on
  the device and yields one float32[4] device tensor, so the step never
  waits for the host. ``FusedUpdate.apply_sharded`` is the ZeRO-1 form
  (JAX :371): the same pass over this rank's shards, with the pad mask and
  the clip's norm that the caller summed over the ranks. Both take a
  ``frozen`` mask (``train/optim.py``'s freeze predicate): frozen leaves get
  the kernel's ``FROZEN`` rows in the same launches, and the clip's norm
  covers the trainable gradients only (JAX :415).
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_ddp_torch.ops import LAUNCHES

NAME = "fused_update"

#: AdamW's constants (optax defaults, as ``make_optimizer`` uses them)
B1, B2, EPS = 0.9, 0.999, 1e-8

#: leaves one launch takes (``kMaxLeaves`` in csrc/fused_update.cu)
MAX_LEAVES = 128
#: elements one thread block covers (``kChunk``; a multiple of 4, so each
#: chunk of an aligned leaf starts on a 16-byte boundary)
CHUNK = 16384
#: columns of a row of the kernel's leaf table (``kCols``), and its flags
#: (``kLeafVec``, ``kLeafWdApply``, ``kLeafMask``, ``kLeafFrozen``)
G, P, M, V, E, U, N, FIRST_BLOCK, FLAGS, VALID = range(10)
COLS = 10
VEC, WD_APPLY, MASK, FROZEN = 1, 2, 4, 8


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


def shard_valid(mask_size: int, start: int, n: int) -> int:
    """Live elements of a shard of ``n`` elements that starts at element
    ``start`` of a leaf of ``mask_size`` real elements: those with
    ``start + i < mask_size``, which come first. The kernel's ``valid``
    column."""
    return min(max(mask_size - start, 0), n)


def update_math_masked(g, p, m, v, e, scalars: torch.Tensor, cfg: LeafConfig,
                       start: Optional[int] = None,
                       mask_size: Optional[int] = None):
    """``update_math``, then ZeRO-1's pad mask, as the JAX package's
    ``_reference_leaf`` (:274-287): ``u`` is zero where ``start + i >=
    mask_size`` (no mask when ``mask_size`` is None). Returns ``(u, p + u,
    m_new, v_new, e_new)``; the EMA saw the unmasked ``u``."""
    u, m_new, v_new, e_new = update_math(g, p, m, v, e, scalars, cfg)
    if mask_size is not None:
        gidx = start + torch.arange(g.shape[0], device=g.device)
        u = torch.where(gidx < mask_size, u, torch.zeros_like(u))
    return u, p + u, m_new, v_new, e_new


def update_math_frozen(p, e, cfg: LeafConfig):
    """A frozen leaf's update, as the JAX package's fused path computes it
    (:453-461, optax ``set_to_zero`` inside ``multi_transform``): ``u`` is
    zeros, the param ``p + u`` (so ``-0.0`` becomes ``+0.0``), and the EMA,
    outermost, still sees ``p + u``. Returns ``(u, p + u, None, None,
    e_new)``, the shape of ``update_math_masked``'s result."""
    u = torch.zeros_like(p)
    e_new = None
    if cfg.ema_decay:
        e_new = cfg.ema_decay * e + (1.0 - cfg.ema_decay) * (p + u)
    return u, p + u, None, None, e_new


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch: the leaves it updates (indices into the step's
    leaves, in order), each leaf's first block in its grid, and the grid's
    size. Block ``b`` belongs to the last leaf whose first block is ``<= b``
    and covers elements ``[(b - first) * CHUNK, (b - first + 1) * CHUNK)``
    of it, cut at the leaf's end."""

    leaves: Tuple[int, ...]
    first_blocks: Tuple[int, ...]
    blocks: int


@functools.lru_cache(maxsize=64)
def chunk_plan(sizes: Tuple[int, ...], max_leaves: int = MAX_LEAVES,
               chunk: int = CHUNK) -> Tuple[Launch, ...]:
    """K1's launches for leaves of ``sizes`` elements: the non-empty leaves
    in order, ``max_leaves`` to a launch (so ``ceil(leaves / max_leaves)``
    launches), ``ceil(n / chunk)`` blocks a leaf. Depends on the sizes
    alone, and is cached."""
    live = [i for i, n in enumerate(sizes) if n > 0]
    plan = []
    for s in range(0, len(live), max_leaves):
        firsts, blocks = [], 0
        for i in live[s:s + max_leaves]:
            firsts.append(blocks)
            blocks += -(-sizes[i] // chunk)
        plan.append(Launch(tuple(live[s:s + max_leaves]), tuple(firsts), blocks))
    return tuple(plan)


def vec_flag(ptrs: Sequence[int]) -> bool:
    """Whether a leaf takes the kernel's 16-byte vector path: every operand
    address (0 for a slot the recipe lacks) 16-byte aligned."""
    return all(p % 16 == 0 for p in ptrs)


def _operand_error(name: str, t: Optional[torch.Tensor], n: int,
                   device: torch.device) -> Optional[str]:
    if t is None:
        return f"operand {name} is missing"
    if t.dtype != torch.float32 or not t.is_contiguous():
        return f"{name} must be contiguous float32, got {t.dtype}"
    if t.numel() != n or t.device != device:
        return (f"{name} has {t.numel()} elements on {t.device}, p has {n} "
                f"and lies on {device}")
    return None


class LeafBatch:
    """One step's leaves for K1, validated and planned once.

    ``ps`` are the params; ``ms``, ``vs`` and ``es`` the momentum or Adam
    first moments, Adam's second moments and the EMA shadow (None where
    ``cfg`` has no such slot); ``cfg`` holds the flags common to the step
    (its ``wd_apply`` is not read), ``wd_apply`` the decay flag of each
    leaf, ``valid`` (None: every element) each leaf's live elements: under
    ZeRO-1's pad mask ``u`` is zero past them (``shard_valid``).
    ``frozen`` (None: none) marks the frozen leaves, which take
    ``update_math_frozen``: their grads are not read and they have no m or
    v (those given are ignored). ``us`` are the output buffers; without them the batch makes one
    buffer for all leaves, each leaf's slice starting on a 16-byte
    boundary, and ``us`` are its per-leaf views. ``run`` overwrites
    them, so they hold the last step's updates only.

    Checked here, once: dtype, contiguity, device and sizes of every
    operand, and that no two operands share storage."""

    def __init__(self, ps: Sequence[torch.Tensor], ms, vs, es,
                 cfg: LeafConfig, wd_apply: Sequence[bool],
                 us: Optional[Sequence[torch.Tensor]] = None,
                 valid: Optional[Sequence[int]] = None,
                 frozen: Optional[Sequence[bool]] = None):
        n_leaves = len(ps)
        self.cfg = cfg
        self.device = ps[0].device if n_leaves else torch.device("cpu")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"fused_update_: no kernel for device {self.device}")
        none = [None] * n_leaves
        self.ps = list(ps)
        self.ms = list(ms or none) if cfg.has_m else none
        self.vs = list(vs or none) if cfg.has_v else none
        self.es = list(es or none) if cfg.ema_decay else none
        self.frozen = [bool(f) for f in (frozen or [False] * n_leaves)]
        if len(self.frozen) != n_leaves:
            raise ValueError("fused_update_: frozen needs one flag a leaf")
        for i in (i for i, f in enumerate(self.frozen) if f):
            self.ms[i] = self.vs[i] = None
        self.sizes = tuple(p.numel() for p in self.ps)
        self.valid = list(self.sizes if valid is None else valid)
        if len(self.valid) != n_leaves or not all(
                0 <= k <= n for k, n in zip(self.valid, self.sizes)):
            raise ValueError("fused_update_: valid needs one count in [0, n] "
                             "a leaf")
        if us is None:
            offsets = np.cumsum([0] + [-(-n // 4) * 4 for n in self.sizes])
            self.u_flat = torch.empty(int(offsets[-1]), dtype=torch.float32,
                                      device=self.device)
            us = [self.u_flat[int(o):int(o) + p.numel()].view(p.shape)
                  for o, p in zip(offsets, self.ps)]
        self.us = list(us)
        slots = {"p": self.ps, "u": self.us}
        if cfg.has_m:
            slots["m"] = self.ms
        if cfg.has_v:
            slots["v"] = self.vs
        if cfg.ema_decay:
            slots["e"] = self.es
        ranges = []
        for name, tensors in slots.items():
            if len(tensors) != n_leaves:
                raise ValueError(f"fused_update_: {len(tensors)} {name} "
                                 f"operands for {n_leaves} leaves")
            for t, n, cold in zip(tensors, self.sizes, self.frozen):
                if cold and name in ("m", "v"):
                    continue
                err = _operand_error(name, t, n, self.device)
                if err:
                    raise ValueError(f"fused_update_: {err}")
                if n:
                    ranges.append((t.data_ptr(), t.data_ptr() + 4 * n))
        ranges.sort()
        if any(b[0] < a[1] for a, b in zip(ranges, ranges[1:])):
            raise ValueError("fused_update_: operands must not share storage")
        self._starts = {r[0] for r in ranges}
        self.plan = chunk_plan(self.sizes)
        self.rows = [i for launch in self.plan for i in launch.leaves]
        self.wd_apply = [bool(f and cfg.wd > 0 and not cold)
                         for f, cold in zip(wd_apply, self.frozen)]
        self._cfgs = [dataclasses.replace(cfg, wd_apply=w) for w in self.wd_apply]
        self._build_table()

    def _build_table(self) -> None:
        """The kernel's leaf table, all but the grads' column, and each
        launch's arguments."""
        cfg = self.cfg
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        self.table = np.zeros((len(self.rows), COLS), dtype=np.int64)
        for r, i in enumerate(self.rows):
            ops_ = (self.ps[i], self.ms[i], self.vs[i], self.es[i], self.us[i])
            self.table[r, P:U + 1] = [ptr(t) for t in ops_]
            self.table[r, N] = self.sizes[i]
            self.table[r, VALID] = self.valid[i]
            self.table[r, FLAGS] = ((VEC if vec_flag([ptr(t) for t in ops_]) else 0)
                                    | (WD_APPLY if self.wd_apply[i] else 0)
                                    | (MASK if self.valid[i] < self.sizes[i] else 0)
                                    | (FROZEN if self.frozen[i] else 0))
        self._flags = self.table[:, FLAGS].copy()
        self._frozen_rows = np.array([self.frozen[i] for i in self.rows], dtype=bool)
        self._launches, row = [], 0
        for launch in self.plan:
            k = len(launch.leaves)
            self.table[row:row + k, FIRST_BLOCK] = launch.first_blocks
            self._launches.append((self.table.ctypes.data + row * COLS * 8, k,
                                   launch.blocks))
            row += k
        self._consts = (
            int(cfg.kind == "adamw"), int(cfg.kind == "sgd" and cfg.momentum > 0),
            int(cfg.has_clip), int(bool(cfg.ema_decay)),
            int(cfg.step_const is not None),
            cfg.momentum, cfg.wd, cfg.max_norm,
            cfg.step_const if cfg.step_const is not None else 0.0,
            1 - cfg.b1, cfg.b1, 1 - cfg.b2, cfg.b2, cfg.eps,
            cfg.ema_decay, 1.0 - cfg.ema_decay,
        )

    def _check_grads(self, gs: Sequence[torch.Tensor]) -> None:
        """One pass over the grads: float32, contiguous, sized and placed
        as their params, and apart from every other operand."""
        if len(gs) != len(self.sizes):
            raise ValueError(f"fused_update_: {len(gs)} grads for "
                             f"{len(self.sizes)} leaves")
        f32, dev = torch.float32, self.device
        for g, n in zip(gs, self.sizes):
            if g.dtype is not f32 or not g.is_contiguous() or g.numel() != n \
                    or g.device != dev:
                raise ValueError(f"fused_update_: {_operand_error('g', g, n, dev)}")

    def run(self, gs: Sequence[torch.Tensor], scalars: torch.Tensor) -> None:
        """One step's update of every leaf, in place (class docstring):
        ``len(plan)`` launches for CUDA tensors, ``update_math`` leaf by leaf
        for CPU tensors."""
        self._check_grads(gs)
        if (scalars.dtype != torch.float32 or scalars.numel() != 4
                or scalars.device != self.device):
            raise ValueError("fused_update_: scalars must be float32[4] on "
                             "the leaves' device")
        self.table_for(gs)
        if self.device.type == "cuda":
            self._launch(scalars)
            return
        for i, g in enumerate(gs):
            p, m, v, e, u = self.ps[i], self.ms[i], self.vs[i], self.es[i], self.us[i]
            live = self.valid[i]
            flat = [None if t is None else t.reshape(-1) for t in (g, p, m, v, e)]
            if self.frozen[i]:
                u_new, p_new, m_new, v_new, e_new = update_math_frozen(
                    flat[1], flat[4], self._cfgs[i])
            else:
                u_new, p_new, m_new, v_new, e_new = update_math_masked(
                    *flat, scalars, self._cfgs[i], start=0,
                    mask_size=live if live < self.sizes[i] else None)
            u.copy_(u_new.view(u.shape))
            p.copy_(p_new.view(p.shape))
            for buf, new in ((m, m_new), (v, v_new), (e, e_new)):
                if new is not None:
                    buf.copy_(new.view(buf.shape))

    def table_for(self, gs: Sequence[torch.Tensor]) -> np.ndarray:
        """The kernel's leaf table for this step's grads: one row a
        non-empty leaf, in launch order (columns ``G`` to ``FLAGS``); a
        leaf's ``VEC`` flag holds only if all six of its operands, this
        step's grad too, are 16-byte aligned. A frozen row's grad address
        is 0: the kernel does not read it."""
        gp = [gs[i].data_ptr() for i in self.rows]
        if not self._starts.isdisjoint(gp):
            raise ValueError("fused_update_: operands must not share storage")
        tab = self.table
        tab[:, G] = np.where(self._frozen_rows, 0, gp)
        tab[:, FLAGS] = np.where(tab[:, G] % 16 == 0, self._flags, self._flags & ~VEC)
        return tab

    def _launch(self, scalars, lib=None) -> None:
        """This step's launches, through ``lib`` (a build of
        ``csrc/fused_update.cu`` with the same C entry point; the port's own
        by default)."""
        from tpu_ddp_torch.ops import _build

        lib = lib or _build.load(NAME)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for rows, k, blocks in self._launches:
            rc = lib.tpu_ddp_fused_update(rows, k, blocks, scalars.data_ptr(),
                                          *self._consts, stream)
            _build.check(lib, rc, "fused_update_ launch")
            LAUNCHES[NAME] += 1


def fused_update_(g, p, m, v, e, u, scalars: torch.Tensor, cfg: LeafConfig) -> None:
    """One leaf's update, in place: the one-leaf form of ``LeafBatch``
    (module docstring). CUDA tensors launch K1 once; CPU tensors take
    ``update_math``; other devices raise."""
    LeafBatch([p], [m], [v], [e], cfg, [cfg.wd_apply], us=[u]).run([g], scalars)


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of per-leaf sums of squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def prologue(recipe: UpdateRecipe, grads, opt_state,
             g_norm: Optional[torch.Tensor] = None,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """``[g_norm, step, bc1, bc2]`` as one float32[4] tensor on ``device``
    (default: the grads'), from torch ops only, with no host sync. Under
    clipping the norm is ``g_norm`` when the caller gives it (ZeRO-1's,
    summed over the ranks), else ``global_norm`` of ``grads`` (the trainable
    ones; none gives 0, as optax's norm of an empty tree)."""
    grads = list(grads)
    dev = device if device is not None else grads[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    if recipe.grad_clip_norm <= 0:
        g_norm = zero
    elif g_norm is None:
        g_norm = global_norm(grads) if grads else zero
    step = -1 * recipe.lr(opt_state.sched_count) if callable(recipe.lr) else zero
    bc1 = bc2 = one
    if recipe.optimizer == "adamw":
        count_inc = (opt_state.count + 1).to(torch.float32)
        bc1 = 1 - B1 ** count_inc
        bc2 = 1 - B2 ** count_inc
    return torch.stack([g_norm, step, bc1, bc2]).to(torch.float32)


class FusedUpdate:
    """Drives K1 over a parameter dict: ``apply(grads, opt_state, params,
    wd_mask, frozen)`` updates ``params`` and ``opt_state`` in place and
    returns the updates. ``opt_state`` is
    ``tpu_ddp_torch.train.optim.OptState``; ``wd_mask`` names the leaves
    weight decay applies to, ``frozen`` (None: none) the frozen ones, which
    have no m or v slot.
    ``apply_sharded(gsh, opt_state, psh, partition)`` is the same on this
    rank's ZeRO-1 shards (``parallel/zero.py``), with the pad mask.

    The ``LeafBatch`` of the params and state slots is built on the first
    call and kept while the same tensors, at the same addresses, come back:
    a step then only checks the grads and launches. The returned updates
    are views of the batch's one ``u`` buffer, which the next step
    overwrites; nothing on the train step reads them (``train/steps.py``
    drops them), where the JAX package returns fresh arrays."""

    def __init__(self, recipe: UpdateRecipe):
        if recipe.optimizer not in ("sgd", "adamw"):
            raise ValueError(
                f"fused update supports sgd/adamw, got {recipe.optimizer!r}")
        self.recipe = recipe
        self._batch: Optional[LeafBatch] = None
        self._key: tuple = ()

    def _slots(self, opt_state, names):
        r = self.recipe
        pick = lambda d: None if d is None else [d.get(n) for n in names]  # noqa: E731
        if r.optimizer == "adamw":
            return pick(opt_state.mu), pick(opt_state.nu), pick(opt_state.ema)
        return pick(opt_state.trace if r.momentum > 0 else None), None, \
            pick(opt_state.ema)

    def _unchanged(self, opt_state, params, wd_mask, valid, frozen) -> bool:
        """Whether the cached batch still holds these tensors: the same
        names, the same param and slot tensors (an identity test) and the
        params at the same addresses, under the same decay mask, live
        counts and frozen mask."""
        names, ps, p_ptrs, mask, live, cold = self._key
        if (list(params) != names or wd_mask != mask or valid != live
                or frozen != cold
                or not all(map(operator.is_, params.values(), ps))
                or list(map(torch.Tensor.data_ptr, ps)) != p_ptrs):
            return False
        b = self._batch
        return all(now is None or all(map(operator.is_, now, cached))
                   for cached, now in zip((b.ms, b.vs, b.es),
                                          self._slots(opt_state, names)))

    def _batch_for(self, opt_state, params, wd_mask, valid, frozen) -> LeafBatch:
        """The cached batch, or a new one when ``_unchanged`` fails."""
        if self._batch is not None and self._unchanged(opt_state, params,
                                                       wd_mask, valid, frozen):
            return self._batch
        names = list(params)
        ps = [params[n] for n in names]
        ms, vs, es = self._slots(opt_state, names)
        cfg = LeafConfig.from_recipe(self.recipe, False)
        self._batch = LeafBatch(ps, ms, vs, es, cfg, [wd_mask[n] for n in names],
                                valid=valid, frozen=[frozen[n] for n in names])
        self._key = (names, ps, [p.data_ptr() for p in ps], dict(wd_mask), valid,
                     dict(frozen))
        return self._batch

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor], opt_state,
              params: Dict[str, torch.Tensor], wd_mask: Dict[str, bool],
              frozen: Optional[Dict[str, bool]] = None,
              g_norm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The update of whole leaves; ``g_norm`` is the clip's norm where
        the caller forms it (tensor parallelism's local leaves), else the
        global norm of the trainable ``grads``."""
        return self._run(grads, opt_state, params, wd_mask, None, frozen, g_norm)

    @torch.no_grad()
    def apply_sharded(self, gsh: Dict[str, torch.Tensor], opt_state,
                      psh: Dict[str, torch.Tensor], partition,
                      g_norm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The ZeRO-1 update of this rank's shards, in place (the JAX
        ``apply_sharded``, :371-376): ``gsh``, ``psh`` and ``opt_state``'s
        slots are the shards of ``partition`` (a ``Zero1Partition``), each
        leaf's pad masked by the kernel (``partition.valid()``), under the
        decay mask and freeze predicate of ``partition.tx``, the decay mask
        taken from the original shapes. ``g_norm`` is the clip's global
        norm over the trainable shards, which the caller sums over the
        ranks; a clipping recipe needs it. Returns the masked updates."""
        if self.recipe.grad_clip_norm > 0 and g_norm is None:
            raise ValueError("apply_sharded under clipping needs the global "
                             "norm over the ranks (g_norm)")
        return self._run(gsh, opt_state, psh, partition.tx.decay_mask,
                         partition.valid(), partition.tx.frozen_mask(psh), g_norm)

    def _run(self, grads, opt_state, params, wd_mask, valid, frozen=None,
             g_norm=None):
        r = self.recipe
        frozen = frozen or {n: False for n in params}
        scalars = prologue(r, [g for n, g in grads.items() if not frozen[n]],
                           opt_state, g_norm, device=next(iter(params.values())).device)
        batch = self._batch_for(opt_state, params, wd_mask, valid, frozen)
        names = self._key[0]
        if len(grads) != len(names):
            raise ValueError(f"fused update: {len(grads)} grads for "
                             f"{len(names)} params")
        # autograd may hand back a grad in another memory format (a conv
        # kernel's); the kernel reads each leaf as one contiguous run
        batch.run([grads[n].contiguous() for n in names], scalars)
        if r.optimizer == "adamw":
            opt_state.count += 1
        if callable(r.lr):
            opt_state.sched_count += 1
        return dict(zip(names, batch.us))
