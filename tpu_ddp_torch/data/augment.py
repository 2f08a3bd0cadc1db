"""On-device augmentation inside the train step: random crop and flip, and
mixup.

Counterpart of ``tpu_ddp/data/augment.py`` (``random_crop_flip`` :23,
``mixup`` :52). Each is split into a deterministic core, which takes its
draws as arguments (``crop_flip``, ``mix``), and its draws
(``crop_flip_draws``, ``mixup_draws``). Images are NHWC ``(B, H, W, C)``,
as the JAX package's and as the port's models take them.

The draws. The JAX step keys them ``fold_in(fold_in(key(seed), step),
shard)``, mixup on ``fold_in(key, 1)`` (``tpu_ddp/train/steps.py:209-220``).
The port cannot reproduce threefry's bits, and keeps the properties the
keying gives instead:

* every draw is a function of ``(seed, step, rank)`` alone, so a resumed run
  draws what the uninterrupted one drew, and a fused K-step call what K
  single steps draw;
* the draws differ across ranks and steps;
* each kind of draw (crop rows, crop columns, flips, the mixup partner, the
  mixup lambda) has a stream of its own, so crop/flip and mixup are
  independent.

They are a counter-based hash computed on the device from the step tensor
(``TrainState.step``): no global RNG, no generator state to checkpoint and
no host read of the step. The hash is Chris Wellons' ``lowbias32`` over
32-bit values held in int64 tensors, with every product split so that no
intermediate exceeds 2**49 (no overflow anywhere); the key folds the seed,
the rank and the stream (Python ints) and then the step's two 32-bit halves;
element ``i`` of a draw is ``mix(key ^ mix(i))``. The same integer ops give
the same bits on the CPU and the card.

Lambda ~ Beta(alpha, alpha) is ``X / (X + Y)`` of two Gamma(alpha) draws,
each by Marsaglia and Tsang's method at ``alpha + 1`` with the
``U ** (1 / alpha)`` boost, computed in log space in float64. The method's
rejection loop becomes ``GAMMA_TRIALS`` candidate trials drawn at once, of
which the first accepted one is taken: static shapes, no host sync. Each
trial is accepted with probability above 0.95 at ``alpha + 1 >= 1``, so all
16 fail with probability below 1e-20; were they to, the draw takes ``d``,
the method's centre.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

M32 = 0xFFFFFFFF
#: one stream a kind of draw
STREAMS = {"crop_row": 1, "crop_col": 2, "flip": 3, "mix_perm": 4, "mix_lam": 5}
GAMMA_TRIALS = 16


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for 32-bit ``x`` (a tensor or an int) and a
    32-bit constant, in two 16-bit halves of ``c``."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(x):
    """``lowbias32``: a bijection of 32-bit values with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _bits(seed: int, step: torch.Tensor, rank: int, stream: str, n: int) -> torch.Tensor:
    """``step.shape + (n,)`` int64 values in ``[0, 2**32)``: ``n`` draws of
    ``stream`` at each of ``step``'s steps (module docstring)."""
    k0 = _mix32(_mix32(_mix32(seed & M32) ^ (rank & M32)) ^ STREAMS[stream])
    step = step.to(torch.int64)
    key = _mix32(_mix32((step & M32) ^ k0) ^ ((step >> 32) & M32))
    idx = _mix32(torch.arange(n, dtype=torch.int64, device=step.device))
    return _mix32(key[..., None] ^ idx)


def _open_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float64 uniforms in the open interval (0, 1)."""
    return (bits.to(torch.float64) + 0.5) * 2.0 ** -32


def crop_flip_draws(seed: int, step: torch.Tensor, rank: int, batch: int, *,
                    pad: int = 4, flip_prob: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(offsets, flip)``: ``step.shape + (batch, 2)`` int64 crop offsets
    (row, column), each uniform over ``0 .. 2 * pad``, and ``step.shape +
    (batch,)`` bool flips, true with probability ``flip_prob``."""
    offsets = torch.stack([_bits(seed, step, rank, s, batch) % (2 * pad + 1)
                           for s in ("crop_row", "crop_col")], dim=-1)
    flip = (_bits(seed, step, rank, "flip", batch) >> 8).to(torch.float32) * 2.0 ** -24
    return offsets, flip < flip_prob


def crop_flip(images: torch.Tensor, offsets: torch.Tensor, flip: torch.Tensor,
              *, pad: int = 4) -> torch.Tensor:
    """The JAX ``random_crop_flip`` with its draws given: zero-pad
    ``images`` (B, H, W, C) by ``pad``, take the H x W window at ``offsets``
    (B, 2) (row, column) of each, and mirror it left to right where
    ``flip`` (B,). One gather, so the values are the input's bits."""
    b, h, w, _ = images.shape
    padded = torch.nn.functional.pad(images, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, :1] + torch.arange(h, device=images.device)
    cols = torch.arange(w, device=images.device)
    cols = offsets[:, 1:] + torch.where(flip[:, None], w - 1 - cols, cols)
    batch = torch.arange(b, device=images.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def _log_gamma_draw(u: torch.Tensor, boost: torch.Tensor, alpha: float) -> torch.Tensor:
    """log of one Gamma(alpha) draw a row: Marsaglia and Tsang at
    ``alpha + 1`` over the ``GAMMA_TRIALS`` trials of ``u`` (``(..., T, 3)``
    open uniforms: two for a Box-Muller normal, one for the test), times
    ``boost ** (1 / alpha)`` (module docstring)."""
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.sqrt(-2.0 * torch.log(u[..., 0])) * torch.cos(2.0 * math.pi * u[..., 1])
    v = (1.0 + c * x) ** 3
    live = v > 0
    log_v = torch.log(torch.where(live, v, torch.ones_like(v)))
    ok = live & (torch.log(u[..., 2]) < 0.5 * x * x + d - d * v + d * log_v)
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    log_g = torch.gather(math.log(d) + log_v, -1, first)[..., 0]
    log_g = torch.where(ok.any(dim=-1), log_g, torch.full_like(log_g, math.log(d)))
    return log_g + torch.log(boost) / alpha


def mixup_draws(seed: int, step: torch.Tensor, rank: int, batch: int, *, alpha: float,
                valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, lam)`` of one step (``step`` 0-d) or of each of ``step``'s
    steps: the partner of each row (``argsort`` of uniforms: a uniform
    permutation, no host sync) and one float32 lambda ~ Beta(alpha, alpha).
    With ``valid`` (bool (batch,), the loader's mask) a row whose partner is
    masked mixes with itself, as in the JAX ``mixup``."""
    perm = torch.argsort(_bits(seed, step, rank, "mix_perm", batch), dim=-1, stable=True)
    if valid is not None:
        perm = torch.where(valid[perm], perm, torch.arange(batch, device=perm.device))
    t = GAMMA_TRIALS
    u = _open_uniform(_bits(seed, step, rank, "mix_lam", 2 * 3 * t + 2))
    trials = u[..., : 6 * t].reshape(*u.shape[:-1], 2, t, 3)
    log_g = _log_gamma_draw(trials, u[..., 6 * t:], alpha)
    lam = torch.sigmoid(log_g[..., 0] - log_g[..., 1])
    return perm, lam.to(torch.float32)


def mix(images: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The JAX ``mixup``'s blend with its draws given:
    ``lam * images + (1 - lam) * images[perm]``."""
    return lam * images + (1.0 - lam) * images[perm]
