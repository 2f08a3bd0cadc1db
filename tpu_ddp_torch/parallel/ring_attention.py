"""Ring attention: exact self-attention over a sequence split across the
ranks of a ring.

Counterpart of ``tpu_ddp/parallel/ring_attention.py``. Each rank of a
sequence group (``parallel/mesh.py``) holds ``(B, T_local, H, D)`` of
q, k and v, the ring's chunks in rank order; k and v (with their key mask)
travel around the ring while the rank's queries attend to each chunk as it
passes, and an online softmax merges the chunks' partial results. The
output is this rank's rows of the attention over the whole sequence.

Both entry points run one ``torch.autograd.Function``, ``RingAttention``,
whose tile (one query chunk against one key chunk) is the only difference:

* ``ring_flash_attention`` (the JAX :384) takes the flash kernels: K4
  (``flash_forward``) on each forward hop, K5 and K6 (``flash_dq``,
  ``flash_dkv``) on each backward hop, on CUDA tensors, and their plain
  versions on CPU tensors (``ops/flash_attention.py``);
* ``ring_attention`` (the JAX :98) takes the kernels' plain versions
  (``forward_plain``, ``dq_plain``, ``dkv_plain``) on any device: the
  whole ``(T_local, T_local)`` score tile in float32, the JAX ``_block``
  tile's role.

The forward is the JAX ``_ring_fwd_impl`` (:236): hop 0 is the rank's own
chunk; each later hop receives the chunk of the rank before it, and the
tile's normalised output and row log-sum-exp ``lse`` merge into the running
pair in float32 (``combine``, the JAX ``_combine`` :228). The backward is
the JAX ``_rf_bwd`` (:317), a second ring: with the merged ``lse`` and
``di = rowsum(dO * O)`` taken once from the merged output (``row_dot``),
dq accumulates on the rank while the k/v chunks rotate again together with
their float32 dk/dv accumulators, each hop adding its tile's dk, dv; after
n hops the accumulators are home. The last k/v rotation of the backward
would carry nothing used, and is not sent. JAX differentiates its plain
ring by AD through ``ppermute``; the port has no such AD, so the plain
ring takes the same blockwise backward with the plain tiles
(``ROADMAP.md`` §3). The JAX ring unrolls up to 8 hops and rolls longer
rings into one ``lax.scan`` (``_UNROLL_MAX``, ``_unroll_or_scan``
:75-89), a compile-time matter; the port's loop runs eagerly.

**Causal** (``causal=True``; device order along the ring is sequence
order): hop 0, the diagonal, is the only causal tile; at hop i a rank holds
the chunk of the rank i places before it, which lies wholly in its past
when ``i <= s`` (its position on the ring) and wholly in its future
otherwise, so hop i runs a non-causal tile or none (the JAX :246-262,
:352-360). A skipped hop still rotates: every rank takes part in every
exchange. A rank at position s runs ``s + 1`` tiles a pass, n without
``causal``.

**Key mask** (``kv_mask`` ``(B, T_local)``, nonzero = attend) travels with
its chunk. A query row that sees no key of a chunk gets ``out = 0`` and
``lse = NEG`` (the finite ``-1e30``) from that tile, so ``combine`` gives it
no weight (with -inf the merge would make NaN); a row that sees no key at
all outputs 0 with zero gradients.

**Overlap.** Each hop's exchange is posted before the tile of the hop
before it runs, so the transfer and the tile overlap where the transport
allows it (NCCL; ``parallel/collectives.py::exchange_async``), with at most
two k/v buffers in flight; the backward's accumulators travel one hop
behind their tiles in the same way.

``sequence_sharded_attention`` (the JAX :402) slices global
``(B, T, H, D)`` tensors to this rank's chunk and runs the ring on it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.parallel.collectives import exchange_async, group_ranks


def ring_position(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """``(n, s)``: the ring's size and this rank's position on it; ``(1,
    0)`` with no process group up."""
    ranks = group_ranks(group)
    return len(ranks), (ranks.index(dist.get_rank()) if len(ranks) > 1 else 0)


def combine(o: torch.Tensor, lse: torch.Tensor, o2: torch.Tensor,
            lse2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two normalised partial results: ``o`` ``(B, T, H, D)`` and
    ``lse`` ``(B, H, T)``, all float32 (the JAX ``_combine``)."""
    lse_new = torch.logaddexp(lse, lse2)
    w1 = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w2 = torch.exp(lse2 - lse_new).transpose(1, 2)[..., None]
    return o * w1 + o2 * w2, lse_new


def _tiles(flash: bool):
    """(forward, dq, dkv) tile functions: the kernels' wrappers or their
    plain versions."""
    if flash:
        return fa.flash_forward, fa.flash_dq, fa.flash_dkv
    return fa.forward_plain, fa.dq_plain, fa.dkv_plain


def _visible(causal: bool, hop: int, s: int) -> bool:
    """Whether hop ``hop`` has a tile on the rank at ring position ``s``."""
    return not causal or hop <= s


def _rotate(bufs, n: int, s: int, group):
    """Post the exchange that sends ``bufs`` to the next rank of the ring
    and receives the previous rank's."""
    return exchange_async([b for b in bufs if b is not None], (s + 1) % n, (s - 1) % n,
                          group)


def _received(handle, masked: bool):
    """``(kv, kv_mask)`` out of a k/v rotation's received buffers: ``kv``
    the ``(2, B, T, H, D)`` buffer of the chunk's k and v."""
    got = handle.wait()
    return got[0], (got[1] if masked else None)


def ring_forward(q, k, v, kv_mask, group, causal: bool, flash: bool):
    """The forward ring alone: ``(out, lse)``, this rank's rows of the
    output in q's dtype and their merged float32 ``(B, H, T_local)``
    log-sum-exp (module docstring)."""
    n, s = ring_position(group)
    fwd = _tiles(flash)[0]
    o, lse = fwd(q, k, v, kv_mask, causal)
    o = o.float()
    if n > 1:
        pending = _rotate((torch.stack([k, v]), kv_mask), n, s, group)
    for hop in range(1, n):
        kv, km = _received(pending, kv_mask is not None)
        if hop < n - 1:
            pending = _rotate((kv, km), n, s, group)
        if _visible(causal, hop, s):
            o2, lse2 = fwd(q, kv[0], kv[1], km, False)
            o, lse = combine(o, lse, o2.float(), lse2)
    return o.to(q.dtype), lse


class RingAttention(torch.autograd.Function):
    """Forward and backward rings (module docstring). A hop sends k and v
    as one ``(2, B, T, H, D)`` buffer (one stack of the rank's own chunk;
    a chunk received is one already) and the key mask beside it."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, causal, flash):
        out, lse = ring_forward(q, k, v, kv_mask, group, causal, flash)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.group, ctx.causal, ctx.flash = group, causal, flash
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, s = ring_position(group)
        _, dq_tile, dkv_tile = _tiles(ctx.flash)
        g = g if g.stride(-1) == 1 else g.contiguous()
        di = fa.row_dot(g, out)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        masked = kv_mask is not None
        k_i, v_i, km = k, v, kv_mask
        kv = torch.stack([k, v]) if n > 1 else None
        kv_pending = acc_pending = acc = None
        for hop in range(n):
            if hop > 0:
                kv, km = _received(kv_pending, masked)
                k_i, v_i = kv[0], kv[1]
            if hop < n - 1:                    # the last k/v rotation is dead
                kv_pending = _rotate((kv, km), n, s, group)
            part = None
            if _visible(causal, hop, s):
                tile_causal = causal and hop == 0
                dq += dq_tile(q, k_i, v_i, g, lse, di, km, tile_causal).float()
                dk_b, dv_b = dkv_tile(q, k_i, v_i, g, lse, di, km, tile_causal)
                part = torch.stack([dk_b, dv_b]).float()
            if acc_pending is not None:      # the accumulators, one hop behind
                acc = acc_pending.wait()[0]
            if part is not None:
                acc = part if acc is None else acc + part
            if n > 1:
                acc_pending = _rotate((acc, None), n, s, group)
        if acc_pending is not None:
            acc = acc_pending.wait()[0]
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None)


def _ring(q, k, v, group, causal, kv_mask, flash) -> torch.Tensor:
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.float32).contiguous()
    q, k, v = fa._unit_last(q), fa._unit_last(k), fa._unit_last(v)
    return RingAttention.apply(q, k, v, kv_mask, group, causal, flash)


def ring_attention(q, k, v, *, group: Optional[dist.ProcessGroup] = None,
                   causal: bool = False, kv_mask=None) -> torch.Tensor:
    """``(B, T_local, H, D)`` q, k, v, this rank's chunks of a sequence
    split over the ring of ``group`` in rank order -> this rank's rows of
    exact attention over the whole sequence, with the plain tiles (module
    docstring). ``causal`` masks by global position; ``kv_mask``
    ``(B, T_local)`` is this rank's key mask and travels with its chunk."""
    return _ring(q, k, v, group, causal, kv_mask, flash=False)


def ring_flash_attention(q, k, v, *, group: Optional[dist.ProcessGroup] = None,
                         causal: bool = False, kv_mask=None) -> torch.Tensor:
    """``ring_attention`` with the flash kernels as its tiles: K4 a forward
    hop, K5 and K6 a backward hop on CUDA tensors (their plain versions on
    CPU tensors). The JAX ``block_q``, ``block_k`` and ``interpret`` have
    no counterpart (``ops/flash_attention.py::flash_attention``)."""
    return _ring(q, k, v, group, causal, kv_mask, flash=True)


def sequence_sharded_attention(q, k, v, *, group: Optional[dist.ProcessGroup] = None,
                               causal: bool = False, flash: bool = False) -> torch.Tensor:
    """Global ``(B, T, H, D)`` q, k, v (the same on every rank of the ring)
    -> this rank's ``(B, T / n, H, D)`` rows of their attention: each
    tensor sliced to the rank's chunk, then the ring."""
    n, s = ring_position(group)
    T = q.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} does not divide by the ring's {n} ranks")
    rows = slice(s * T // n, (s + 1) * T // n)
    ring = ring_flash_attention if flash else ring_attention
    return ring(q[:, rows], k[:, rows], v[:, rows], group=group, causal=causal)
