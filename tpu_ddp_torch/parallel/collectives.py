"""Collectives of the data-parallel step: the compressed gradient ring, the
plain all-reduce, and ZeRO-1's reduce-scatter and all-gather.

Counterpart of ``tpu_ddp/parallel/collectives.py`` (``_quant`` :168,
``_dequant`` :182, ``ring_reduce_scatter`` :196, ``ring_all_reduce`` :272,
``sync_gradients`` :317). Where the JAX package names a mesh axis, the port
runs over the default ``torch.distributed`` process group; each rank is one
process.

Every call that moves bytes between ranks goes through one of four helpers
here (``exchange``, ``all_gather_bytes``, ``_all_reduce_flat``,
``reduce_scatter_sum``). Under the
``gloo`` backend, which sends no CUDA tensor point to point, they stage
CUDA tensors through pinned host buffers: copy to the host, send, receive,
copy back to the card. Only wire bytes take that route; every quantize,
dequantize and sum stays on the card. Under ``nccl`` the same calls carry
device tensors. A payload crosses the wire packed into one byte buffer
(``_pack``), one message a hop.

ZeRO-1 (``parallel/zero.py``) moves a step's gradients and params in one
collective each, not one a leaf: ``ChunkMajor`` lays every leaf's N chunks
out in one ``(N, W)`` buffer whose row r holds every leaf's r-th chunk in
leaf order, so one ``reduce_scatter_sum`` gives rank r its row of the sum
(the shards of all leaves) and one ``all_gather_bytes`` brings every row
back. Both backends take ``reduce_scatter_tensor``, gloo on the pinned host
copies.

Not ported yet: the telemetry hop hook (``_RING_HOP_HOOK``, ``_emit_hop``),
``prefetched_block_gather`` (ZeRO-3) and ``ring_shift`` (sequence
parallelism).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk
from tpu_ddp_torch.parallel.runtime import rank, world_size

#: byte alignment of every tensor inside a packed payload
_ALIGN = 16


def _staged(tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` crosses the wire through pinned host memory
    (module docstring)."""
    return tensor.is_cuda and dist.get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def exchange(buf: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``buf`` to rank ``dst`` and return the same-shaped buffer
    received from ``src`` (one ``batch_isend_irecv``)."""
    out = torch.empty_like(buf)
    send, recv = buf, out
    if _staged(buf):
        send = _to_host(buf)
        recv = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        torch.cuda.current_stream(buf.device).synchronize()
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst),
                                   dist.P2POp(dist.irecv, recv, src)])
    for req in reqs:
        req.wait()
    if recv is not out:
        out.copy_(recv, non_blocking=True)
    return out


def all_gather_bytes(buf: torch.Tensor) -> torch.Tensor:
    """``(n, len(buf))``: every rank's ``buf``, in rank order."""
    n = world_size()
    out = torch.empty(n * buf.numel(), dtype=buf.dtype, device=buf.device)
    if _staged(buf):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        send = _to_host(buf)
        torch.cuda.current_stream(buf.device).synchronize()
        dist.all_gather_into_tensor(host, send)
        out.copy_(host, non_blocking=True)
    else:
        dist.all_gather_into_tensor(out, buf)
    return out.view(n, buf.numel())


def _all_reduce_flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The SUM over the ranks of the concatenation of ``tensors``, with
    ONE all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if _staged(flat):
        host = _to_host(flat)
        torch.cuda.current_stream(flat.device).synchronize()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        flat.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return flat


def reduce_scatter_sum(x: torch.Tensor) -> torch.Tensor:
    """Rank r's ``(len(x) / n,)`` chunk of the SUM over the ranks of the
    1-D ``x``, cut into n equal chunks in rank order (one
    ``reduce_scatter_tensor``)."""
    n = world_size()
    out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    if _staged(x):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        send = _to_host(x)
        torch.cuda.current_stream(x.device).synchronize()
        dist.reduce_scatter_tensor(host, send, op=dist.ReduceOp.SUM)
        out.copy_(host, non_blocking=True)
    else:
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM)
    return out


class ChunkMajor:
    """Leaves of ``sizes`` elements over ``n`` ranks, each padded to a
    multiple of n and cut into n chunks of ``shard[i] = ceil(size / n)``,
    laid out chunk-major: row r of an ``(n, width)`` buffer holds every
    leaf's r-th chunk, leaf i's at columns ``[offsets[i], offsets[i] +
    shard[i])``. Offsets are multiples of ``align`` elements, so a chunk of
    a float32 buffer from the allocator starts on a 16-byte boundary."""

    def __init__(self, sizes: Sequence[int], n: int, align: int = 4):
        self.n, self.sizes = n, tuple(sizes)
        self.shard = tuple(-(-size // n) for size in self.sizes)
        offsets, width = [], 0
        for s in self.shard:
            offsets.append(width)
            width += -(-s // align) * align
        self.offsets, self.width = tuple(offsets), width

    def _rows(self, i: int):
        """(full rows, elements of the row after them) of leaf i."""
        s = self.shard[i]
        return (0, 0) if s == 0 else divmod(self.sizes[i], s)

    def pack_(self, rows: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
        """Copy each leaf into its chunks of ``rows`` ``(n, width)``; the
        pad and the gaps between leaves are left as they are."""
        for i, t in enumerate(tensors):
            x, off, s = t.reshape(-1), self.offsets[i], self.shard[i]
            full, rem = self._rows(i)
            if full:
                rows[:full, off:off + s].copy_(x[:full * s].view(full, s))
            if rem:
                rows[full, off:off + rem].copy_(x[full * s:])

    def unpack_(self, rows: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
        """The inverse of ``pack_``: each leaf from its chunks of ``rows``,
        the pad dropped. The leaves must be contiguous."""
        for i, t in enumerate(tensors):
            x, off, s = t.view(-1), self.offsets[i], self.shard[i]
            full, rem = self._rows(i)
            if full:
                x[:full * s].view(full, s).copy_(rows[:full, off:off + s])
            if rem:
                x[full * s:].copy_(rows[full, off:off + rem])

    def views(self, row: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's chunk in one ``(width,)`` row, as views."""
        return [row[off:off + s] for off, s in zip(self.offsets, self.shard)]


def _scatter_back(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each f32 tensor over the ranks, in place."""
    if not tensors:
        return
    _scatter_back(_all_reduce_flat(tensors), tensors)


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average each f32 tensor over the ranks, in place: the SUM, then a
    division by the rank count held as a 0-dim tensor (a true division on
    the card, as XLA's ``pmean``; ``ReduceOp.AVG`` is missing from older
    gloo builds)."""
    if not tensors:
        return
    flat = _all_reduce_flat(tensors)
    n = torch.full((), world_size(), dtype=flat.dtype, device=flat.device)
    _scatter_back(flat / n, tensors)


def sync_gradients(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Gradient all-reduce-mean over the ranks (``all_reduce_mean_``), in
    place; returns ``grads``."""
    all_reduce_mean_(list(grads.values()))
    return grads


# ---- payload packing -----------------------------------------------------


def _spec(payload: dict) -> List[Tuple[str, torch.Size, torch.dtype]]:
    # wider elements first: every view then starts at a multiple of its size
    return sorted(((k, t.shape, t.dtype) for k, t in payload.items()),
                  key=lambda s: -s[2].itemsize)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _pack(payload: dict) -> torch.Tensor:
    parts = []
    for key, _, _ in _spec(payload):
        b = payload[key].contiguous().reshape(-1).view(torch.uint8)
        pad = _aligned(b.numel()) - b.numel()
        parts.append(b)
        if pad:
            parts.append(b.new_zeros(pad))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, spec) -> dict:
    out, offset = {}, 0
    for key, shape, dtype in spec:
        nbytes = dtype.itemsize
        for d in shape:
            nbytes *= d
        out[key] = buf[offset: offset + nbytes].view(dtype).reshape(shape)
        offset += _aligned(nbytes)
    return out


# ---- the ring ------------------------------------------------------------


def _quant(p: torch.Tensor, mode: str, block: int, kernels: bool) -> dict:
    """One wire payload: K2 when the kernel switch is on (int8 only: f32
    and bf16 payloads are casts), else ``quantize_chunk``. Bit-identical by
    contract (``ops/fused_quant.py``)."""
    if kernels and mode == "int8":
        from tpu_ddp_torch.ops.fused_quant import fused_quant

        return fused_quant(p, block)
    return quantize_chunk(p, mode, block)


def _dequant(payload: dict, mode: str, block: int, size: int, kernels: bool,
             add_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Payload -> f32 chunk, optionally fused with the ring's carry
    accumulate (K3 in one pass instead of dequantize-then-add)."""
    if kernels and mode == "int8":
        from tpu_ddp_torch.ops.fused_quant import fused_dequant

        return fused_dequant(payload, block, size, add_to=add_to)
    d = dequantize_chunk(payload, mode, block, size)
    return d if add_to is None else add_to + d


def ring_reduce_scatter(x: torch.Tensor, *, mode: str = "f32",
                        block: int = 256, with_error: bool = False,
                        kernels: bool = False):
    """Ring reduce-scatter of a 1-D tensor, each hop's payload optionally
    quantized on the wire while accumulation stays f32 on the device.

    ``x``: this rank's tensor, its length divisible by the rank count N.
    Rank i returns the i-th of N equal chunks of the SUM over the ranks.
    The schedule is the JAX package's N-1-hop ring: rank i starts holding
    its local partial of chunk i-1; at every hop it sends its partial to
    rank i+1 (quantize -> wire -> dequantize), receives from rank i-1, and
    adds its own contribution to the chunk it received, so chunk c
    accumulates visiting c+1, c+2, ..., c, in the same order as the JAX
    ring (the f32 ring is bitwise the JAX ring).

    Returns ``(chunk, err)``: ``err`` (when ``with_error``) is the
    quantization error THIS rank introduced, a full-length f32 tensor with
    each hop's error at its chunk's offsets; None when not asked for,
    all-zero in f32 mode."""
    n = world_size()
    if x.shape[0] % n:
        raise ValueError(
            f"ring_reduce_scatter: length {x.shape[0]} not divisible by "
            f"the number of ranks {n}"
        )
    s = x.shape[0] // n
    if n == 1:
        return x, (torch.zeros_like(x) if with_error else None)
    chunks = x.reshape(n, s)
    idx = rank()
    p = chunks[(idx - 1) % n]
    err = torch.zeros_like(x) if with_error else None
    for step in range(n - 1):
        payload = _quant(p, mode, block, kernels)
        if with_error and mode != "f32":
            # the chunk being sent this hop is (idx - 1 - step) mod n
            c = (idx - 1 - step) % n
            err[c * s: (c + 1) * s] = p - _dequant(payload, mode, block, s, kernels)
        spec = _spec(payload)
        got = exchange(_pack(payload), (idx + 1) % n, (idx - 1) % n)
        nxt = chunks[(idx - 2 - step) % n]
        p = _dequant(_unpack(got, spec), mode, block, s, kernels, add_to=nxt)
    return p, err


def ring_all_reduce(x: torch.Tensor, *, mode: str = "f32",
                    block: int = 256, with_error: bool = False,
                    kernels: bool = False):
    """Ring all-reduce (SUM) with wire compression in both phases: the
    compressed ring reduce-scatter above, then each rank quantizes its
    reduced chunk ONCE and the payloads are all-gathered. Every rank (the
    owner too) dequantizes the same bytes, so the result is bit-identical
    across the ranks even in the lossy modes, which keeps the replicas'
    params equal.

    Returns ``(sum, err)`` with ``err`` as in ``ring_reduce_scatter`` plus
    the owner's all-gather-phase quantization error."""
    n = world_size()
    if n == 1:
        return x, (torch.zeros_like(x) if with_error else None)
    s = x.shape[0] // n
    chunk, err = ring_reduce_scatter(
        x, mode=mode, block=block, with_error=with_error,
        kernels=kernels)
    payload = _quant(chunk, mode, block, kernels)
    if with_error and mode != "f32":
        idx = rank()
        err[idx * s: (idx + 1) * s] = chunk - _dequant(payload, mode, block, s, kernels)
    spec = _spec(payload)
    gathered = all_gather_bytes(_pack(payload))
    rows = [_dequant(_unpack(gathered[i], spec), mode, block, s, kernels)
            for i in range(n)]
    return torch.cat(rows), err
