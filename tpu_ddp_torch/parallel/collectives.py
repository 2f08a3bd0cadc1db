"""Collectives of the data-parallel step: the compressed gradient ring, the
plain all-reduce, and ZeRO-1's reduce-scatter and all-gather.

Counterpart of ``tpu_ddp/parallel/collectives.py`` (``_quant`` :168,
``_dequant`` :182, ``ring_reduce_scatter`` :196, ``ring_all_reduce`` :272,
``sync_gradients`` :317). Where the JAX package names a mesh axis, the port
runs over a ``torch.distributed`` process group (the default one, or a group
of the rank grid: "Groups" below); each rank is one process.

Every call that moves bytes between ranks goes through one of five helpers
here (``post``, which ``exchange`` and ``exchange_async`` call,
``all_gather_bytes``, ``_all_reduce_flat``, ``reduce_scatter_sum``, and
``all_to_all``, which only the comms microbenchmark calls). Under the
``gloo`` backend, which sends no CUDA tensor point to point, they stage
CUDA tensors through pinned host buffers: copy to the host, send, receive,
copy back to the card. Only wire bytes take that route; every quantize,
dequantize and sum stays on the card. Under ``nccl`` the same calls carry
device tensors.

The compressed ring runs over all leaves of a step at once
(``FlatLayout``): the leaves sit one after another in one float32 buffer,
and each hop sends one wire message that carries the hop's chunk of every
leaf, quantized by one K2 launch and dequantized into the running sums by
one K3 launch (``ops/fused_quant.py``). Each leaf keeps its own chunks,
scale blocks and order of sums, so every leaf's result is bitwise that of
the JAX package's ring run on that leaf alone; only the number of launches
and messages differs (XLA fuses the JAX package's per-leaf loop under
``jit``; eager PyTorch would pay each launch and message from the host).
A step's ring makes n - 1 exchanges and, for the all-reduce, one
all-gather. ``ring_reduce_scatter`` and ``ring_all_reduce`` of one tensor
are its one-leaf case.

ZeRO-1 (``parallel/zero.py``) moves a step's gradients and params in one
collective each, not one a leaf: ``ChunkMajor`` lays every leaf's N chunks
out in one ``(N, W)`` buffer whose row r holds every leaf's r-th chunk in
leaf order, so one ``reduce_scatter_sum`` gives rank r its row of the sum
(the shards of all leaves) and one ``all_gather_bytes`` brings every row
back. Both backends take ``reduce_scatter_tensor``, gloo on the pinned host
copies. The compressed ring's reduce-scatter leaves its sum in the same row
layout (``FlatLayout.rows``).

ZeRO-3 (``parallel/zero.py::Zero3Partition``) gathers the params block by
block (``BlockGather``, the JAX ``prefetched_block_gather`` :99-145): one
all-gather a block of leaves, each block's shards in a chunk-major row of its
own, issued asynchronously, with block k+1's gather issued before block k is
first used, so at most two are in flight.

Sequence parallelism (``parallel/ring_attention.py``,
``parallel/sequence_parallel.py``) runs over a group of the rank grid
(``parallel/mesh.py``): ``exchange`` and ``exchange_async`` take a
``group`` and name their peers by their rank in it. ``exchange_async``
posts one ``batch_isend_irecv`` of several buffers and returns a handle
whose ``wait`` hands back what arrived: under NCCL the transfer runs beside
the compute stream, which waits for it only at ``wait``; under gloo the
CUDA buffers are staged through pinned host memory before the post, which
synchronises the stream, so nothing overlaps there. ``ring_shift`` (the JAX
``ring_shift`` :152) moves a tensor one or more places around a ring.
``group_sum`` and ``group_mean`` are the ring's ``psum`` and ``pmean`` with
a backward that applies the same collective to the gradient.

Groups. Every collective here takes an optional ``group`` (a
``torch.distributed`` process group; None: the default group) and then
runs over that group's ranks alone, each rank at its place in it
(``group_size``, ``group_rank``): the flat ring, ``reduce_scatter_sum``,
``all_gather_bytes``, the all-reduces and ``BlockGather``. That is what
runs ZeRO-1, ZeRO-3 and the compressed ring over the data axis of a rank
grid (``parallel/mesh.py``: the JAX package's ``axis=DATA_AXIS``), as
``--zero1`` and ``--grad-compress`` do under sequence parallelism and
``--parallelism fsdp`` does. With no group a call runs over every rank.

The hop hook (the JAX ``set_ring_hop_hook`` :35-60 and its call in the
ring :255-268 and :305-312): ``set_ring_hop_hook(hook)`` installs a
process-wide ``hook(probe, *, kind, dtype, axis, hop, n_hops, wire_bytes)``
(None clears it; the previous hook is returned), which the compressed
gradient ring calls once a hop on each rank: ``kind`` is
"ring-reduce-scatter" or "ring-all-reduce", ``dtype`` the wire's ("f32",
"bf16" or "s8"), ``hop`` counts from 1 to ``n_hops`` (the all-reduce's
gather phase is its last hop, n of n), ``wire_bytes`` the bytes a rank sent
(``chunk_wire_bytes`` summed over the leaves; n - 1 messages for the
gather phase), and ``probe`` the first element of the bare dequantized
chunk (the gather phase's: of the result), a 0-d tensor left on the device.
The probe is read from the received message itself (``_hop_probe``), so
K3's fused dequantize-and-add runs as it does without a hook and the
result is the same bit for bit. Ring attention's ring calls no hook, as
the JAX package emits hops from the gradient ring alone. The trainer's
``--comms-monitor`` installs ``comms/forensics.py``'s ``HopMonitor.on_hop``.

The recorder (``record_collectives``): while one is open, every collective
a helper here issues over more than one rank is booked, in program order,
as the JAX step anatomy inventories a compiled step's collectives
(``tpu_ddp/analysis/hlo.py``): its kind (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, and ``collective-permute`` for each
buffer a ``post`` sends, so ``exchange``, ``exchange_async`` and the ring's
hops too), its dtype as the JAX HLO names it (``f32``, ``bf16``, ``s8``...;
the ring's wire message, carried as bytes, books as its wire mode's dtype,
``s8`` for int8), its axis (the rank grid's name for the group,
``parallel/mesh.py::axis_of``), its group size, its payload bytes (the
all-gather's whole result, as JAX scales the operand by the group), the
group's ranks and the ranks of every group of its axis
(``parallel/mesh.py::axis_groups``: the set the JAX HLO's replica groups
list). A ZeRO-3 block gather (``BlockGather``) books its block's index and
whether the next block's gather was in flight when the block was first
used. ``analysis/anatomy.py`` builds the inventory from it, and
``analysis/lint.py`` its participation and prefetch checks. A collective
over one rank moves nothing and is not booked, as XLA elides it. The
drain's vote (``parallel/runtime.py::agree_any``) is not a step collective
and is not booked.

Gloo's host staging (``_to_host``: a CUDA tensor copied to pinned host
memory for the wire) is the transport, not the step: while it copies,
``on_wire()`` is true, so the lint's host-transfer rule, which books every
device-to-host copy inside a step, leaves it out, as XLA's collectives
never show as host transfers either.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_ddp_torch.parallel.runtime import rank, world_size


_RING_HOP_HOOK = None
#: the open recorder: (its list of calls, the default group's axis), or None
_RECORDER = None
#: how many wire stagings are copying now (``_to_host``; ``on_wire``)
_WIRE = [0]

#: ring wire mode -> the dtype token the hop's payload carries
_MODE_WIRE_DTYPE = {"f32": "f32", "bf16": "bf16", "int8": "s8"}


def set_ring_hop_hook(hook):
    """Install (or clear, with None) the process-wide ring hop hook
    (module docstring); returns the previous hook."""
    global _RING_HOP_HOOK
    prev = _RING_HOP_HOOK
    _RING_HOP_HOOK = hook
    return prev


def _emit_hop(probe: torch.Tensor, *, kind: str, mode: str, axis: str, hop: int,
              n_hops: int, wire_bytes: int) -> None:
    hook = _RING_HOP_HOOK       # read at call time: a cleared hook goes quiet
    if hook is not None:
        hook(probe, kind=kind, dtype=_MODE_WIRE_DTYPE.get(mode, mode), axis=axis,
             hop=hop, n_hops=n_hops, wire_bytes=int(wire_bytes))


#: torch dtype -> the dtype token the JAX HLO text uses
_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
              torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8",
              torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
              torch.bool: "pred"}


@contextlib.contextmanager
def record_collectives(world_axis: str = "data"):
    """Book every collective issued inside the ``with`` (module docstring)
    into the list it yields, one dict a call: ``kind``, ``dtype``,
    ``axis``, ``group_size``, ``payload_bytes``, ``ranks`` (the group's,
    global), ``groups`` (every group of its axis, global), ``src`` (this
    rank) and ``peer`` (a permute's destination, global; else None); a
    ZeRO-3 block gather also ``block`` and ``next_in_flight``.
    ``world_axis`` names the default group (None): ``data`` for dp."""
    global _RECORDER
    prev, calls = _RECORDER, []
    _RECORDER = (calls, world_axis)
    try:
        yield calls
    finally:
        _RECORDER = prev


def _book(kind: str, t: torch.Tensor, group, *, wire: Optional[str] = None,
          payload: Optional[int] = None, peer: Optional[int] = None,
          block: Optional[int] = None) -> Optional[dict]:
    """Book one collective into the open recorder, if any; returns its
    record (None when nothing is booked)."""
    rec = _RECORDER
    if rec is None:
        return None
    n = group_size(group)
    if n <= 1:
        return None
    from tpu_ddp_torch.parallel.mesh import axis_groups, axis_of

    call = {
        "kind": kind, "dtype": wire or _HLO_DTYPE.get(t.dtype, str(t.dtype)),
        "axis": axis_of(group, rec[1]), "group_size": n,
        "payload_bytes": int(t.numel() * t.element_size() if payload is None else payload),
        "ranks": group_ranks(group), "groups": axis_groups(group), "src": rank(),
        "peer": peer}
    if block is not None:
        call.update(block=block, next_in_flight=None)
    rec[0].append(call)
    return call


def on_wire() -> bool:
    """Whether a wire staging is copying a tensor to the host now (module
    docstring)."""
    return _WIRE[0] > 0


def _staged(tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` crosses the wire through pinned host memory
    (module docstring)."""
    return tensor.is_cuda and dist.get_backend() == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    _WIRE[0] += 1
    try:
        host.copy_(t, non_blocking=True)
    finally:
        _WIRE[0] -= 1
    return host


def group_ranks(group: Optional[dist.ProcessGroup] = None) -> List[int]:
    """The global ranks of ``group`` (None: the default group) in group
    order; ``[0]`` with no process group up."""
    if not dist.is_initialized():
        return [0]
    return dist.get_process_group_ranks(group or dist.group.WORLD)


def group_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """The ranks of ``group`` (None: the default group's, 1 with none up)."""
    return world_size() if group is None else dist.get_world_size(group)


def group_rank(group: Optional[dist.ProcessGroup] = None) -> int:
    """This rank's place in ``group`` (None: its rank in the default group)."""
    return rank() if group is None else dist.get_rank(group)


class Exchange:
    """An exchange in flight (``exchange_async``); ``wait`` returns the
    buffers received, in the order they were sent."""

    def __init__(self, reqs, outs, recvs):
        self._reqs, self._outs, self._recvs = reqs, outs, recvs

    def wait(self) -> List[torch.Tensor]:
        for req in self._reqs:
            req.wait()
        for out, recv in zip(self._outs, self._recvs):
            if recv is not out:
                out.copy_(recv, non_blocking=True)
        return self._outs


def post(sends: Sequence[Tuple[torch.Tensor, int, int]],
         recvs: Sequence[Tuple[torch.Tensor, int, int]],
         group: Optional[dist.ProcessGroup] = None, *,
         wire: Optional[str] = None) -> Exchange:
    """Post the sends ``(buf, dst, tag)`` and the receives ``(like, src,
    tag)`` (a buffer shaped as ``like`` from ``src``) as one
    ``batch_isend_irecv`` over ``group``'s ranks, either list possibly
    empty, and return the handle: ``wait`` hands back the buffers received,
    in ``recvs``' order. Under gloo, CUDA buffers are staged through pinned
    host memory (module docstring). The pipeline's hops
    (``parallel/pipeline.py``) post a send and a receive in each direction;
    ``exchange_async`` is the case of one peer each way. ``wire`` names
    the dtype the recorder books the sends as (the ring's message)."""
    ranks = group_ranks(group)
    for b, dst, _ in sends:
        _book("collective-permute", b, group, wire=wire, peer=ranks[dst])
    outs = [torch.empty_like(like) for like, _, _ in recvs]
    bufs = [b.contiguous() for b, _, _ in sends]
    wires = outs
    staged = [t for t in bufs + outs if _staged(t)]
    if staged:
        bufs = [_to_host(b) for b in bufs]
        wires = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs]
        torch.cuda.current_stream(staged[0].device).synchronize()
    ops = [dist.P2POp(dist.isend, b, ranks[dst], group, tag)
           for b, (_, dst, tag) in zip(bufs, sends)]
    ops += [dist.P2POp(dist.irecv, w, ranks[src], group, tag)
            for w, (_, src, tag) in zip(wires, recvs)]
    return Exchange(dist.batch_isend_irecv(ops) if ops else [], outs, wires)


def exchange_async(bufs: Sequence[torch.Tensor], dst: int, src: int,
                   group: Optional[dist.ProcessGroup] = None, *,
                   wire: Optional[str] = None) -> Exchange:
    """Post the sends of ``bufs`` to ``dst`` and the receives of
    same-shaped buffers from ``src`` (ranks in ``group``; None: the default
    group) as one ``batch_isend_irecv``, the i-th buffer under tag i, and
    return the handle (module docstring). The buffers must be contiguous."""
    return post([(b, dst, i) for i, b in enumerate(bufs)],
                [(b, src, i) for i, b in enumerate(bufs)], group, wire=wire)


def exchange(buf: torch.Tensor, dst: int, src: int,
             group: Optional[dist.ProcessGroup] = None, *,
             wire: Optional[str] = None) -> torch.Tensor:
    """Send ``buf`` to rank ``dst`` and return the same-shaped buffer
    received from ``src`` (ranks in ``group``; one ``batch_isend_irecv``)."""
    return exchange_async([buf], dst, src, group, wire=wire).wait()[0]


def ring_shift(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
               shift: int = 1) -> torch.Tensor:
    """``x`` moved ``shift`` places around the ring of ``group``: the rank
    at position i sends to ``(i + shift) % n`` and returns what it got from
    ``(i - shift) % n`` (the JAX ``ring_shift``); ``x`` itself on a ring of
    one. Outside autograd (the LM moves token ids with it)."""
    ranks = group_ranks(group)
    n = len(ranks)
    if n == 1:
        return x
    i = ranks.index(dist.get_rank())
    return exchange(x.contiguous(), (i + shift) % n, (i - shift) % n, group)


def all_gather_bytes(buf: torch.Tensor,
                     group: Optional[dist.ProcessGroup] = None, *,
                     wire: Optional[str] = None) -> torch.Tensor:
    """``(n, len(buf))``: every rank's ``buf``, in rank order (the n ranks
    of ``group``; None: all). ``wire`` as in ``post``."""
    n = group_size(group)
    _book("all-gather", buf, group, wire=wire, payload=n * buf.numel() * buf.element_size())
    out = torch.empty(n * buf.numel(), dtype=buf.dtype, device=buf.device)
    if _staged(buf):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        send = _to_host(buf)
        torch.cuda.current_stream(buf.device).synchronize()
        dist.all_gather_into_tensor(host, send, group=group)
        out.copy_(host, non_blocking=True)
    else:
        dist.all_gather_into_tensor(out, buf, group=group)
    return out.view(n, buf.numel())


def all_to_all(x: torch.Tensor,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The 1-D ``x`` cut into n equal chunks in rank order, chunk j sent to
    the rank at place j of ``group`` (None: all); returns the n chunks
    received, in the senders' order (one ``all_to_all_single``; the
    comms microbenchmark's all-to-all)."""
    _book("all-to-all", x, group)
    out = torch.empty_like(x)
    if _staged(x):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        send = _to_host(x)
        torch.cuda.current_stream(x.device).synchronize()
        dist.all_to_all_single(host, send, group=group)
        out.copy_(host, non_blocking=True)
    else:
        dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _all_reduce_flat(tensors: Sequence[torch.Tensor],
                     group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The SUM over the ranks of ``group`` (None: all) of the
    concatenation of ``tensors``, with ONE all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _book("all-reduce", flat, group)
    if _staged(flat):
        host = _to_host(flat)
        torch.cuda.current_stream(flat.device).synchronize()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        flat.copy_(host, non_blocking=True)
    else:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat


def reduce_scatter_sum(x: torch.Tensor,
                       group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Rank r's ``(len(x) / n,)`` chunk of the SUM over the n ranks of
    ``group`` (None: all) of the 1-D ``x``, cut into n equal chunks in rank
    order (one ``reduce_scatter_tensor``)."""
    n = group_size(group)
    _book("reduce-scatter", x, group)
    out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
    if _staged(x):
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        send = _to_host(x)
        torch.cuda.current_stream(x.device).synchronize()
        dist.reduce_scatter_tensor(host, send, op=dist.ReduceOp.SUM, group=group)
        out.copy_(host, non_blocking=True)
    else:
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class BlockGather:
    """The ZeRO-3 block gather on the prefetch schedule (the JAX
    ``prefetched_block_gather``, :99-145). ``flat`` is this rank's param
    row; block k's own row is ``flat[starts[k]:starts[k] + widths[k]]`` (a
    ``ChunkMajor`` row of the block's leaves), the blocks in the order the
    forward first uses them. ``wait(k)`` hands back the blocks it waited
    for, each with its ``(n, widths[j])`` gathered rows.

    Each block is ONE all-gather, launched asynchronously: under NCCL
    ``all_gather_into_tensor(..., async_op=True)``, whose wait makes the
    compute stream wait on it; under gloo with CUDA tensors the row goes to
    pinned host memory first (``_staged``; the whole ``flat`` row in one
    copy and one synchronisation, as no step writes it before its update),
    the collective runs async on the host copies and the result is copied
    back to the card at the wait. With ``prefetch`` (the product schedule)
    ``start`` issues block 0 and ``wait(k)`` issues block k+1 before it
    waits for block k, so block k+1's gather is in flight under block k's
    compute and no more than two gathers are ever outstanding; without it,
    ``wait(k)`` issues block k and waits for it at once (the JAX serialized
    schedule). ``wait(k)`` waits, in order, for every block up to k not yet
    waited for; for a block waited for already (a tied block entered
    again, a recompute under remat) it returns nothing."""

    def __init__(self, flat: torch.Tensor, starts: Sequence[int],
                 widths: Sequence[int], n: int, prefetch: bool = True,
                 group: Optional[dist.ProcessGroup] = None):
        self.flat, self.n, self.prefetch, self.group = flat, n, prefetch, group
        self.starts, self.widths = list(starts), list(widths)
        self.issued = self.waited = 0    # blocks issued, waited for (prefixes)
        self._work: Dict[int, tuple] = {}
        self._host: Optional[torch.Tensor] = None
        self._booked: Dict[int, dict] = {}   # the recorder's record of each gather

    def start(self) -> None:
        if self.prefetch and self.widths:
            self._issue(0)

    def _row(self, buf: torch.Tensor, k: int) -> torch.Tensor:
        return buf[self.starts[k]:self.starts[k] + self.widths[k]]

    def _issue(self, k: int) -> None:
        row = self._row(self.flat, k)
        self.issued = k + 1
        if self.n == 1:
            self._work[k] = (row.view(1, -1), None, None)
            return
        out = torch.empty(self.n * row.numel(), dtype=row.dtype, device=row.device)
        call = _book("all-gather", row, self.group, payload=out.numel() * out.element_size(),
                     block=k)
        if call is not None:
            self._booked[k] = call
        if _staged(row):
            if self._host is None:
                self._host = _to_host(self.flat)
                torch.cuda.current_stream(row.device).synchronize()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            work = dist.all_gather_into_tensor(host, self._row(self._host, k),
                                               group=self.group, async_op=True)
            self._work[k] = (out, host, work)
        else:
            self._work[k] = (out, None, dist.all_gather_into_tensor(
                out, row, group=self.group, async_op=True))

    def _finish(self, k: int) -> torch.Tensor:
        out, host, work = self._work.pop(k)
        if work is not None:
            work.wait()
        if host is not None:
            out.copy_(host, non_blocking=True)
        return out.view(self.n, -1)

    def wait(self, k: int) -> List[Tuple[int, torch.Tensor]]:
        done = []
        while self.waited <= k:
            j = self.waited
            last = min(j + 1 if self.prefetch else j, len(self.widths) - 1)
            while self.issued <= last:
                self._issue(self.issued)
            if j in self._booked:     # block j's first use: is j+1's gather out?
                self._booked.pop(j)["next_in_flight"] = (
                    self.issued > j + 1 or j == len(self.widths) - 1)
            done.append((j, self._finish(j)))
            self.waited = j + 1
        return done

    def outstanding(self) -> int:
        """Gathers issued and not yet waited for."""
        return len(self._work)


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

    def leaves(self, rows: torch.Tensor, align: int = 128) -> List[torch.Tensor]:
        """``unpack_`` into new storage: each leaf from its chunks of
        ``rows`` ``(n, width)``, as a ``(size,)`` view of one new buffer
        that holds the padded leaves one after another, each starting on a
        multiple of ``align`` elements (512 bytes in float32, where the
        allocator would put a tensor of its own, so the libraries that read
        a leaf see the alignment they would), filled by one multi-tensor
        copy (one allocation, not one a leaf)."""
        padded = [self.n * s for s in self.shard]
        starts, total = [], 0
        for p in padded:
            starts.append(total)
            total += -(-p // align) * align
        buf = torch.empty(total, dtype=rows.dtype, device=rows.device)
        torch._foreach_copy_(
            [buf[o:o + p].view(self.n, s) for o, p, s in zip(starts, padded, self.shard)],
            [rows[:, off:off + s] for off, s in zip(self.offsets, self.shard)])
        return [buf[o:o + size] for o, size in zip(starts, self.sizes)]


def _scatter_back(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view(t.shape))
        offset += t.numel()


def all_reduce_sum_(tensors: Sequence[torch.Tensor],
                    group: Optional[dist.ProcessGroup] = None) -> None:
    """Sum each f32 tensor over the ranks (of ``group``; None: all), in
    place."""
    if not tensors:
        return
    _scatter_back(_all_reduce_flat(tensors, group), tensors)


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Optional[dist.ProcessGroup] = None) -> None:
    """Average each f32 tensor over the ranks (of ``group``; None: all), in
    place: the SUM, then a division by the rank count held as a 0-dim
    tensor (a true division on the card, as XLA's ``pmean``;
    ``ReduceOp.AVG`` is missing from older gloo builds)."""
    if not tensors:
        return
    flat = _all_reduce_flat(tensors, group)
    n = torch.full((), group_size(group), dtype=flat.dtype, device=flat.device)
    _scatter_back(flat / n, tensors)


class _GroupAllReduce(torch.autograd.Function):
    """The sum (``mean``: the mean) over the ranks of ``group``, whose
    backward is the same collective on the gradient (the JAX ``psum`` and
    ``pmean`` of jax 0.4, whose transposes are themselves)."""

    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        return _group_reduce(x, group, mean)

    @staticmethod
    def backward(ctx, g):
        return _group_reduce(g, ctx.group, ctx.mean), None, None


def _group_reduce(x: torch.Tensor, group, mean: bool) -> torch.Tensor:
    n = len(group_ranks(group))
    if n == 1:
        return x.clone()
    out = _all_reduce_flat([x], group).view(x.shape)
    return out / torch.full((), n, dtype=out.dtype, device=out.device) if mean else out


def group_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``; the backward sums the
    gradient over them too."""
    return _GroupAllReduce.apply(x, group, False)


def group_mean(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``x`` averaged over the ranks of ``group`` (the sum, then a division
    by a 0-dim tensor, as ``all_reduce_mean_``); the backward averages the
    gradient over them too."""
    return _GroupAllReduce.apply(x, group, True)


def rank_mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """``total``, a sum over ``n`` ranks, divided by ``n`` as
    ``all_reduce_mean_`` divides (by a 0-dim tensor); ``total`` itself at
    one rank."""
    return total if n == 1 else total / torch.full_like(total, n)


def sync_gradients(grads: Dict[str, torch.Tensor],
                   group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """Gradient all-reduce-mean over the ranks (of ``group``; None: all;
    ``all_reduce_mean_``), in place; returns ``grads``."""
    all_reduce_mean_(list(grads.values()), group)
    return grads


# ---- the flat ring -------------------------------------------------------


def _prefix(values) -> Tuple[int, ...]:
    """Exclusive prefix sums: the start of each of ``values`` laid end to end."""
    out, total = [], 0
    for v in values:
        out.append(total)
        total += v
    return tuple(out)


class FlatLayout:
    """The ring's layout of a step's leaves over ``n`` ranks: leaves of
    ``padded`` elements (each a multiple of n) one after another in one
    float32 buffer, leaf-major. Leaf i starts at ``offsets[i]``; its chunk
    c is ``[offsets[i] + c * shard[i], offsets[i] + (c + 1) * shard[i])``.

    A hop's wire message carries one chunk of every leaf. In int8 it holds
    first every leaf's scales (4 bytes a scale block, leaf i's from
    ``first_block[i]`` on), then every leaf's q (``block`` bytes a scale
    block). The scale blocks restart at each leaf's chunk, as
    ``quantize_chunk`` of that chunk alone would cut them. In f32 and bf16
    the message holds the chunks one after another (leaf i's at
    ``hop_offsets[i]``). Either way its bytes are the sum over the leaves of
    ``chunk_wire_bytes``. ``rows`` is the shard layout (``ChunkMajor``):
    where the reduce-scatter leaves one rank's chunk of every leaf."""

    def __init__(self, padded: Sequence[int], n: int, block: int):
        if any(p % n for p in padded):
            raise ValueError(f"FlatLayout: leaf lengths {tuple(padded)} are not "
                             f"all multiples of {n}")
        self.n, self.block, self.padded = n, block, tuple(padded)
        self.shard = tuple(p // n for p in self.padded)
        self.offsets, self.total = _prefix(self.padded), sum(self.padded)
        self.hop_offsets, self.hop_size = _prefix(self.shard), sum(self.shard)
        blocks = [-(-s // block) for s in self.shard]
        self.first_block, self.n_blocks = _prefix(blocks), sum(blocks)
        self.rows = ChunkMajor(self.padded, n)
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def msg_bytes(self, mode: str) -> int:
        """Bytes of one hop's wire message in ``mode``."""
        if mode == "int8":
            return self.n_blocks * (4 + self.block)
        return self.hop_size * (4 if mode == "f32" else 2)

    def leaves(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf of the leaf-major ``flat``, as ``(padded,)`` views."""
        return [flat[o:o + p] for o, p in zip(self.offsets, self.padded)]

    def chunk(self, flat: torch.Tensor, i: int, c: int) -> torch.Tensor:
        """Chunk c of leaf i of the leaf-major ``flat``, as a view."""
        start = self.offsets[i] + c * self.shard[i]
        return flat[start:start + self.shard[i]]

    def chunks(self, flat: torch.Tensor, c: int) -> List[torch.Tensor]:
        """Chunk c of every leaf of the leaf-major ``flat``, as views."""
        return [self.chunk(flat, i, c) for i in range(len(self.shard))]

    def payload(self, msg: torch.Tensor, mode: str) -> List[dict]:
        """Each leaf's payload (``quantize_chunk``'s keys) as views of one
        uint8 message that starts 4-byte aligned."""
        if mode == "int8":
            scales = msg[:4 * self.n_blocks].view(torch.float32)
            qs = msg[4 * self.n_blocks:].view(torch.int8)
            ends = self.first_block[1:] + (self.n_blocks,)
            return [{"q": qs[b0 * self.block:b1 * self.block], "scale": scales[b0:b1]}
                    for b0, b1 in zip(self.first_block, ends)]
        values = msg.view(torch.float32 if mode == "f32" else torch.bfloat16)
        return [{"q": values[o:o + s]} for o, s in zip(self.hop_offsets, self.shard)]

    def table(self, device: torch.device) -> torch.Tensor:
        """K2/K3's segment table on ``device``: one int64 row a leaf of
        (offset, chunk length, first scale block, offset in ``rows``),
        uploaded once a device."""
        table = self._tables.get(device)
        if table is None:
            table = torch.tensor(
                list(zip(self.offsets, self.shard, self.first_block, self.rows.offsets)),
                dtype=torch.int64).reshape(-1, 4).to(device)
            self._tables[device] = table
        return table


def _cast_hop(x: torch.Tensor, layout: FlatLayout, chunk: int, mode: str,
              err: Optional[torch.Tensor]) -> torch.Tensor:
    """The f32 and bf16 wire message: chunk ``chunk`` of every leaf of the
    leaf-major ``x`` in one ``torch.cat``, then one cast (f32: none). With
    ``err``, each element's wire error ``p - float(cast(p))`` goes to the
    same chunk of ``err`` (one multi-tensor copy). Elementwise, so bitwise
    ``quantize_chunk`` leaf by leaf."""
    p = torch.cat(layout.chunks(x, chunk))
    q = p if mode == "f32" else p.to(torch.bfloat16)
    if err is not None:
        torch._foreach_copy_(layout.chunks(err, chunk),
                             (p - q.to(torch.float32)).split(layout.shard))
    return q.view(torch.uint8)


def _uncast_hop(msg: torch.Tensor, layout: FlatLayout, mode: str, out: torch.Tensor, *,
                add: Optional[torch.Tensor] = None, add_chunk: int = 0,
                out_chunk: int = 0, to_rows: bool = False) -> torch.Tensor:
    """A received f32 or bf16 message (or the all-gather's rows) -> float32
    into ``out``: one cast of all rows, then one multi-tensor add of
    ``add``'s chunk ``add_chunk`` when given and one multi-tensor copy (the
    keywords as ``ops/fused_quant.py::segment_dequant``'s)."""
    values = msg.view(-1).view(torch.float32 if mode == "f32" else torch.bfloat16)
    rows = values.view(-1, layout.hop_size).to(torch.float32)
    src = [d for row in rows for d in row.split(layout.shard)]
    if add is not None:
        src = torch._foreach_add(layout.chunks(add, add_chunk) * rows.shape[0], src)
    if to_rows:
        dst = layout.rows.views(out)
    else:
        dst = [d for r in range(rows.shape[0]) for d in layout.chunks(out, out_chunk + r)]
    torch._foreach_copy_(dst, src)
    return out


def _quant_hop(x: torch.Tensor, layout: FlatLayout, chunk: int, mode: str,
               kernels: bool, err: Optional[torch.Tensor]) -> torch.Tensor:
    """Chunk ``chunk`` of every leaf of the leaf-major ``x`` -> one uint8
    wire message: in int8 K2 in one launch when the kernel switch is on,
    else ``quantize_chunk`` leaf by leaf; f32 and bf16 are a cast
    (``_cast_hop``). With ``err``, each element's wire error goes to the
    same chunk of ``err``. Bit-identical by contract
    (``ops/fused_quant.py``)."""
    from tpu_ddp_torch.ops import fused_quant as fq

    if mode != "int8":
        return _cast_hop(x, layout, chunk, mode, err)
    if kernels:
        return fq.segment_quant(x, layout, chunk, err=err)
    return fq.segment_quant_plain(x, layout, chunk, mode, err=err)


def _dequant_hop(msg: torch.Tensor, layout: FlatLayout, mode: str, kernels: bool,
                 out: torch.Tensor, **where) -> torch.Tensor:
    """A received message (or the all-gather's rows) -> float32 into
    ``out``, optionally accumulated: in int8 K3 in one launch, or
    ``dequantize_chunk`` leaf by leaf; f32 and bf16 a cast
    (``_uncast_hop``; ``where`` as ``ops/fused_quant.py::segment_dequant``)."""
    from tpu_ddp_torch.ops import fused_quant as fq

    if mode != "int8":
        return _uncast_hop(msg, layout, mode, out, **where)
    if kernels:
        return fq.segment_dequant(msg, layout, out, **where)
    return fq.segment_dequant_plain(msg, layout, mode, out, **where)


def _hop_probe(msg: torch.Tensor, layout: FlatLayout, mode: str) -> torch.Tensor:
    """The first element of the received ``msg``'s bare dequantized chunk of
    leaf 0, as ``dequantize_chunk`` (and K3 without its add) computes it:
    ``q[0] * scale[0]`` in int8, ``q[0]`` as float32 otherwise. A 0-d
    tensor on ``msg``'s device."""
    p = layout.payload(msg, mode)[0]
    q = p["q"][0].to(torch.float32)
    return q * p["scale"][0] if mode == "int8" else q


def _reduce_scatter_hops(x: torch.Tensor, layout: FlatLayout, mode: str,
                         kernels: bool, err: Optional[torch.Tensor],
                         row: Optional[torch.Tensor] = None,
                         group: Optional[dist.ProcessGroup] = None, *,
                         kind: str = "ring-reduce-scatter", total_hops: int = 0,
                         axis: str = "data") -> torch.Tensor:
    """The N-1 hops of the ring over every leaf of the leaf-major ``x`` at
    once, one message a hop. Hop ``step`` sends chunk ``(idx - 1 - step)
    mod n`` of every leaf and adds the received one to this rank's own
    chunk ``(idx - 2 - step) mod n``, so chunk c accumulates visiting c+1,
    c+2, ..., c: each leaf's sums in the order of the JAX package's
    per-leaf ring. The running sums go to a new leaf-major ``acc`` (``x``
    is only read); the last hop's, this rank's chunk of every leaf, to
    ``row`` (the shard layout) when given, else to ``acc``. The ranks and
    places are ``group``'s (None: all). Each hop calls the hop hook when
    one is installed (module docstring; ``kind``, ``total_hops`` and
    ``axis`` are its keywords). Returns ``acc``."""
    n, idx = group_size(group), group_rank(group)
    acc = torch.empty_like(x)
    src = x
    for step in range(n - 1):
        msg = _quant_hop(src, layout, (idx - 1 - step) % n, mode, kernels, err)
        got = exchange(msg, (idx + 1) % n, (idx - 1) % n, group,
                       wire=_MODE_WIRE_DTYPE[mode])
        c = (idx - 2 - step) % n
        last = row is not None and step == n - 2
        out = row if last else acc
        if _RING_HOP_HOOK is not None:
            _emit_hop(_hop_probe(got, layout, mode), kind=kind, mode=mode, axis=axis,
                      hop=step + 1, n_hops=total_hops or n - 1,
                      wire_bytes=layout.msg_bytes(mode))
        _dequant_hop(got, layout, mode, kernels, out,
                     add=x, add_chunk=c, out_chunk=c, to_rows=last)
        src = acc
    return acc


def ring_reduce_scatter_flat(x: torch.Tensor, layout: FlatLayout, *,
                             mode: str = "f32", with_error: bool = False,
                             kernels: bool = False,
                             out: Optional[torch.Tensor] = None,
                             group: Optional[dist.ProcessGroup] = None):
    """Ring reduce-scatter of every leaf of the leaf-major 1-D ``x``
    (``layout``) at once, each hop's payload optionally quantized on the
    wire while accumulation stays f32 on the device.

    Returns ``(row, err)``. ``row`` holds this rank's chunk of every leaf
    of the SUM over the ranks, in the shard layout ``layout.rows``: ``out``
    when given (its gaps between leaves are not written), else a new zero
    row. ``err`` (when ``with_error``) is the quantization error THIS rank
    introduced, leaf-major, each hop's error at its chunk; zero at this
    rank's own chunk of every leaf, and everywhere in f32 mode. The ranks
    are ``group``'s (None: all)."""
    err = torch.zeros_like(x) if with_error else None
    if out is None:
        out = torch.zeros(layout.rows.width, dtype=x.dtype, device=x.device)
    if group_size(group) == 1:
        torch._foreach_copy_(layout.rows.views(out), layout.leaves(x))
        return out, err
    _reduce_scatter_hops(x, layout, mode, kernels, err if mode != "f32" else None, out,
                         group)
    return out, err


def ring_all_reduce_flat(x: torch.Tensor, layout: FlatLayout, *, mode: str = "f32",
                         with_error: bool = False, kernels: bool = False,
                         group: Optional[dist.ProcessGroup] = None):
    """Ring all-reduce (SUM) of every leaf of the leaf-major 1-D ``x`` at
    once, with wire compression in both phases: the reduce-scatter hops
    above, then each rank quantizes its reduced chunk of every leaf ONCE
    and the messages are all-gathered (one collective). Every rank (the
    owner too) dequantizes the same bytes, all n rows in one pass, so the
    result is bit-identical across the ranks even in the lossy modes, which
    keeps the replicas' params equal.

    Returns ``(sum, err)``, both leaf-major; ``err`` as in
    ``ring_reduce_scatter_flat`` plus the owner's all-gather-phase
    quantization error at its own chunk. The ranks are ``group``'s (None:
    all)."""
    n = group_size(group)
    if n == 1:
        return x, (torch.zeros_like(x) if with_error else None)
    lossy = with_error and mode != "f32"
    # lossy: the n - 1 hops and the gather phase write every chunk's error
    err = (torch.empty_like(x) if lossy else
           torch.zeros_like(x) if with_error else None)
    e = err if lossy else None
    acc = _reduce_scatter_hops(x, layout, mode, kernels, e, group=group,
                               kind="ring-all-reduce", total_hops=n)
    msg = _quant_hop(acc, layout, group_rank(group), mode, kernels, e)
    out = torch.empty_like(x)
    _dequant_hop(all_gather_bytes(msg, group, wire=_MODE_WIRE_DTYPE[mode]), layout, mode,
                 kernels, out)
    if _RING_HOP_HOOK is not None:
        # the gather phase is the ring's last hop (n of n): each rank
        # receives the other n - 1 ranks' messages
        _emit_hop(out[0].clone(), kind="ring-all-reduce", mode=mode, axis="data", hop=n,
                  n_hops=n, wire_bytes=(n - 1) * layout.msg_bytes(mode))
    return out, err


def _one_leaf(x: torch.Tensor, block: int) -> FlatLayout:
    n = world_size()
    if x.shape[0] % n:
        raise ValueError(
            f"ring_reduce_scatter: length {x.shape[0]} not divisible by "
            f"the number of ranks {n}"
        )
    return FlatLayout([x.shape[0]], n, block)


def ring_reduce_scatter(x: torch.Tensor, *, mode: str = "f32",
                        block: int = 256, with_error: bool = False,
                        kernels: bool = False):
    """Ring reduce-scatter of one 1-D tensor: the one-leaf case of
    ``ring_reduce_scatter_flat``.

    ``x``: this rank's tensor, its length divisible by the rank count N.
    Rank i returns the i-th of N equal chunks of the SUM over the ranks.
    The schedule is the JAX package's N-1-hop ring: rank i starts holding
    its local partial of chunk i-1; at every hop it sends its partial to
    rank i+1 (quantize -> wire -> dequantize), receives from rank i-1, and
    adds its own contribution to the chunk it received (the f32 ring is
    bitwise the JAX ring).

    Returns ``(chunk, err)``: ``err`` (when ``with_error``) is the
    quantization error THIS rank introduced, a full-length f32 tensor with
    each hop's error at its chunk's offsets; None when not asked for,
    all-zero in f32 mode."""
    layout = _one_leaf(x, block)
    if layout.n == 1:
        return x, (torch.zeros_like(x) if with_error else None)
    row, err = ring_reduce_scatter_flat(x.contiguous(), layout, mode=mode,
                                        with_error=with_error, kernels=kernels)
    return row[:layout.shard[0]], err


def ring_all_reduce(x: torch.Tensor, *, mode: str = "f32",
                    block: int = 256, with_error: bool = False,
                    kernels: bool = False):
    """Ring all-reduce (SUM) of one 1-D tensor: the one-leaf case of
    ``ring_all_reduce_flat``. Returns ``(sum, err)`` with ``err`` as in
    ``ring_reduce_scatter`` plus the owner's all-gather-phase quantization
    error."""
    layout = _one_leaf(x, block)
    return ring_all_reduce_flat(x.contiguous(), layout, mode=mode,
                                with_error=with_error, kernels=kernels)
