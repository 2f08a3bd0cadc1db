"""Quantized gradient collectives: block-scaled wire compression for the
data-parallel gradient sync (``--grad-compress``).

Counterpart of ``tpu_ddp/parallel/compression.py``. Only the WIRE is
compressed:

- **block-scaled int8**: each ``block`` consecutive elements share one f32
  scale (max-abs / 127); the payload is 1 byte an element plus 4 bytes a
  block;
- **bf16**: a cast, 2 bytes an element, no scales;
- **f32**: the identity payload, the parity anchor of the ring schedule.

Accumulation stays f32 on the device in every mode (each ring hop
dequantizes before it adds), so compression error enters only where bytes
cross the wire, once a hop.

Error feedback (``--grad-compress-error-feedback``): every rank keeps a
residual holding the quantization error IT introduced, and adds it back
into its local gradient the next step, so the error telescopes instead of
accumulating. The residual is one f32 ``(padded,)`` tensor per leaf on each
rank (views of one buffer, the ring's layout): that rank's row of the JAX
package's ``(n_shards, padded)`` layout.

Non-finite sentinels survive compression by construction: a NaN or Inf in
a block drives the block's max-abs scale non-finite, and dequantization
multiplies by the raw scale, so the whole block dequantizes non-finite.

``quantize_chunk`` and ``dequantize_chunk`` in int8 mode are the plain
versions of the CUDA kernels K2 and K3 (``ops/fused_quant.py``). Both divide
by a 0-dim tensor on the data's device and never by a Python scalar:
PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
while XLA and the kernels divide.

A checkpoint of several ranks holds every rank's residual row
(``residual_rows``), whose sum in rank order is the JAX layout, the
residual in param layout summed over the ranks (``deshard_residual``,
``desharded_rows``); one rank's holds that sum alone. ``shard_residual``
lays either out again for this run's rank count. Not ported: the mesh form of ``init_residual`` and
``varying``, a jax-version shim (the port differentiates the local loss and
syncs explicitly).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

#: Wire modes the config surface accepts ("none" = feature off).
MODES = ("none", "bf16", "int8")

#: Modes the compressor itself implements ("f32" is the test/parity
#: anchor: same ring schedule, identity payload).
RING_MODES = ("f32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class GradCompression:
    """Static wire-compression configuration.

    ``mode``: ring payload dtype ("int8" block-scaled / "bf16" cast / "f32"
    identity). ``block``: elements per int8 scale block. ``error_feedback``:
    carry the per-rank residual and add it back next step. ``kernels``:
    send the int8 payload ops through the CUDA kernels K2 and K3
    (``ops/fused_quant.py``, bit-identical wire bytes and residuals)."""

    mode: str = "int8"
    block: int = 256
    error_feedback: bool = False
    kernels: bool = False

    def __post_init__(self):
        if self.mode not in RING_MODES:
            raise ValueError(
                f"unknown grad-compress mode {self.mode!r}; valid ring "
                f"modes: {', '.join(RING_MODES)}"
            )
        if self.block < 1:
            raise ValueError(
                f"grad_compress_block must be >= 1, got {self.block}"
            )


# ---- block-scaled payloads -----------------------------------------------


def _n_blocks(size: int, block: int) -> int:
    return -(-size // block)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``like``'s device (module
    docstring: true division on the card)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_chunk(x: torch.Tensor, mode: str, block: int) -> dict:
    """1-D f32 chunk -> wire payload dict. int8 payloads are padded up to
    a whole number of blocks (the pad quantizes to exact zeros); ``scale``
    holds one f32 per block. NaN/Inf inputs drive the block scale
    non-finite on purpose (module docstring)."""
    if mode == "f32":
        return {"q": x}
    if mode == "bf16":
        return {"q": x.to(torch.bfloat16)}
    size = x.shape[0]
    nb = _n_blocks(size, block)
    pad = nb * block - size
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xb = x.reshape(nb, block)
    scale = torch.amax(torch.abs(xb), dim=1) / _scalar(127.0, x)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe[:, None]), -127, 127).to(torch.int8)
    return {"q": q.reshape(-1), "scale": scale}


def dequantize_chunk(payload: dict, mode: str, block: int,
                     size: int) -> torch.Tensor:
    """Inverse of ``quantize_chunk``: payload -> f32 ``(size,)``. Multiplies
    by the RAW scale (not the zero-guarded one) so non-finite blocks
    dequantize non-finite."""
    if mode == "f32":
        return payload["q"]
    if mode == "bf16":
        return payload["q"].to(torch.float32)
    nb = _n_blocks(size, block)
    xb = payload["q"].reshape(nb, block).to(torch.float32)
    return (xb * payload["scale"][:, None]).reshape(-1)[:size]


def chunk_wire_bytes(size: int, mode: str, block: int) -> int:
    """Static bytes-on-wire for one chunk payload (q + scales)."""
    if mode == "f32":
        return size * 4
    if mode == "bf16":
        return size * 2
    nb = _n_blocks(size, block)
    return nb * block * 1 + nb * 4


# ---- flat update space ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Slot:
    shape: tuple
    size: int
    padded: int


def _leaf_slot(leaf, n_shards: int) -> _Slot:
    shape = tuple(leaf.shape)
    size = 1
    for d in shape:
        size *= d
    return _Slot(shape=shape, size=size, padded=size + ((-size) % n_shards))


def _flat_leaf(x: torch.Tensor, slot: _Slot) -> torch.Tensor:
    x = x.reshape(-1)
    if slot.padded != slot.size:
        x = torch.cat([x, x.new_zeros(slot.padded - slot.size)])
    return x


def _unflat_leaf(x: torch.Tensor, slot: _Slot) -> torch.Tensor:
    return x[: slot.size].reshape(slot.shape)


Tree = Dict[str, torch.Tensor]


class GradCompressor:
    """Static layout and entry points for one model over the ranks.

    Each param leaf flattens to 1-D, zero-padded to a multiple of
    ``n_shards``; the ring collectives then cut each leaf into ``n_shards``
    chunks and quantize every hop's payload. The port keeps all padded
    leaves one after another in one buffer (``layout``, a
    ``collectives.FlatLayout``) and runs ONE ring a step over all of them:
    one wire message and one K2 and one K3 launch a hop, not one a leaf,
    with every leaf's result bitwise that of its own ring. The residual is
    one such buffer too, handed out as per-leaf views. ``params_template``
    maps leaf names to anything with a ``shape``; ``n_shards`` is the number
    of ranks, those of ``group`` (None: the default group; on a rank grid
    the data group, where the ring's input, its output and the residual
    are then the same on every rank of the other axes: the JAX "residual
    scattered over data, replicated over sequence")."""

    def __init__(self, config: GradCompression, params_template,
                 n_shards: int, group=None):
        from tpu_ddp_torch.parallel.collectives import FlatLayout

        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.config = config
        self.n_shards = n_shards
        self.group = group
        self.kernels = bool(config.kernels)
        self.slots = {name: _leaf_slot(leaf, n_shards)
                      for name, leaf in params_template.items()}
        self.names = list(self.slots)
        self.layout = FlatLayout([s.padded for s in self.slots.values()],
                                 n_shards, config.block)
        self._pad: Dict[torch.device, torch.Tensor] = {}

    def accounting(self) -> dict:
        """Static per-step per-rank wire-byte accounting (the JAX
        ``GradCompressor.accounting``, key for key): what the ring moves in
        this mode against the same ring in f32. ``all_reduce`` covers the
        replicated sync (the n - 1 reduce-scatter hops and the all-gather
        phase's n - 1 chunks), ``reduce_scatter`` the ZeRO composition (the
        params' all-gather is not the ring's)."""
        n = self.n_shards
        mode, block = self.config.mode, self.config.block
        rs_wire = rs_base = 0
        for slot in self.slots.values():
            chunk = slot.padded // n
            rs_wire += (n - 1) * chunk_wire_bytes(chunk, mode, block)
            rs_base += (n - 1) * chunk * 4
        return {
            "mode": mode,
            "block": block,
            "n_shards": n,
            "error_feedback": self.config.error_feedback,
            "all_reduce_bytes_on_wire_per_device": int(2 * rs_wire),
            "all_reduce_bytes_f32_per_device": int(2 * rs_base),
            "reduce_scatter_bytes_on_wire_per_device": int(rs_wire),
            "reduce_scatter_bytes_f32_per_device": int(rs_base),
            "compression_ratio": (round(2 * rs_base / (2 * rs_wire), 2)
                                  if rs_wire else None),
        }

    # ---- flat update space ----------------------------------------------

    def _flat(self, tree: Tree) -> torch.Tensor:
        """Original-shaped leaves -> one leaf-major buffer of the padded
        leaves (one ``torch.cat``; the pads are slices of one cached zero
        tensor a device)."""
        device = tree[self.names[0]].device
        zeros = self._pad.get(device)
        if zeros is None:
            zeros = torch.zeros(self.n_shards, dtype=torch.float32, device=device)
            self._pad[device] = zeros
        parts = []
        for name, slot in self.slots.items():
            parts.append(tree[name].reshape(-1))
            if slot.padded != slot.size:
                parts.append(zeros[:slot.padded - slot.size])
        return torch.cat(parts)

    def _joined(self, flat_tree: Tree) -> torch.Tensor:
        """Per-leaf ``(padded,)`` tensors -> one leaf-major buffer: the one
        they are views of when they are this layout's views of one buffer
        (``flatten``, ``init_residual`` and ``err_state`` hand out such
        views), else one ``torch.cat``."""
        leaves = [flat_tree[name] for name in self.names]
        base = leaves[0]._base
        if (base is not None and base.dtype == torch.float32
                and base.shape == (self.layout.total,)
                and all(t._base is base and t.shape == (p,) and t.storage_offset() == o
                        for t, o, p in zip(leaves, self.layout.offsets,
                                           self.layout.padded))):
            return base
        return torch.cat([t.reshape(-1) for t in leaves])

    def _tree(self, flat: torch.Tensor) -> Tree:
        return dict(zip(self.names, self.layout.leaves(flat)))

    def flatten(self, tree: Tree) -> Tree:
        """Original-shaped leaves -> per-leaf ``(padded,)``, as views of one
        leaf-major buffer."""
        return self._tree(self._flat(tree))

    def unflatten(self, flat_tree: Tree) -> Tree:
        return {n: _unflat_leaf(x, self.slots[n]) for n, x in flat_tree.items()}

    def init_residual(self, device) -> Tree:
        """This rank's all-zero residual, one f32 ``(padded,)`` per leaf (views
        of one leaf-major buffer)."""
        return self._tree(torch.zeros(self.layout.total, dtype=torch.float32,
                                      device=device))

    # ---- the residual's checkpoint layout -------------------------------

    def residual_rows(self, residual: Tree) -> torch.Tensor:
        """``(n_shards, layout.total)``: every rank's leaf-major residual, in
        rank order (one all-gather; a collective, every rank calls it)."""
        from tpu_ddp_torch.parallel.collectives import all_gather_bytes

        flat = self._joined(residual)
        return (all_gather_bytes(flat, self.group) if self.n_shards > 1
                else flat.view(1, -1))

    def deshard_residual(self, residual: Tree,
                         rows: Optional[torch.Tensor] = None) -> Tree:
        """This rank's residual -> the PARAM-layout tree checkpoints hold:
        the ranks' residuals summed in rank order, unpadded and reshaped (the
        JAX ``deshard_residual``). The sum is what error feedback carries:
        each rank adds its own residual into its gradient before the ring
        sums them. A collective unless ``rows`` (``residual_rows``'s result)
        is given."""
        rows = self.residual_rows(residual) if rows is None else rows
        total = rows[0].clone()
        for row in rows[1:]:
            total += row
        return self.unflatten(self._tree(total))

    def desharded_rows(self, rows: torch.Tensor) -> Tree:
        """``residual_rows``'s result, cut at any rank count -> the
        PARAM-layout sum ``deshard_residual`` gives, through the layout of
        the rows' own rank count. No collective."""
        n = rows.shape[0]
        at = self if n == self.n_shards else GradCompressor(
            self.config, {name: torch.empty(slot.shape, device="meta")
                          for name, slot in self.slots.items()}, n, self.group)
        if rows.shape[1] != at.layout.total:
            raise ValueError(
                f"the checkpoint's residual rows are {tuple(rows.shape)}, not "
                f"({n}, {at.layout.total}): another model or --grad-compress-block")
        return at.deshard_residual(None, rows)

    @torch.no_grad()
    def shard_residual(self, param_tree: Optional[Tree], out: Optional[Tree] = None,
                       rows: Optional[torch.Tensor] = None,
                       rank: Optional[int] = None) -> Tree:
        """A PARAM-layout residual -> this rank's, written into ``out`` (the
        views ``init_residual`` made, so the ring keeps reading one buffer in
        place; a fresh ``init_residual`` when None): the whole carried error
        on rank 0, zeros on the others (the JAX ``shard_residual``), which
        conserves the sum across a change of rank count. ``rows`` (a
        checkpoint's ``residual_rows``) cut at this rank count and layout
        gives each rank its own row back instead: the quantized ring is not
        linear in its inputs, so only that makes a resume at the same rank
        count bitwise the uninterrupted run. Rows cut at another rank count
        stand for their sum when ``param_tree`` is None. ``rank`` defaults
        to this process's place in ``group``. No collective."""
        from tpu_ddp_torch.parallel.collectives import group_rank

        rank = group_rank(self.group) if rank is None else rank
        own_rows = rows is not None and tuple(rows.shape) == (self.n_shards,
                                                              self.layout.total)
        if param_tree is None and not own_rows:
            param_tree = self.desharded_rows(rows)
        if out is None:
            device = (rows if own_rows else next(iter(param_tree.values()))).device
            out = self.init_residual(device)
        if own_rows:
            for view, saved in zip((out[n] for n in self.names),
                                   self.layout.leaves(rows[rank])):
                view.copy_(saved)
            return out
        for name, slot in self.slots.items():
            out[name].zero_()
            if rank == 0:
                out[name][:slot.size].copy_(param_tree[name].reshape(-1))
        return out

    # ---- collectives ----------------------------------------------------

    def _with_residual(self, x: torch.Tensor, residual: Optional[Tree]) -> torch.Tensor:
        return x if residual is None else x + self._joined(residual)

    def _n(self, like: torch.Tensor) -> torch.Tensor:
        return _scalar(self.n_shards, like)

    def all_reduce_mean(self, grads: Tree, residual: Optional[Tree] = None,
                        with_error: bool = False):
        """Local grads -> grads AVERAGED over the ranks, through the
        compressed ring all-reduce over all leaves at once. Returns
        ``(grads, err_state)``; ``err_state`` (when ``with_error``) is this
        rank's new residual, one ``(padded,)`` leaf per param; pass it back
        as ``residual`` next step for error feedback."""
        from tpu_ddp_torch.parallel.collectives import ring_all_reduce_flat

        x = self._with_residual(self._flat(grads), residual)
        out, err = ring_all_reduce_flat(
            x, self.layout, mode=self.config.mode, with_error=with_error,
            kernels=self.kernels, group=self.group)
        out = out / self._n(out)
        return (self.unflatten(self._tree(out)),
                self._tree(err) if with_error else None)

    def reduce_scatter_mean_flat(self, flat: Tree, residual: Optional[Tree] = None,
                                 with_error: bool = False,
                                 out: Optional[torch.Tensor] = None):
        """Flattened (padded 1-D) leaves -> this rank's 1/N slice of each
        leaf of the averaged gradient, through the compressed ring over all
        leaves at once. The slices are views of one row of the shard layout
        (``layout.rows``): ``out`` when given (ZeRO-1's gradient row, whose
        gaps between leaves are left as they are)."""
        from tpu_ddp_torch.parallel.collectives import ring_reduce_scatter_flat

        row, err = ring_reduce_scatter_flat(
            self._with_residual(self._joined(flat), residual), self.layout,
            mode=self.config.mode, with_error=with_error,
            kernels=self.kernels, out=out, group=self.group)
        torch.div(row, self._n(row), out=row)
        shards = dict(zip(self.names, self.layout.rows.views(row)))
        return shards, (self._tree(err) if with_error else None)

    def local_error_sq(self, err_state: Tree) -> torch.Tensor:
        """This rank's sum of squares of the freshly introduced quantization
        error: one pass over the buffer ``err_state``'s leaves are views of
        (the ring's error output), float32."""
        flat = self._joined(err_state)
        return torch.sum(torch.square(flat.to(torch.float32)))

    def error_sq(self, err_state: Tree) -> torch.Tensor:
        """``local_error_sq`` summed over the ranks (every rank gets the same
        number): the JAX ``error_sq``, behind the flight recorder's
        ``compress_error_norm``. The train step folds the local sum into
        its one all-reduce instead (``train/steps.py``)."""
        from tpu_ddp_torch.parallel.collectives import all_reduce_sum_

        total = self.local_error_sq(err_state)
        all_reduce_sum_([total], self.group)
        return total

    # ---- accounting -----------------------------------------------------

    def accounting(self) -> dict:
        """Static per-step per-rank wire bytes: what the ring moves in this
        mode against the same ring in f32. ``all_reduce`` covers the
        plain-DP sync (reduce-scatter and all-gather phases);
        ``reduce_scatter`` the ZeRO-1 composition."""
        n = self.n_shards
        mode, block = self.config.mode, self.config.block
        rs_wire = rs_base = ag_wire = ag_base = 0
        for slot in self.slots.values():
            chunk = slot.padded // n
            # RS phase: n-1 hops, one chunk payload a hop a rank; AG phase
            # (all-reduce only): n-1 chunk payloads a rank.
            rs_wire += (n - 1) * chunk_wire_bytes(chunk, mode, block)
            rs_base += (n - 1) * chunk * 4
            ag_wire += (n - 1) * chunk_wire_bytes(chunk, mode, block)
            ag_base += (n - 1) * chunk * 4
        return {
            "mode": mode,
            "block": block,
            "n_shards": n,
            "error_feedback": self.config.error_feedback,
            "all_reduce_bytes_on_wire_per_device": int(rs_wire + ag_wire),
            "all_reduce_bytes_f32_per_device": int(rs_base + ag_base),
            "reduce_scatter_bytes_on_wire_per_device": int(rs_wire),
            "reduce_scatter_bytes_f32_per_device": int(rs_base),
            "compression_ratio": (
                round((rs_base + ag_base) / (rs_wire + ag_wire), 2)
                if rs_wire + ag_wire else None
            ),
        }


def wire_bytes_table(params_template, n_shards: int, *,
                     block: int = 256) -> dict:
    """Static per-step wire-bytes table across every mode x {plain DP,
    ZeRO-1 reduce-scatter}. Pure accounting; no devices."""
    table: dict = {"n_shards": n_shards, "block": block, "modes": {}}
    for mode in RING_MODES:
        comp = GradCompressor(
            GradCompression(mode=mode, block=block),
            params_template, n_shards,
        )
        acct = comp.accounting()
        table["modes"][mode] = {
            "dp_all_reduce_bytes_per_device": (
                acct["all_reduce_bytes_on_wire_per_device"]),
            "zero1_reduce_scatter_bytes_per_device": (
                acct["reduce_scatter_bytes_on_wire_per_device"]),
        }
    f32 = table["modes"]["f32"]
    for mode, row in table["modes"].items():
        row["dp_ratio_vs_f32"] = round(
            f32["dp_all_reduce_bytes_per_device"]
            / row["dp_all_reduce_bytes_per_device"], 2)
        row["zero1_ratio_vs_f32"] = round(
            f32["zero1_reduce_scatter_bytes_per_device"]
            / row["zero1_reduce_scatter_bytes_per_device"], 2)
    return table
