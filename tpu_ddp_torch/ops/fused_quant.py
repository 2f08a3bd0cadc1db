"""K2 and K3: the block-scaled int8 quantize and dequantize(-accumulate)
of the compressed gradient ring.

Counterpart of ``tpu_ddp/ops/fused_quant.py`` (``fused_quant`` :69,
``fused_dequant`` :120). Each direction is one pass on the card
(``csrc/fused_quant.cu``) over a table of segments, so that one launch
serves every leaf of a ring hop (``parallel/collectives.py::FlatLayout``):
K2 reads the hop's chunk of every leaf once and writes the wire message
(every leaf's scales, then every leaf's int8 q) and, when asked, each
element's wire error; K3 reads a received message in place (one row, or the
all-gather's n rows at once) and, with ``add``, the ring's running sums, and
writes float32.

* ``segment_quant`` and ``segment_dequant`` are the ring's wrappers;
  ``fused_quant(x, block)`` and ``fused_dequant(...)`` of one chunk are the
  one-segment case of the same kernels (and the registry's names). All four
  count their launches in ``LAUNCHES`` (``fused_quant`` for K2,
  ``fused_dequant`` for K3). CUDA tensors launch the kernel, CPU tensors
  take the plain version, anything else raises.
* The plain versions are ``quantize_chunk`` and ``dequantize_chunk`` of
  ``parallel/compression.py`` (int8 mode), kept there once, and
  ``segment_quant_plain`` / ``segment_dequant_plain`` here, which run them
  leaf by leaf (in any wire mode: the ring's f32 and bf16 payloads are
  casts and take them too). The kernels follow them operation for
  operation, so on the card the two are bitwise equal, except for the int8
  bytes of a block whose scale is not finite (what a NaN converts to is
  implementation-defined): there the scale matches and every dequantized
  element, and every element of its error, is non-finite.
* There is no ``supports_block`` gate and no fallback to the reference:
  ``block % 128`` is a rule of the TPU's lanes, and the kernels serve every
  ``block >= 1``.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_ddp_torch.ops import LAUNCHES
from tpu_ddp_torch.parallel.compression import (
    _n_blocks,
    dequantize_chunk,
    quantize_chunk,
)

QUANT, DEQUANT = "fused_quant", "fused_dequant"
LIBRARY = "fused_quant"


def _device(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device.type


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _same_device(what: str, *tensors) -> None:
    if len({t.device for t in tensors if t is not None}) != 1:
        raise ValueError(f"{what}: operands lie on different devices")


def _launch_quant(x, table, nseg, size, nb, block, chunk, scale, q, err) -> None:
    from tpu_ddp_torch.ops import _build

    lib = _build.load(LIBRARY)
    rc = lib.tpu_ddp_fused_quant(_ptr(x), _ptr(table), nseg, size, nb, block, chunk,
                                 _ptr(scale), _ptr(q), _ptr(err), _stream(x))
    _build.check(lib, rc, "fused_quant launch")
    LAUNCHES[QUANT] += 1


def _launch_dequant(scale, q, row_bytes, rows, table, nseg, size, nb, block,
                    add, add_chunk, out, out_chunk, to_rows) -> None:
    from tpu_ddp_torch.ops import _build

    lib = _build.load(LIBRARY)
    rc = lib.tpu_ddp_fused_dequant(
        _ptr(scale), _ptr(q), row_bytes, rows, _ptr(table), nseg, size, nb, block,
        _ptr(add), add_chunk, _ptr(out), out_chunk, int(to_rows), _stream(out))
    _build.check(lib, rc, "fused_dequant launch")
    LAUNCHES[DEQUANT] += 1


# ---- one chunk: the one-segment case ------------------------------------


def fused_quant(x: torch.Tensor, block: int) -> dict:
    """``quantize_chunk(x, "int8", block)`` in one pass: 1-D f32 chunk ->
    ``{"q": int8 (nb*block,), "scale": f32 (nb,)}``."""
    if block < 1:
        raise ValueError(f"fused_quant: block must be >= 1, got {block}")
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"fused_quant: x must be a 1-D float32 chunk, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if _device(x, "fused_quant") == "cpu":
        return quantize_chunk(x, "int8", block)
    x = x.contiguous()
    size = x.shape[0]
    nb = _n_blocks(size, block)
    q = torch.empty(nb * block, dtype=torch.int8, device=x.device)
    scale = torch.empty(nb, dtype=torch.float32, device=x.device)
    if size:
        _launch_quant(x, None, 1, size, nb, block, 0, scale, q, None)
    return {"q": q, "scale": scale}


def fused_dequant(payload: dict, block: int, size: int, *,
                  add_to: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dequantize_chunk(payload, "int8", block, size)`` in one pass; with
    ``add_to``, the ring hop's ``add_to + dequant(payload)`` in the same
    pass (two roundings, as the plain version)."""
    q, scale = payload["q"], payload["scale"]
    nb = _n_blocks(size, block)
    if block < 1:
        raise ValueError(f"fused_dequant: block must be >= 1, got {block}")
    if (q.dtype != torch.int8 or q.numel() != nb * block
            or scale.dtype != torch.float32 or scale.numel() != nb):
        raise ValueError(
            f"fused_dequant: want int8 q of {nb * block} and float32 scale "
            f"of {nb} elements, got {q.dtype} {q.numel()} and "
            f"{scale.dtype} {scale.numel()}")
    if add_to is not None and (add_to.dtype != torch.float32
                               or add_to.shape != (size,)):
        raise ValueError(f"fused_dequant: add_to must be float32 ({size},), "
                         f"got {add_to.dtype} {tuple(add_to.shape)}")
    _same_device("fused_dequant", q, scale, add_to)
    if _device(q, "fused_dequant") == "cpu":
        d = dequantize_chunk(payload, "int8", block, size)
        return d if add_to is None else add_to + d
    q, scale = q.contiguous(), scale.contiguous()
    acc = add_to.contiguous() if add_to is not None else None
    out = torch.empty(size, dtype=torch.float32, device=q.device)
    if size:
        _launch_dequant(scale, q, 0, 1, None, 1, size, nb, block, acc, 0, out, 0, False)
    return out


# ---- every leaf of a ring hop: the segment form --------------------------


def segment_quant_plain(x: torch.Tensor, layout, chunk: int, mode: str = "int8",
                        err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``segment_quant``: ``quantize_chunk`` of chunk
    ``chunk`` of each leaf of the leaf-major ``x``, leaf by leaf, into one
    wire message (``layout.payload``); with ``err``, ``p -
    dequantize_chunk(quantize_chunk(p))`` at the same chunk of ``err``, as
    the JAX package's ring computes the error
    (``tpu_ddp/parallel/collectives.py:248``)."""
    msg = torch.empty(layout.msg_bytes(mode), dtype=torch.uint8, device=x.device)
    for i, views in enumerate(layout.payload(msg, mode)):
        p = layout.chunk(x, i, chunk)
        got = quantize_chunk(p, mode, layout.block)
        for key, view in views.items():
            view.copy_(got[key])
        if err is not None:
            layout.chunk(err, i, chunk).copy_(
                p - dequantize_chunk(got, mode, layout.block, p.numel()))
    return msg


def segment_dequant_plain(msg: torch.Tensor, layout, mode: str, out: torch.Tensor, *,
                          add: Optional[torch.Tensor] = None, add_chunk: int = 0,
                          out_chunk: int = 0, to_rows: bool = False) -> torch.Tensor:
    """The plain version of ``segment_dequant``: ``dequantize_chunk`` leaf
    by leaf, ``add``'s chunk ``add_chunk`` added after it when given, each
    message row r into chunk ``out_chunk + r`` of each leaf of the
    leaf-major ``out`` (``to_rows``: one row into the shard row ``out``,
    ``layout.rows``)."""
    rows = msg.view(-1, layout.msg_bytes(mode))
    for r in range(rows.shape[0]):
        row = rows[r]
        if row.storage_offset() % 4:
            row = row.clone()                  # a 4-byte-aligned copy for its scales
        for i, views in enumerate(layout.payload(row, mode)):
            d = dequantize_chunk(views, mode, layout.block, layout.shard[i])
            if add is not None:
                d = layout.chunk(add, i, add_chunk) + d
            if to_rows:
                dst = out[layout.rows.offsets[i]:layout.rows.offsets[i] + layout.shard[i]]
            else:
                dst = layout.chunk(out, i, out_chunk + r)
            dst.copy_(d)
    return out


def _check_flat(what: str, t: Optional[torch.Tensor], length: int) -> None:
    if t is not None and (t.dtype != torch.float32 or t.shape != (length,)
                          or not t.is_contiguous()):
        raise ValueError(f"{what}: want a contiguous float32 ({length},), got "
                         f"{t.dtype} {tuple(t.shape)}")


def segment_quant(x: torch.Tensor, layout, chunk: int, *,
                  err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 over every leaf of ``layout`` in one launch: chunk ``chunk`` of
    each leaf of the leaf-major float32 ``x`` -> one int8 wire message
    (uint8, ``layout.msg_bytes("int8")``); with ``err`` (leaf-major), each
    element's wire error ``x - q * scale`` at the same chunk."""
    _check_flat("segment_quant: x", x, layout.total)
    _check_flat("segment_quant: err", err, layout.total)
    if not 0 <= chunk < layout.n:
        raise ValueError(f"segment_quant: chunk {chunk} outside [0, {layout.n})")
    _same_device("segment_quant", x, err)
    if _device(x, "segment_quant") == "cpu":
        return segment_quant_plain(x, layout, chunk, "int8", err=err)
    msg = torch.empty(layout.msg_bytes("int8"), dtype=torch.uint8, device=x.device)
    scale = msg[:4 * layout.n_blocks].view(torch.float32)
    q = msg[4 * layout.n_blocks:].view(torch.int8)
    table = layout.table(x.device)
    if layout.n_blocks:
        _launch_quant(x, table, table.shape[0], 0, layout.n_blocks, layout.block,
                      chunk, scale, q, err)
    return msg


def segment_dequant(msg: torch.Tensor, layout, out: torch.Tensor, *,
                    add: Optional[torch.Tensor] = None, add_chunk: int = 0,
                    out_chunk: int = 0, to_rows: bool = False) -> torch.Tensor:
    """K3 over every leaf of ``layout`` in one launch, reading the int8
    message(s) ``msg`` in place, which must start 4-byte aligned:
    ``(msg_bytes,)`` or the all-gather's ``(n, msg_bytes)``, row r into
    chunk ``out_chunk + r`` of each leaf of the leaf-major float32 ``out``;
    ``to_rows`` (one row) writes each leaf's chunk into the shard row
    ``out`` (``layout.rows``) instead. With ``add``, chunk ``add_chunk`` of
    each leaf of the leaf-major ``add`` is added after the product (``add``
    may be ``out``). Returns ``out``."""
    size = layout.msg_bytes("int8")
    if msg.dtype != torch.uint8 or msg.numel() % max(size, 1) or not msg.is_contiguous():
        raise ValueError(f"segment_dequant: want contiguous uint8 rows of {size} "
                         f"bytes, got {msg.dtype} {tuple(msg.shape)}")
    if msg.data_ptr() % 4:
        raise ValueError("segment_dequant: the message must start 4-byte aligned "
                         "(its scales are read as floats)")
    rows = msg.numel() // size if size else 1
    if to_rows and rows != 1:
        raise ValueError("segment_dequant: to_rows takes one message row")
    if out_chunk < 0 or out_chunk + rows > layout.n or not 0 <= add_chunk < layout.n:
        raise ValueError(f"segment_dequant: chunks {out_chunk}+{rows} rows, "
                         f"{add_chunk} outside [0, {layout.n})")
    _check_flat("segment_dequant: out", out, layout.rows.width if to_rows else layout.total)
    _check_flat("segment_dequant: add", add, layout.total)
    _same_device("segment_dequant", msg, out, add)
    if _device(msg, "segment_dequant") == "cpu":
        return segment_dequant_plain(msg, layout, "int8", out, add=add,
                                     add_chunk=add_chunk, out_chunk=out_chunk,
                                     to_rows=to_rows)
    table, flat = layout.table(msg.device), msg.view(-1)
    if layout.n_blocks:
        _launch_dequant(flat, flat[4 * layout.n_blocks:], size, rows, table, table.shape[0],
                        0, layout.n_blocks, layout.block, add, add_chunk, out,
                        out_chunk, to_rows)
    return out
