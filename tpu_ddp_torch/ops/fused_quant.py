"""K2 and K3: the block-scaled int8 quantize and dequantize(-accumulate)
of the compressed gradient ring.

Counterpart of ``tpu_ddp/ops/fused_quant.py`` (``fused_quant`` :69,
``fused_dequant`` :120). Each direction is one pass on the card
(``csrc/fused_quant.cu``): K2 reads the f32 chunk once and writes the int8
payload and one f32 scale a block; K3 reads the payload (and, with
``add_to``, the ring's running sum) once and writes the f32 chunk.

* The plain versions are ``quantize_chunk`` and ``dequantize_chunk`` of
  ``parallel/compression.py`` (int8 mode), kept there once. The kernels
  follow them operation for operation, so on the card the two are bitwise
  equal, except for the int8 bytes of a block whose scale is not finite
  (what a NaN converts to is implementation-defined): there the scale
  matches and every dequantized element is non-finite.
* ``fused_quant`` and ``fused_dequant`` are the wrappers: CUDA tensors
  launch the kernel (and add one to ``LAUNCHES``), CPU tensors take the
  plain version, anything else raises. A strided input is made contiguous
  first.
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
    from tpu_ddp_torch.ops import _build

    x = x.contiguous()
    size = x.shape[0]
    nb = _n_blocks(size, block)
    q = torch.empty(nb * block, dtype=torch.int8, device=x.device)
    scale = torch.empty(nb, dtype=torch.float32, device=x.device)
    if size:
        lib = _build.load(LIBRARY)
        rc = lib.tpu_ddp_fused_quant(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                     size, block, _stream(x))
        _build.check(lib, rc, "fused_quant launch")
        LAUNCHES[QUANT] += 1
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
    operands = [q, scale] + ([add_to] if add_to is not None else [])
    if len({t.device for t in operands}) != 1:
        raise ValueError("fused_dequant: operands lie on different devices")
    if _device(q, "fused_dequant") == "cpu":
        d = dequantize_chunk(payload, "int8", block, size)
        return d if add_to is None else add_to + d
    from tpu_ddp_torch.ops import _build

    q, scale = q.contiguous(), scale.contiguous()
    acc = add_to.contiguous() if add_to is not None else None
    out = torch.empty(size, dtype=torch.float32, device=q.device)
    if size:
        lib = _build.load(LIBRARY)
        rc = lib.tpu_ddp_fused_dequant(
            q.data_ptr(), scale.data_ptr(),
            acc.data_ptr() if acc is not None else None, out.data_ptr(),
            size, block, _stream(q))
        _build.check(lib, rc, "fused_dequant launch")
        LAUNCHES[DEQUANT] += 1
    return out
