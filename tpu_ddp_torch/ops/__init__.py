"""The port's hand-written Hopper kernels, and their registry.

Counterpart of ``tpu_ddp/ops/__init__.py`` (``KERNELS`` :52,
``kernel_available`` :95). ``KERNELS`` maps a name to its wrapper, its plain
PyTorch version, its source and the ``_build`` library built from it, the
TPU kernel it replaces, the strategies whose step runs it (the analyzer's
labels, ``analysis/explain.py::run_strategy_label``) and, for a kernel a
switch turns on, what it fuses (``hint``); the callables are dotted
``module:attr`` strings that ``resolve`` imports on demand.

There is no fail-closed switch here: a wrapper given CUDA tensors launches
its kernel or raises. ``kernel_available`` only reports whether the build
loads. ``LAUNCHES`` counts the launches of each kernel, so that a run can
show its main path went through them. ``kernel_hints`` is the JAX
``kernel_hints`` (:98), the analyzer's "kernel candidates".
"""

from __future__ import annotations

import collections
import importlib

#: kernel name -> launches since the last ``reset_launch_counts``
LAUNCHES: collections.Counter = collections.Counter()

#: the analyzer's strategy labels: dp's layout variants, and the families
#: that shard compute
_DP_LABELS = ("dp", "zero1", "zero3", "grad_compress", "grad_compress_bf16")
_SHARDED_LABELS = ("sp", "fsdp", "tp", "fsdp_tp", "pp")

KERNELS = {
    "fused_update": {
        "wrapper": "tpu_ddp_torch.ops.fused_update:fused_update_",
        "plain": "tpu_ddp_torch.ops.fused_update:update_math",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/fused_update.cu",
        "library": "fused_update",
        "replaces": "tpu_ddp/ops/fused_update.py:165",
        "strategies": _DP_LABELS + _SHARDED_LABELS + ("ep",),
        "hint": ("optimizer update tail (clip + moments + param update "
                 "+ EMA) in one HBM pass over every leaf"),
    },
    # the three kernels of flash attention (tpu_ddp/ops/flash_attention.py)
    "flash_attention_fwd": {
        "wrapper": "tpu_ddp_torch.ops.flash_attention:flash_forward",
        "plain": "tpu_ddp_torch.ops.flash_attention:forward_plain",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/flash_forward.cu",
        "library": "flash_forward",
        "replaces": "tpu_ddp/ops/flash_attention.py:108",
        "strategies": _DP_LABELS + _SHARDED_LABELS,
        "hint": None,
    },
    "flash_attention_dq": {
        "wrapper": "tpu_ddp_torch.ops.flash_attention:flash_dq",
        "plain": "tpu_ddp_torch.ops.flash_attention:dq_plain",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/flash_attention.cu",
        "library": "flash_attention",
        "replaces": "tpu_ddp/ops/flash_attention.py:327",
        "strategies": _DP_LABELS + _SHARDED_LABELS,
        "hint": None,
    },
    "flash_attention_dkv": {
        "wrapper": "tpu_ddp_torch.ops.flash_attention:flash_dkv",
        "plain": "tpu_ddp_torch.ops.flash_attention:dkv_plain",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/flash_attention.cu",
        "library": "flash_attention",
        "replaces": "tpu_ddp/ops/flash_attention.py:366",
        "strategies": _DP_LABELS + _SHARDED_LABELS,
        "hint": None,
    },
    # their bfloat16 kernels (bf16 q, k, v and dO: the JAX kernels under
    # --compute-dtype bfloat16), in the same sources, all three on TMA, an
    # mbarrier ring and wgmma (csrc/flash_wg.cuh)
    "flash_attention_fwd_bf16": {
        "wrapper": "tpu_ddp_torch.ops.flash_attention:flash_forward",
        "plain": "tpu_ddp_torch.ops.flash_attention:forward_plain",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/flash_forward.cu",
        "library": "flash_forward",
        "replaces": "tpu_ddp/ops/flash_attention.py:108",
        "strategies": _DP_LABELS + _SHARDED_LABELS,
        "hint": None,
    },
    "flash_attention_dq_bf16": {
        "wrapper": "tpu_ddp_torch.ops.flash_attention:flash_dq",
        "plain": "tpu_ddp_torch.ops.flash_attention:dq_plain",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/flash_attention.cu",
        "library": "flash_attention",
        "replaces": "tpu_ddp/ops/flash_attention.py:327",
        "strategies": _DP_LABELS + _SHARDED_LABELS,
        "hint": None,
    },
    "flash_attention_dkv_bf16": {
        "wrapper": "tpu_ddp_torch.ops.flash_attention:flash_dkv",
        "plain": "tpu_ddp_torch.ops.flash_attention:dkv_plain",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/flash_attention.cu",
        "library": "flash_attention",
        "replaces": "tpu_ddp/ops/flash_attention.py:366",
        "strategies": _DP_LABELS + _SHARDED_LABELS,
        "hint": None,
    },
    # the int8 quantize and dequantize of the compressed gradient ring
    # (tpu_ddp/ops/fused_quant.py)
    "fused_quant": {
        "wrapper": "tpu_ddp_torch.ops.fused_quant:fused_quant",
        "plain": "tpu_ddp_torch.parallel.compression:quantize_chunk",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/fused_quant.cu",
        "library": "fused_quant",
        "replaces": "tpu_ddp/ops/fused_quant.py:58",
        "strategies": ("grad_compress", "sp"),
        "hint": "ring-hop block-scaled int8 quantize of every leaf in one pass",
    },
    "fused_dequant": {
        "wrapper": "tpu_ddp_torch.ops.fused_quant:fused_dequant",
        "plain": "tpu_ddp_torch.parallel.compression:dequantize_chunk",
        "route": "cuda",
        "source": "tpu_ddp_torch/ops/csrc/fused_quant.cu",
        "library": "fused_quant",
        "replaces": "tpu_ddp/ops/fused_quant.py:104",
        "strategies": ("grad_compress", "sp"),
        "hint": ("ring-hop int8 dequantize fused with the carry "
                 "accumulate (one read of each operand)"),
    },
}


def resolve(name: str) -> dict:
    """Registry entry with ``wrapper``/``plain`` resolved to callables."""
    entry = dict(KERNELS[name])
    for key in ("wrapper", "plain"):
        mod, _, attr = entry[key].partition(":")
        entry[key] = getattr(importlib.import_module(mod), attr)
    return entry


def kernel_available(name: str) -> bool:
    """Whether ``name``'s CUDA build compiles and loads here. A report
    only: no code path switches on it."""
    import torch

    from tpu_ddp_torch.ops import _build

    if not torch.cuda.is_available():
        return False
    try:
        _build.load(KERNELS[name]["library"])
    except (OSError, RuntimeError):
        return False
    return True


def kernel_hints(strategy: str) -> list:
    """"kernel candidate" annotations for ``analyze``: which switch-level
    kernels (those with a ``hint``; the flash kernels are model-level, as
    in JAX) apply to this strategy's step, whether their build loads here
    (``kernel_available``; no fallback: without it the plain version
    runs), and what they fuse. Sorted by name."""
    hints = []
    for name in sorted(KERNELS):
        entry = KERNELS[name]
        if entry["hint"] is None or strategy not in entry["strategies"]:
            continue
        available = kernel_available(name)
        hints.append({"kernel": name, "available": available,
                      "backend": "cuda" if available else None, "hint": entry["hint"]})
    return hints


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return {name: LAUNCHES[name] for name in KERNELS}


__all__ = ["KERNELS", "LAUNCHES", "resolve", "kernel_available", "kernel_hints",
           "reset_launch_counts", "launch_counts"]
