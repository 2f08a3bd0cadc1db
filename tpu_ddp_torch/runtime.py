"""Device selection and the float32 precision policy.

Counterpart of ``tpu_ddp/parallel/runtime.py`` (``is_tpu_device``,
``device_count``) for one process on one device. The port runs on the GPU
unless the caller asks for the CPU; it never falls back silently.

Precision policy. float32: cuDNN runs float32 convolutions in TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), which keeps about
three decimal digits and would make the card's float32 numbers a different
computation from the JAX reference's. ``set_float32_precision`` turns TF32
off for both cuDNN and cuBLAS and pins the float32 matmul precision to
"highest". bfloat16 (``--compute-dtype bfloat16``): XLA sums a bf16 dot in
float32 and rounds the result once; cuBLAS may instead reduce a bf16 GEMM's
split-K partial sums in bf16
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
True by default), a rounding per partial sum that the reference does not
make. ``set_bfloat16_precision`` turns that off, so a bf16 product is
float32 sums rounded once, as in the JAX package; it leaves the float32
policy as it is.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (the default) demands a GPU and raises without one;
    ``"cpu"`` is taken only when asked for."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"unknown device {name!r}; expected one of {DEVICES}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible to PyTorch "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda}). "
            "Run on a GPU machine, or pass --device cpu explicitly."
        )
    return torch.device("cuda", torch.cuda.current_device())


def set_float32_precision() -> None:
    """Apply the float32 precision policy (module docstring)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def set_bfloat16_precision() -> None:
    """Apply the bfloat16 precision policy (module docstring)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def device_name(device: torch.device) -> str:
    """Human-readable name of ``device``, for result records."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def synchronize(device: torch.device) -> None:
    """Wait for all queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
