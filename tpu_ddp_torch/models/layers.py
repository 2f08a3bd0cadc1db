"""Flax's compute-dtype cast points on ``torch.nn`` layers.

A Flax layer built with ``dtype=jnp.bfloat16`` keeps its params float32
(``param_dtype``) and computes in bfloat16 (``tpu_ddp/cli/train.py:162-165``):

* ``nn.Dense`` and ``nn.Conv`` cast the input, the kernel and the bias to
  the compute dtype, take the product in it (float32 sums, one rounding)
  and then add the bias in it (a second rounding), as Flax's
  ``y = dot(x, W); y += b`` does;
* ``nn.LayerNorm`` takes its statistics and the normalisation in float32
  (``force_float32_reductions``, flax 0.12.3 ``linen/normalization.py:154-227``)
  and casts the result;
* ``nn.Embed`` casts the table, then gathers.

A ``Dense`` built for bfloat16 applies ``runtime.set_bfloat16_precision``
(cuBLAS sums a bf16 GEMM in float32, as XLA does), so every model that
computes in bfloat16 gets the policy however it is driven: the trainer, the
LM step or a direct call. The setting is process-wide, as the float32
policy's are, and touches only bf16 GEMMs.

These are Flax's cast points, not ``torch.autocast``'s policy (which keeps
LayerNorm's output float32 and runs some ops in float32 by name). In
float32 each layer here is its ``torch.nn`` parent, unchanged; parameter
names are the parent's, so ``checkpoint/convert.py`` maps them as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.runtime import set_bfloat16_precision

#: ``--compute-dtype`` names -> torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` as Flax ``nn.Dense``."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(n_in, n_out, bias=bias)
        self.compute_dtype = compute_dtype
        if compute_dtype == torch.bfloat16:
            set_bfloat16_precision()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` as Flax ``nn.Conv``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None, None]


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose bfloat16 form normalises in float32 and casts
    the result, as Flax ``nn.LayerNorm(dtype=...)``."""

    def __init__(self, dim: int, eps: float, compute_dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)
