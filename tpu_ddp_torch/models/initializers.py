"""Parameter initializers with the reference's torch semantics.

Counterpart of ``tpu_ddp/models/initializers.py``: kaiming-normal(relu) for
the ResBlock conv, torch's default ``Conv2d``/``Linear`` init (uniform in
``±1/sqrt(fan_in)`` for weight and bias) for ``conv1``/``fc1``/``fc2``, and
BatchNorm scale 0.5, bias 0. For the ViT, Flax's defaults: ``lecun_normal``
for Dense and Conv kernels, zero biases, ``normal(0.02)`` for ``pos_embed``
(LayerNorm keeps torch's scale 1, bias 0, which are Flax's too). Every draw
comes from the ``torch.Generator`` passed in, so a seed fixes the weights.
The bits differ from the JAX package's (another generator), so tests carry
weights across instead (``tpu_ddp_torch/checkpoint/convert.py``).
"""

from __future__ import annotations

import math

import torch


def fan_in(weight: torch.Tensor) -> int:
    """fan_in of a torch-layout weight: ``in * kh * kw`` for a conv
    ``(out, in, kh, kw)``, ``in`` for a linear ``(out, in)``."""
    return math.prod(weight.shape[1:])


@torch.no_grad()
def kaiming_normal_relu_(weight: torch.Tensor, generator: torch.Generator):
    """``std = sqrt(2 / fan_in)``, untruncated normal."""
    return weight.normal_(0.0, math.sqrt(2.0 / fan_in(weight)), generator=generator)


@torch.no_grad()
def torch_default_uniform_(t: torch.Tensor, fan: int, generator: torch.Generator):
    """``U(-1/sqrt(fan), 1/sqrt(fan))`` — torch's default weight and bias
    init (kaiming-uniform with ``a=sqrt(5)`` reduces to this bound)."""
    bound = 1.0 / math.sqrt(fan)
    return t.uniform_(-bound, bound, generator=generator)



# Flax's defaults, for the ViT (``flax.linen`` ``Dense``/``Conv``,
# ``LayerNorm`` and the ``pos_embed`` param of ``tpu_ddp/models/vit.py``).

#: stddev of a standard normal truncated to [-2, 2]: Flax's
#: ``variance_scaling(..., "truncated_normal")`` divides by it so the
#: truncated draw keeps the requested variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """``flax.linen.initializers.lecun_normal()``: a normal of variance
    ``1 / fan_in``, truncated at two stddevs and rescaled for the cut."""
    std = math.sqrt(1.0 / fan_in(weight)) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)
