"""NetResDeep — the reference's flagship model as ``torch.nn`` modules.

Counterpart of ``tpu_ddp/models/resnet.py`` (``ResBlock`` :39,
``NetResDeep`` :78). Module and parameter names follow the Flax tree
(``conv1``, ``resblock`` or ``resblock_<i>``, ``conv``, ``batch_norm``,
``fc1``, ``fc2``) so the converter maps one to the other by path.

* **Layout.** The public input is NHWC ``(N, 32, 32, 3)``, as the JAX
  model's. ``conv1`` gets it as an NCHW view (``permute``), whose memory
  stays channels-last, so cuDNN picks its channels-last kernels.
* **Flatten.** The JAX model flattens NHWC, in ``(h, w, c)`` order
  (``resnet.py:131``). This port flattens channels-last too, so ``fc1``'s
  weight is the Flax kernel transposed, with no row permutation.
* **BatchNorm.** Flax normalises with, and stores as its running variance,
  the *biased* batch variance in fast form ``E[x²] − E[x]²`` clipped at 0;
  ``torch.nn.BatchNorm2d`` stores the unbiased one. ``BatchNorm`` below is
  therefore written out in plain torch ops: running value
  ``0.9 * running + (1 - 0.9) * batch`` (torch momentum 0.1), eps 1e-5.
* **Sync BN.** ``bn_cross_replica_axis`` (the JAX ``resnet.py`` :50, :70;
  ``--sync-bn``, wired by ``Trainer`` as the JAX trainer's :552-566 wires
  it) makes every BatchNorm take its batch statistics over all the ranks of
  the default process group, as Flax's ``axis_name`` does: the stacked
  ``(2, C)`` local ``[E[x], E[x²]]`` goes through one all-reduce-mean a
  call (``sync_stats``), and the variance is formed from the averaged pair.
  The backward of that all-reduce-mean is the all-reduce-mean of the
  cotangent, which is what JAX's transpose of ``pmean`` gives inside the
  ``dp`` step's ``shard_map``. The running buffers move with the synced
  statistics. At one rank nothing is sent, and the arithmetic is that of
  the unsynced model.
* **Tied blocks.** With ``tied=True`` one ``ResBlock`` is applied
  ``n_blocks`` times (the reference's list-repeat quirk): 76,074 params, and
  the shared BatchNorm's running stats move ``n_blocks`` times per forward.
* **Compute dtype.** ``dtype`` (:45-136) float32 or bfloat16, at Flax's cast
  points (``models/layers.py``): the convs and Dense layers compute in it;
  BatchNorm takes its batch statistics and normalises in float32, keeps its
  running buffers float32 and returns ``dtype``, as Flax's does
  (``force_float32_reductions``); params stay float32, logits are float32.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.models.initializers import kaiming_normal_relu_, torch_default_uniform_
from tpu_ddp_torch.models.layers import Conv2d, Dense


#: sync-BN all-reduces since the last clear: "forward" (the statistics) and
#: "backward" (their cotangents)
SYNC_BN_COLLECTIVES: collections.Counter = collections.Counter()


class _SyncMean(torch.autograd.Function):
    """The mean over the ranks (of ``group``; None: all), whose backward is
    the mean over the ranks of the cotangent (module docstring)."""

    @staticmethod
    def forward(ctx, stats: torch.Tensor, group) -> torch.Tensor:
        from tpu_ddp_torch.parallel.collectives import all_reduce_mean_

        ctx.group = group
        out = stats.clone()
        all_reduce_mean_([out], group)
        SYNC_BN_COLLECTIVES["forward"] += 1
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        from tpu_ddp_torch.parallel.collectives import all_reduce_mean_

        out = grad.contiguous().clone()
        all_reduce_mean_([out], ctx.group)
        SYNC_BN_COLLECTIVES["backward"] += 1
        return out, None


def sync_stats(stats: torch.Tensor, group=None) -> torch.Tensor:
    """``stats`` averaged over the ranks of ``group`` (None: the default
    process group), one all-reduce forward and one backward; ``stats``
    itself at one rank."""
    from tpu_ddp_torch.parallel.collectives import group_size

    return _SyncMean.apply(stats, group) if group_size(group) > 1 else stats


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW input,
    with Flax's biased fast-form variance in both the normalisation and the
    running buffer. ``scale_init`` is the scale's constant initial value:
    NetResDeep's 0.5 by default; the ResNet family's 1.0, and 0.0 for the
    last BatchNorm of a residual branch. The arithmetic is float32 whatever
    ``x``'s dtype, and the result is ``dtype``. ``update_running = False``
    keeps the running buffers as they are (the recompute of a checkpointed
    forward, ``train/steps.py``). With ``axis_name`` (Flax's name) set, the
    batch statistics are taken over every rank (module docstring), or over
    the ranks of ``sync_group`` where that is set (the data group of the
    GSPMD families, ``parallel/tensor_parallel.py``)."""

    def __init__(self, n_chans: int, momentum: float = 0.9, eps: float = 1e-5,
                 scale_init: float = 0.5, dtype: torch.dtype = torch.float32,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.axis_name = axis_name
        self.sync_group = None
        self.update_running = True
        self.weight = nn.Parameter(torch.full((n_chans,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(n_chans))
        self.register_buffer("running_mean", torch.zeros(n_chans))
        self.register_buffer("running_var", torch.ones(n_chans))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean2 = (x * x).mean(dim=(0, 2, 3))
            if self.axis_name is not None:
                mean, mean2 = sync_stats(torch.stack([mean, mean2]),
                                         self.sync_group).unbind(0)
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if self.update_running:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


class ResBlock(nn.Module):
    """conv3x3 (no bias) -> BN -> relu -> (+x); kaiming-normal(relu) conv."""

    def __init__(self, n_chans: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        self.conv = Conv2d(n_chans, n_chans, 3, padding=1, bias=False, compute_dtype=dtype)
        self.batch_norm = BatchNorm(n_chans, dtype=dtype, axis_name=bn_cross_replica_axis)
        kaiming_normal_relu_(self.conv.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.batch_norm(self.conv(x))) + x


class NetResDeep(nn.Module):
    """conv3->C k3p1, relu, maxpool2, n_blocks x ResBlock, maxpool2,
    flatten (h, w, c), fc->32, relu, fc->num_classes."""

    def __init__(self, n_chans1: int = 32, n_blocks: int = 10,
                 num_classes: int = 10, tied: bool = True,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.n_chans1, self.n_blocks, self.tied = n_chans1, n_blocks, tied
        self.dtype = dtype
        self.conv1 = Conv2d(3, n_chans1, 3, padding=1, compute_dtype=dtype)
        torch_default_uniform_(self.conv1.weight, 3 * 3 * 3, generator)
        torch_default_uniform_(self.conv1.bias, 3 * 3 * 3, generator)
        if tied:
            self.resblock = ResBlock(n_chans1, generator, dtype, bn_cross_replica_axis)
            self.blocks = [self.resblock] * n_blocks
        else:
            self.blocks = []
            for i in range(n_blocks):
                block = ResBlock(n_chans1, generator, dtype, bn_cross_replica_axis)
                self.add_module(f"resblock_{i}", block)
                self.blocks.append(block)
        flat = 8 * 8 * n_chans1
        self.fc1 = Dense(flat, 32, compute_dtype=dtype)
        torch_default_uniform_(self.fc1.weight, flat, generator)
        torch_default_uniform_(self.fc1.bias, flat, generator)
        self.fc2 = Dense(32, num_classes, compute_dtype=dtype)
        torch_default_uniform_(self.fc2.weight, 32, generator)
        torch_default_uniform_(self.fc2.bias, 32, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (N, 32, 32, 3) NHWC, as the JAX model takes it
        out = self.conv1(x.permute(0, 3, 1, 2))
        out = F.max_pool2d(F.relu(out), 2)            # 32x32 -> 16x16
        for block in self.blocks:
            out = block(out)
        out = F.max_pool2d(out, 2)                    # 16x16 -> 8x8
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)  # (h, w, c)
        out = F.relu(self.fc1(out))
        return self.fc2(out).float()


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
