"""The ResNet family (ResNet-18/34/50/101/152, WRN-28-10, WRN-16-4) as
``torch.nn`` modules.

Counterpart of ``tpu_ddp/models/resnet_family.py`` (``_BasicBlock`` :29,
``_Bottleneck`` :59, ``ResNet`` :92, the factories :143-176, ``_WideBlock``
:178, ``WideResNet`` :213, ``wrn28_10`` :252, ``wrn16_4`` :262). Module and
parameter names follow the Flax tree, so ``checkpoint/convert.py`` and
``checkpoint/import_foreign.py`` map by path: ``stem_conv``, ``stem_bn``,
``_BasicBlock_<g>`` / ``_Bottleneck_<g>`` / ``_WideBlock_<g>`` with ``g`` the
block's index over the whole network, then ``Conv_<c>`` and ``BatchNorm_<c>``
numbered as Flax numbers them at construction, ``final_bn`` and ``head``.
A residual block's projection shortcut is its trailing ``Conv_<n>`` /
``BatchNorm_<n>``: Flax builds it after the main branch. A wide block builds
it first, so there it is ``Conv_0``.

* **Layout.** The public input is NHWC; the stem gets it as an NCHW view
  whose memory stays channels-last, as in ``models/resnet.py``.
* **Stems.** CIFAR: a 3x3 conv, no pool. ImageNet: a 7x7/2 conv, then a
  3x3/2 max-pool with padding 1 (padded with -inf, as Flax pads).
* **BatchNorm.** ``models/resnet.py::BatchNorm`` (Flax's biased fast-form
  variance, momentum 0.9), scale initialised to 1, and to 0 for the last
  BatchNorm of each residual branch, so the branch starts as the identity.
* **Initializers.** Convolutions: He init over fan_out with an untruncated
  normal (Flax ``variance_scaling(2.0, "fan_out", "normal")``); the head:
  lecun-normal kernel, zero bias (Flax ``Dense``). Every draw comes from the
  ``torch.Generator`` given; the bits differ from the JAX package's, so
  tests carry weights across.
* The pool is a global mean over H and W; the logits are float32.

``dtype`` (:33-138) is the compute dtype, as in ``models/resnet.py``: the
convolutions and the head compute in it, BatchNorm in float32 with a
``dtype`` result. ``bn_cross_replica_axis`` (:32, :62, :101, :186, :222)
syncs every BatchNorm's statistics over the ranks (``--sync-bn``;
``models/resnet.py``).
Convolutions, BatchNorm and the head are cuDNN, cuBLAS and torch ops, as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.models.initializers import lecun_normal_
from tpu_ddp_torch.models.layers import Conv2d, Dense
from tpu_ddp_torch.models.resnet import BatchNorm
from tpu_ddp_torch.models.zoo import register


@torch.no_grad()
def he_normal_fan_out_(weight: torch.Tensor, generator: torch.Generator):
    """``std = sqrt(2 / fan_out)``, untruncated; ``fan_out = out * kh * kw``
    of a torch-layout conv weight ``(out, in, kh, kw)``."""
    fan_out = weight.shape[0] * math.prod(weight.shape[2:])
    return weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def _conv(in_chans: int, out_chans: int, k: int, generator: torch.Generator,
          stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32) -> Conv2d:
    conv = Conv2d(in_chans, out_chans, k, stride=stride, padding=padding, bias=False,
                  compute_dtype=dtype)
    he_normal_fan_out_(conv.weight, generator)
    return conv


class _BasicBlock(nn.Module):
    """Two 3x3 convs, each with BatchNorm, the second's scale zero; a 1x1
    projection shortcut where the shapes change."""

    expansion = 1

    def __init__(self, in_chans: int, filters: int, strides: int,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        bn = functools.partial(BatchNorm, dtype=dtype, axis_name=bn_cross_replica_axis)
        self.Conv_0 = _conv(in_chans, filters, 3, generator, strides, 1, dtype)
        self.BatchNorm_0 = bn(filters, scale_init=1.0)
        self.Conv_1 = _conv(filters, filters, 3, generator, 1, 1, dtype)
        self.BatchNorm_1 = bn(filters, scale_init=0.0)
        self.project = in_chans != filters or strides != 1
        if self.project:
            self.Conv_2 = _conv(in_chans, filters, 1, generator, strides, dtype=dtype)
            self.BatchNorm_2 = bn(filters, scale_init=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class _Bottleneck(nn.Module):
    """1x1, 3x3 (strided), 1x1 to ``4 * filters``, each with BatchNorm, the
    last one's scale zero; a 1x1 projection shortcut where the shapes
    change."""

    expansion = 4

    def __init__(self, in_chans: int, filters: int, strides: int,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        bn = functools.partial(BatchNorm, dtype=dtype, axis_name=bn_cross_replica_axis)
        out = filters * self.expansion
        self.Conv_0 = _conv(in_chans, filters, 1, generator, dtype=dtype)
        self.BatchNorm_0 = bn(filters, scale_init=1.0)
        self.Conv_1 = _conv(filters, filters, 3, generator, strides, 1, dtype)
        self.BatchNorm_1 = bn(filters, scale_init=1.0)
        self.Conv_2 = _conv(filters, out, 1, generator, dtype=dtype)
        self.BatchNorm_2 = bn(out, scale_init=0.0)
        self.project = in_chans != out or strides != 1
        if self.project:
            self.Conv_3 = _conv(in_chans, out, 1, generator, strides, dtype=dtype)
            self.BatchNorm_3 = bn(out, scale_init=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


def _head(in_features: int, num_classes: int, generator: torch.Generator,
          dtype: torch.dtype = torch.float32) -> Dense:
    head = Dense(in_features, num_classes, compute_dtype=dtype)
    lecun_normal_(head.weight, generator)
    with torch.no_grad():
        head.bias.zero_()
    return head


class ResNet(nn.Module):
    """``stage_sizes`` e.g. (2, 2, 2, 2) for ResNet-18; ``block``
    ``_BasicBlock`` or ``_Bottleneck``; ``cifar_stem`` for 32x32 inputs."""

    def __init__(self, stage_sizes: Sequence[int], block: type, num_classes: int = 10,
                 num_filters: int = 64, cifar_stem: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.stage_sizes, self.block = tuple(stage_sizes), block
        self.cifar_stem, self.dtype = cifar_stem, dtype
        if cifar_stem:
            self.stem_conv = _conv(3, num_filters, 3, generator, 1, 1, dtype)
        else:
            self.stem_conv = _conv(3, num_filters, 7, generator, 2, 3, dtype)
        self.stem_bn = BatchNorm(num_filters, scale_init=1.0, dtype=dtype,
                                 axis_name=bn_cross_replica_axis)
        self.blocks = []
        chans, g = num_filters, 0
        for stage, n_blocks in enumerate(self.stage_sizes):
            for b in range(n_blocks):
                filters = num_filters * 2 ** stage
                blk = block(chans, filters, 2 if (b == 0 and stage > 0) else 1,
                            generator, dtype, bn_cross_replica_axis)
                self.add_module(f"{block.__name__}_{g}", blk)
                self.blocks.append(blk)
                chans, g = filters * block.expansion, g + 1
        self.head = _head(chans, num_classes, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (N, H, W, 3) NHWC
        x = F.relu(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2))))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        return self.head(x.mean(dim=(2, 3))).float()


def _factory(stage_sizes, block):
    def build(num_classes: int = 10, generator: Optional[torch.Generator] = None,
              image_size: int = 32, cifar_stem: bool = True,
              dtype: torch.dtype = torch.float32,
              bn_cross_replica_axis: Optional[str] = None) -> ResNet:
        del image_size  # the global pool takes any input size
        return ResNet(stage_sizes, block, num_classes=num_classes,
                      cifar_stem=cifar_stem, generator=generator, dtype=dtype,
                      bn_cross_replica_axis=bn_cross_replica_axis)

    return build


resnet18 = register("resnet18")(_factory((2, 2, 2, 2), _BasicBlock))
resnet34 = register("resnet34")(_factory((3, 4, 6, 3), _BasicBlock))
resnet50 = register("resnet50")(_factory((3, 4, 6, 3), _Bottleneck))
#: the model the reference's fine-tune script imports (ppe_main_ddp.py:1)
resnet101 = register("resnet101")(_factory((3, 4, 23, 3), _Bottleneck))
resnet152 = register("resnet152")(_factory((3, 8, 36, 3), _Bottleneck))


class _WideBlock(nn.Module):
    """Pre-activation wide block: BN-ReLU, then two 3x3 convs with a BN-ReLU
    between; the (1x1-projected) shortcut branches from the pre-activated
    tensor."""

    def __init__(self, in_chans: int, filters: int, strides: int,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        bn = functools.partial(BatchNorm, dtype=dtype, axis_name=bn_cross_replica_axis)
        self.BatchNorm_0 = bn(in_chans, scale_init=1.0)
        self.project = in_chans != filters or strides != 1
        convs = []
        if self.project:
            convs.append(_conv(in_chans, filters, 1, generator, strides, dtype=dtype))
        convs.append(_conv(in_chans, filters, 3, generator, strides, 1, dtype))
        convs.append(_conv(filters, filters, 3, generator, 1, 1, dtype))
        for c, conv in enumerate(convs):
            self.add_module(f"Conv_{c}", conv)
        self.BatchNorm_1 = bn(filters, scale_init=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = [getattr(self, f"Conv_{c}") for c in range(2 + self.project)]
        y = F.relu(self.BatchNorm_0(x))
        shortcut = convs[0](y) if self.project else x
        y = convs[-2](y)
        y = convs[-1](F.relu(self.BatchNorm_1(y)))
        return y + shortcut


class WideResNet(nn.Module):
    """WRN-depth-widen for 32x32 inputs: depth 6n+4, three stages of n
    pre-activation blocks at widths (16, 32, 64) * widen, a final BN-ReLU
    before the global pool."""

    def __init__(self, depth: int = 28, widen: int = 10, num_classes: int = 10,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n+4, got {depth}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        n = (depth - 4) // 6
        self.stem_conv = _conv(3, 16, 3, generator, 1, 1, dtype)
        self.blocks = []
        chans, g = 16, 0
        for stage, width in enumerate((16, 32, 64)):
            for b in range(n):
                blk = _WideBlock(chans, width * widen, 2 if (b == 0 and stage > 0) else 1,
                                 generator, dtype, bn_cross_replica_axis)
                self.add_module(f"_WideBlock_{g}", blk)
                self.blocks.append(blk)
                chans, g = width * widen, g + 1
        self.final_bn = BatchNorm(chans, scale_init=1.0, dtype=dtype,
                                  axis_name=bn_cross_replica_axis)
        self.head = _head(chans, num_classes, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_conv(x.permute(0, 3, 1, 2))
        for blk in self.blocks:
            x = blk(x)
        x = F.relu(self.final_bn(x))
        return self.head(x.mean(dim=(2, 3))).float()


@register("wrn28_10")
def wrn28_10(num_classes: int = 10, generator: Optional[torch.Generator] = None,
             image_size: int = 32, cifar_stem: bool = True,
             dtype: torch.dtype = torch.float32,
             bn_cross_replica_axis: Optional[str] = None) -> WideResNet:
    """The WRN paper's headline CIFAR config (36,479,194 params at 10
    classes)."""
    del image_size, cifar_stem  # WRN is 32x32-native
    return WideResNet(depth=28, widen=10, num_classes=num_classes, generator=generator,
                      dtype=dtype, bn_cross_replica_axis=bn_cross_replica_axis)


@register("wrn16_4")
def wrn16_4(num_classes: int = 10, generator: Optional[torch.Generator] = None,
            image_size: int = 32, cifar_stem: bool = True,
            dtype: torch.dtype = torch.float32,
            bn_cross_replica_axis: Optional[str] = None) -> WideResNet:
    """Small WRN of the same family."""
    del image_size, cifar_stem
    return WideResNet(depth=16, widen=4, num_classes=num_classes, generator=generator,
                      dtype=dtype, bn_cross_replica_axis=bn_cross_replica_axis)
