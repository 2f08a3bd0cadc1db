"""Vision Transformer as ``torch.nn`` modules.

Counterpart of ``tpu_ddp/models/vit.py`` (``full_attention`` :27,
``MultiHeadSelfAttention`` :46, ``TransformerBlock`` :64, ``ViT`` :86,
``vit_s4`` :183, ``vit_b16`` :190): NHWC patch-embed conv, learned position
embeddings, pre-LN blocks, mean-pool head. Module and parameter names follow
the Flax tree (``patch_embed``, ``pos_embed``, ``block_<i>.ln1``,
``attn.qkv``, ``attn.proj``, ``ln2``, ``mlp_up``, ``mlp_down``, ``ln_f``,
``head``), so ``tpu_ddp_torch/checkpoint/convert.py`` maps one onto the
other by path.

Where PyTorch's defaults differ from Flax's, the Flax value is taken:
LayerNorm eps 1e-6 (torch: 1e-5); GELU in its tanh form (Flax ``nn.gelu``;
torch's default is the erf form); Flax's initializers
(``models/initializers.py``). The patch embed's ``padding="SAME"`` is no
padding here, because the image side divides by the patch.

``attention_impl`` (a property of ``ViT`` that reaches every block) is
pluggable on ``(B, T, H, D)`` tensors: ``full_attention`` by default; the
trainer sets
``tpu_ddp_torch.ops.flash_attention.flash_attention`` under ``--attention
flash``.

Sequence parallelism (the JAX ``sp_axis``/``sp_flash``, :87-106, :133-153,
:177-178): ``ViT.set_sequence_parallel(group, flash)`` makes the same
module take this rank's stripe of image rows, ``H / n`` of them for the n
ranks of ``group``'s ring, whose patches are contiguous tokens in the
``(h, w)`` order; the global ``pos_embed`` is sliced at ``s * T_local``
(s: the rank's place on the ring), every block's attention is the ring
(``parallel/ring_attention.py``: flash tiles under ``flash``), and the
mean-pool closes with the ring's mean (``collectives.group_mean``, whose
backward is the same mean: ``parallel/sequence_parallel.py`` says why).
The params and their names and shapes are the plain module's, so a
checkpoint or ``from_jax`` serves both; ``set_sequence_parallel(None)``
makes it the plain module again (the JAX ``clone(sp_axis=None)``).

``dtype`` is the compute dtype (``MultiHeadSelfAttention`` :49,
``TransformerBlock`` :68, ``ViT`` :114): float32 or bfloat16, at Flax's cast
points (``models/layers.py``); params stay float32, ``pos_embed`` is cast to
the activations' dtype (:163), GELU runs in it, and the logits are float32
(:180). ``remat`` (:113, :165) recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant), so only the blocks' inputs are
kept; the params and their names are the same either way.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_ddp_torch.models.initializers import lecun_normal_
from tpu_ddp_torch.models.layers import Conv2d, Dense, LayerNorm
from tpu_ddp_torch.models.zoo import register

LN_EPS = 1e-6  # Flax nn.LayerNorm's default


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, D) -> (B, T, H, D). Non-causal softmax attention:
    float32 scores and softmax whatever the inputs' dtype; p cast to v's
    dtype for P V, summed in float32, the result in q's dtype (the JAX
    ``full_attention``'s ``preferred_element_type=float32`` products)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _dense(n_in: int, n_out: int, generator: torch.Generator,
           dtype: torch.dtype = torch.float32) -> Dense:
    """Flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = Dense(n_in, n_out, compute_dtype=dtype)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attention_impl: Callable = full_attention
        self.qkv = _dense(dim, 3 * dim, generator, dtype)
        self.proj = _dense(dim, dim, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        # strided views of the one qkv product, as jnp.split gives them; the
        # heads are counted from its width, so a tensor-parallel rank's qkv
        # (its heads' q, k and v columns, parallel/tensor_parallel.py)
        # gives its own heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        heads = q.shape[-1] // self.head_dim
        q = q.reshape(B, T, heads, self.head_dim)
        k = k.reshape(B, T, heads, self.head_dim)
        v = v.reshape(B, T, heads, self.head_dim)
        o = self.attention_impl(q, k, v)
        return self.proj(o.reshape(B, T, heads * self.head_dim))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 generator: torch.Generator, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(dim, LN_EPS, dtype)
        self.attn = MultiHeadSelfAttention(dim, num_heads, generator, dtype)
        self.ln2 = LayerNorm(dim, LN_EPS, dtype)
        self.mlp_up = _dense(dim, dim * mlp_ratio, generator, dtype)
        self.mlp_down = _dense(dim * mlp_ratio, dim, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(h)


def run_blocks(blocks, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``x`` through ``blocks`` in turn; under ``remat`` (and autograd) each
    block is checkpointed, so its internals are recomputed in the backward
    (Flax ``nn.remat(TransformerBlock)``)."""
    remat = remat and torch.is_grad_enabled()
    for block in blocks:
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    return x


def set_sequence_parallel(model: nn.Module, group, flash: bool, causal: bool) -> None:
    """Bind the ring of ``group`` (flash tiles under ``flash``, ``causal``
    as given) into every block of ``model`` (a ViT or the LM), keeping the
    plain attention to bind back when ``group`` is None."""
    if group is None:
        if model.sp_group is not None:
            for block, impl in zip(model.blocks, model._plain_attention):
                block.attn.attention_impl = impl
        model.sp_group, model.sp_flash = None, False
        return
    from tpu_ddp_torch.parallel.ring_attention import ring_attention, ring_flash_attention

    if model.sp_group is None:
        model._plain_attention = [block.attn.attention_impl for block in model.blocks]
    model.sp_group, model.sp_flash = group, flash
    ring = functools.partial(ring_flash_attention if flash else ring_attention,
                             group=group, causal=causal)
    for block in model.blocks:
        block.attn.attention_impl = ring


def sequence_slice(model: nn.Module, pos_embed: torch.Tensor, t_local: int) -> torch.Tensor:
    """The rows of the global ``(1, T, C)`` ``pos_embed`` that this rank's
    ``t_local`` tokens take: all of it on the plain module, rows
    ``[s * t_local, (s + 1) * t_local)`` on the ring (module docstring)."""
    if model.sp_group is None:
        return pos_embed
    from tpu_ddp_torch.parallel.ring_attention import ring_position

    n, s = ring_position(model.sp_group)
    if t_local * n != pos_embed.shape[1]:
        raise ValueError(f"{t_local} tokens a rank on a ring of {n} is not the "
                         f"{pos_embed.shape[1]} positions of pos_embed")
    return pos_embed[:, s * t_local:(s + 1) * t_local]


class ViT(nn.Module):
    """Patch embed -> + pos_embed -> ``depth`` pre-LN blocks -> LayerNorm
    -> token mean -> head. The input is NHWC ``(N, S, S, 3)`` with
    ``S == image_size``, as the JAX model takes it; the logits are float32.
    ``dtype`` and ``remat`` as in the module docstring."""

    def __init__(self, patch_size: int = 4, hidden_dim: int = 192, depth: int = 6,
                 num_heads: int = 3, num_classes: int = 10, mlp_ratio: int = 4,
                 image_size: int = 32, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} does not divide by "
                             f"patch {patch_size}")
        self.hidden_dim, self.dtype, self.remat = hidden_dim, dtype, remat
        self.patch_size = patch_size
        self.sp_group, self.sp_flash = None, False
        self.patch_embed = Conv2d(3, hidden_dim, patch_size, stride=patch_size,
                                  compute_dtype=dtype)
        lecun_normal_(self.patch_embed.weight, generator)
        nn.init.zeros_(self.patch_embed.bias)
        tokens = (image_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden_dim))
        with torch.no_grad():  # Flax initializers.normal(0.02)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = []
        for i in range(depth):
            block = TransformerBlock(hidden_dim, num_heads, mlp_ratio, generator, dtype)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = LayerNorm(hidden_dim, LN_EPS, dtype)
        self.head = _dense(hidden_dim, num_classes, generator, dtype)

    @property
    def attention_impl(self) -> Callable:
        return self.blocks[0].attn.attention_impl if self.blocks else full_attention

    @attention_impl.setter
    def attention_impl(self, fn: Callable) -> None:
        """Bind ``fn`` in every block (the JAX model's
        ``clone(attention_impl=fn)``)."""
        for block in self.blocks:
            block.attn.attention_impl = fn

    def set_sequence_parallel(self, group=None, flash: bool = False) -> None:
        """Run sequence-parallel over the ring of ``group`` (ring attention
        with the flash tiles under ``flash``), or with ``group`` None as the
        plain module again (module docstring)."""
        set_sequence_parallel(self, group, flash, causal=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if self.sp_group is not None and x.shape[1] % self.patch_size:
            raise ValueError(f"a stripe of {x.shape[1]} image rows does not divide by "
                             f"patch {self.patch_size}")
        x = self.patch_embed(x.permute(0, 3, 1, 2))        # (B, C, h, w)
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.hidden_dim)  # (h, w) order
        x = x + sequence_slice(self, self.pos_embed, x.shape[1]).to(x.dtype)
        x = run_blocks(self.blocks, x, self.remat)
        x = self.ln_f(x).mean(dim=1)
        if self.sp_group is not None:
            from tpu_ddp_torch.parallel.collectives import group_mean

            x = group_mean(x, self.sp_group)
        return self.head(x).float()


@register("vit_s4")
def vit_s4(num_classes: int = 10, generator: Optional[torch.Generator] = None,
           image_size: int = 32, dtype: torch.dtype = torch.float32,
           bn_cross_replica_axis: Optional[str] = None) -> ViT:
    """Small ViT for 32x32 inputs (patch 4 -> 64 tokens)."""
    del bn_cross_replica_axis  # no BatchNorm; the JAX factory ignores it too
    return ViT(patch_size=4, hidden_dim=192, depth=6, num_heads=3,
               num_classes=num_classes, image_size=image_size, generator=generator,
               dtype=dtype)


@register("vit_b16")
def vit_b16(num_classes: int = 1000, generator: Optional[torch.Generator] = None,
            image_size: int = 32, dtype: torch.dtype = torch.float32,
            bn_cross_replica_axis: Optional[str] = None) -> ViT:
    """ViT-B/16: 196 tokens at its published 224x224 input, 4 at the 32x32
    the CIFAR trainer feeds it. ``pos_embed`` is sized for ``image_size``,
    as the Flax model sizes it from the input it is initialised on."""
    del bn_cross_replica_axis  # no BatchNorm; the JAX factory ignores it too
    return ViT(patch_size=16, hidden_dim=768, depth=12, num_heads=12,
               num_classes=num_classes, image_size=image_size, generator=generator,
               dtype=dtype)
