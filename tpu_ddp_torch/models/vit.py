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
flash``. Not ported: ``sp_axis``/``sp_flash`` (sequence parallelism),
``remat`` and bfloat16 compute.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.models.initializers import lecun_normal_
from tpu_ddp_torch.models.zoo import register

LN_EPS = 1e-6  # Flax nn.LayerNorm's default


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, T, H, D) -> (B, T, H, D). Non-causal softmax attention,
    float32 scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def _dense(n_in: int, n_out: int, generator: torch.Generator) -> nn.Linear:
    """Flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(n_in, n_out)
    lecun_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.attention_impl: Callable = full_attention
        self.qkv = _dense(dim, 3 * dim, generator)
        self.proj = _dense(dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        head_dim = C // self.num_heads
        # strided views of the one qkv product, as jnp.split gives them
        q, k, v = self.qkv(x).split(C, dim=-1)
        q = q.reshape(B, T, self.num_heads, head_dim)
        k = k.reshape(B, T, self.num_heads, head_dim)
        v = v.reshape(B, T, self.num_heads, head_dim)
        o = self.attention_impl(q, k, v)
        return self.proj(o.reshape(B, T, C))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 generator: torch.Generator):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadSelfAttention(dim, num_heads, generator)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_up = _dense(dim, dim * mlp_ratio, generator)
        self.mlp_down = _dense(dim * mlp_ratio, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(h)


class ViT(nn.Module):
    """Patch embed -> + pos_embed -> ``depth`` pre-LN blocks -> LayerNorm
    -> token mean -> head. The input is NHWC ``(N, S, S, 3)`` with
    ``S == image_size``, as the JAX model takes it; the logits are float32."""

    def __init__(self, patch_size: int = 4, hidden_dim: int = 192, depth: int = 6,
                 num_heads: int = 3, num_classes: int = 10, mlp_ratio: int = 4,
                 image_size: int = 32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} does not divide by "
                             f"patch {patch_size}")
        self.hidden_dim = hidden_dim
        self.patch_embed = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        lecun_normal_(self.patch_embed.weight, generator)
        nn.init.zeros_(self.patch_embed.bias)
        tokens = (image_size // patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden_dim))
        with torch.no_grad():  # Flax initializers.normal(0.02)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = []
        for i in range(depth):
            block = TransformerBlock(hidden_dim, num_heads, mlp_ratio, generator)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.head = _dense(hidden_dim, num_classes, generator)

    @property
    def attention_impl(self) -> Callable:
        return self.blocks[0].attn.attention_impl if self.blocks else full_attention

    @attention_impl.setter
    def attention_impl(self, fn: Callable) -> None:
        """Bind ``fn`` in every block (the JAX model's
        ``clone(attention_impl=fn)``)."""
        for block in self.blocks:
            block.attn.attention_impl = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = self.patch_embed(x.permute(0, 3, 1, 2))        # (B, C, h, w)
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.hidden_dim)  # (h, w) order
        x = x + self.pos_embed
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x).mean(dim=1)
        return self.head(x).float()


@register("vit_s4")
def vit_s4(num_classes: int = 10, generator: Optional[torch.Generator] = None,
           image_size: int = 32) -> ViT:
    """Small ViT for 32x32 inputs (patch 4 -> 64 tokens)."""
    return ViT(patch_size=4, hidden_dim=192, depth=6, num_heads=3,
               num_classes=num_classes, image_size=image_size, generator=generator)


@register("vit_b16")
def vit_b16(num_classes: int = 1000, generator: Optional[torch.Generator] = None,
            image_size: int = 32) -> ViT:
    """ViT-B/16: 196 tokens at its published 224x224 input, 4 at the 32x32
    the CIFAR trainer feeds it. ``pos_embed`` is sized for ``image_size``,
    as the Flax model sizes it from the input it is initialised on."""
    return ViT(patch_size=16, hidden_dim=768, depth=12, num_heads=12,
               num_classes=num_classes, image_size=image_size, generator=generator)
