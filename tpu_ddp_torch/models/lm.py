"""Causal transformer LM as a ``torch.nn`` module, and its greedy decode.

Counterpart of ``tpu_ddp/models/lm.py`` (``causal_full_attention`` :43,
``causal_flash_attention`` :51, ``CausalTransformerLM`` :58,
``greedy_generate`` :135): token embedding, learned positions, the ViT's
pre-LN ``TransformerBlock`` unchanged, a final LayerNorm and a vocabulary
head. Module and parameter names follow the Flax tree (``tok_embed``,
``pos_embed``, ``block_<i>``, ``ln_f``, ``head``), so
``tpu_ddp_torch/checkpoint/convert.py`` carries a Flax LM's params across.

Where the Flax module sizes ``pos_embed`` from the tokens it is initialised
on (:108-112), this one takes ``seq_len`` and then accepts only that many
tokens. The embedding is drawn as Flax ``nn.Embed``'s default initialiser
draws it: an untruncated normal of std ``1/sqrt(hidden_dim)``.

``use_flash`` binds the attention of every block: the port's
``flash_attention(..., causal=True)`` (K4 forward, K5/K6 backward on CUDA
tensors) or the plain causal attention, the numerics ground truth.
``set_sequence_parallel(group, flash)`` is the JAX ``sp_axis``/``sp_flash``
(:85-106), as on the ViT (``models/vit.py``): tokens ``(B, seq_len / n)``,
this rank's chunk of the sequence on ``group``'s ring of n, ``pos_embed``
sliced at the rank's place, and the causal ring attention
(``parallel/ring_attention.py``), flash tiles under ``flash``;
``greedy_generate`` takes the plain module only, as in JAX. Not ported:
``attention_interpret`` (the Pallas interpreter). Next-token training lives
in ``tpu_ddp_torch/train/lm_steps.py``.

``dtype`` (:77) is the compute dtype, at Flax's cast points
(``models/layers.py``): ``nn.Embed(dtype=)`` casts the table before the
gather (:82), the blocks, ``ln_f`` and the head compute in it, and the
logits are float32. In bfloat16 the plain causal attention keeps the dtype
flow of the JAX ``_reference`` (its scores rounded to bfloat16, then
float32, with a float32 output that the next Dense casts back), and the
flash path runs K4-K6's bfloat16 kernels. ``remat`` (:76, :120-121)
recomputes each block in the backward, as the ViT's does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.models.layers import LayerNorm
from tpu_ddp_torch.models.vit import (
    LN_EPS,
    TransformerBlock,
    _dense,
    run_blocks,
    sequence_slice,
    set_sequence_parallel,
)
from tpu_ddp_torch.ops import flash_attention as fa


def causal_full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain causal attention on ``(B, T, H, D)``: whole score matrices."""
    return fa.reference(q, k, v, causal=True)


def causal_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K4-K6 with ``causal=True`` (their plain versions on CPU tensors)."""
    return fa.flash_attention(q, k, v, causal=True)


class CausalTransformerLM(nn.Module):
    """Decoder-only transformer. Input ``tokens`` ``(B, seq_len)`` integers;
    output float32 logits ``(B, seq_len, vocab_size)``."""

    def __init__(self, vocab_size: int = 256, hidden_dim: int = 192, depth: int = 6,
                 num_heads: int = 3, mlp_ratio: int = 4, seq_len: int = 256,
                 use_flash: bool = False, generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.seq_len, self.dtype, self.remat = seq_len, dtype, remat
        self.tok_embed = nn.Embedding(vocab_size, hidden_dim)
        with torch.no_grad():   # Flax nn.Embed: variance_scaling(1, fan_in, normal)
            self.tok_embed.weight.normal_(0.0, 1.0 / math.sqrt(hidden_dim),
                                          generator=generator)
        self.pos_embed = nn.Parameter(torch.empty(1, seq_len, hidden_dim))
        with torch.no_grad():   # Flax initializers.normal(0.02)
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.blocks = []
        for i in range(depth):
            block = TransformerBlock(hidden_dim, num_heads, mlp_ratio, generator, dtype)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = LayerNorm(hidden_dim, LN_EPS, dtype)
        self.head = _dense(hidden_dim, vocab_size, generator, dtype)
        self.sp_group, self.sp_flash = None, False
        self.use_flash = use_flash

    @property
    def use_flash(self) -> bool:
        return self._use_flash

    @use_flash.setter
    def use_flash(self, flag: bool) -> None:
        """Bind K4-K6 (True) or the plain causal attention in every block."""
        self._use_flash = bool(flag)
        impl = causal_flash_attention if flag else causal_full_attention
        for block in self.blocks:
            block.attn.attention_impl = impl

    def set_sequence_parallel(self, group=None, flash: bool = False) -> None:
        """Run sequence-parallel over the ring of ``group`` (the causal ring
        attention, flash tiles under ``flash``), or with ``group`` None as
        the plain module again (module docstring)."""
        set_sequence_parallel(self, group, flash, causal=True)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.dim() != 2 or (self.sp_group is None and tokens.shape[1] != self.seq_len):
            raise ValueError(f"tokens must be (B, seq_len) = (B, {self.seq_len}), "
                             f"the length pos_embed was built for; got "
                             f"{tuple(tokens.shape)}")
        x = F.embedding(tokens, self.tok_embed.weight.to(self.dtype))
        pos = sequence_slice(self, self.pos_embed, tokens.shape[1])
        x = run_blocks(self.blocks, x + pos.to(x.dtype), self.remat)
        return self.head(self.ln_f(x)).float()


@torch.no_grad()
def greedy_generate(model: CausalTransformerLM, prompt: torch.Tensor,
                    n_new: int) -> torch.Tensor:
    """Greedy decode: ``(B, T0)`` prompt -> ``(B, T0 + n_new)`` tokens, on
    the prompt's device.

    One fixed ``(B, T0 + n_new)`` buffer and one full forward per new token,
    in eval mode: causality leaves position ``i - 1``'s logits blind to the
    not-yet-written tail, so the argmax there fills position ``i`` exactly,
    with no KV cache. ``T0 + n_new`` must equal ``model.seq_len``."""
    B, T0 = prompt.shape
    if model.sp_group is not None:
        raise ValueError("greedy_generate takes the plain module: "
                         "set_sequence_parallel(None) first")
    if T0 + n_new != model.seq_len:
        raise ValueError(f"T0 + n_new = {T0} + {n_new} must equal the model's "
                         f"seq_len {model.seq_len} (its position table's length)")
    buf = torch.zeros((B, T0 + n_new), dtype=torch.long, device=prompt.device)
    buf[:, :T0] = prompt
    was_training = model.training
    model.eval()
    try:
        for i in range(T0, T0 + n_new):
            buf[:, i] = model(buf)[:, i - 1].argmax(dim=-1)
    finally:
        model.train(was_training)
    return buf
