"""Mixture-of-Experts ViT: the expert-parallel model family.

Counterpart of ``tpu_ddp/models/moe.py`` (``MoEMlp`` :35,
``MoETransformerBlock`` :149, ``MoEViT`` :179, ``vit_moe_s4`` :244,
``vit_moe_s4_top2`` :252): the GShard/Switch formulation, routing as dense
one-hot dispatch and combine products with a fixed per-expert capacity.

``MoEMlp`` keeps the Flax layer's arithmetic:

* the router (a ``Dense`` to E logits) and its softmax in float32 whatever
  the compute dtype;
* top-k stable on ties, the lower expert index first (``jax.lax.top_k``'s
  order; a stable descending sort here, where ``torch.topk`` promises no
  order);
* gates: at ``top_k == 1`` the raw top probability (Switch), above it the
  chosen probabilities renormalised to sum to 1 (GShard);
* the load-balance loss over the first choice, ``E * mean_b sum_e
  fraction_e * mean_prob_e`` (1.0 at perfect balance), kept on the module
  (``aux_loss``, Flax's ``sow``) for ``sown_aux_losses``;
* ``capacity = ceil(T * K * capacity_factor / E)`` slots an expert and an
  image; slots go choice-major (every first choice claims a slot before any
  second choice), and a position of -1 (not routed) or at or past the
  capacity maps to a zero row, which drops that choice;
* the expert weights stacked with a leading E axis in the JAX layout
  (``w_up (E, C, H)``, ``b_up (E, H)``, ``w_down (E, H, C)``, ``b_down
  (E, C)``), initialised as Flax's ``lecun_normal`` on those shapes (fan-in
  ``C * E`` and ``H * E``); their products take float32 sums of the
  compute-dtype operands, rounded once (``preferred_element_type``).

Expert parallelism (``parallel/expert_parallel.py``) gives each rank of an
expert group ``E / ep`` consecutive experts (``set_expert_parallel``): the
router, the dispatch and the combine are computed whole on every rank (the
group's ranks hold the same tokens), each rank runs its experts on their
slots, and the combine's output is summed over the group
(``tensor_parallel.reduce_from_model``). The expert path's input and the
combine weights enter through ``copy_to_model``, whose backward sums their
gradients over the group, so the router's, the attention's and the
activations' gradients come out whole on every rank.

``MoEViT`` replaces every ``moe_every``-th block's MLP with an ``MoEMlp``;
it has no ``attention_impl`` (``--attention flash`` on it raises, as in
JAX). ``remat`` recomputes each block in the backward.
"""

from __future__ import annotations

import math
import weakref
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_ddp_torch.models.initializers import _TRUNC_STD, lecun_normal_
from tpu_ddp_torch.models.layers import Conv2d, LayerNorm
from tpu_ddp_torch.models.vit import (
    LN_EPS,
    MultiHeadSelfAttention,
    TransformerBlock,
    _dense,
    run_blocks,
)
from tpu_ddp_torch.models.zoo import register


@torch.no_grad()
def _lecun_stacked_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Flax ``lecun_normal`` on a JAX-layout ``(E, in, out)`` kernel: fan-in
    ``in * E`` (the E axis counts as receptive field)."""
    std = math.sqrt(1.0 / (t.shape[0] * t.shape[1])) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum(eq, a, b)`` of the ``dtype`` operands with float32 sums,
    rounded once to ``dtype``."""
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float()).to(dtype)


def top_k_stable(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lower index (``jax.lax.top_k``)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``(..., n)`` rows with a 1 at ``idx`` and 0 elsewhere, an
    index outside ``[0, n)`` a zero row (``jax.nn.one_hot``'s). A
    comparison on the device: ``F.one_hot`` reads its indices' range back
    to the host (two ``.item()`` a call), a host sync inside the step."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(torch.float32)


def _slots(pos: torch.Tensor, capacity: int) -> torch.Tensor:
    """``one_hot(pos, capacity)`` with a -1 or an out-of-range position a
    zero row (``jax.nn.one_hot``'s)."""
    return one_hot(pos.long(), capacity)


class MoEMlp(nn.Module):
    """Top-k routed FFN over ``num_experts`` experts (module docstring)."""

    def __init__(self, dim: int, num_experts: int, generator: torch.Generator,
                 top_k: int = 1, capacity_factor: float = 1.25, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        E, C, H = num_experts, dim, dim * mlp_ratio
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        self.router = _dense(C, E, generator)            # float32 whatever dtype
        self.w_up = nn.Parameter(_lecun_stacked_(torch.empty(E, C, H), generator))
        self.b_up = nn.Parameter(torch.zeros(E, H))
        self.w_down = nn.Parameter(_lecun_stacked_(torch.empty(E, H, C), generator))
        self.b_down = nn.Parameter(torch.zeros(E, C))
        self.aux_loss: Optional[torch.Tensor] = None
        self.ep_group = None                # expert parallelism: the expert group
        self.expert_offset = 0              # and this rank's first expert

    def forward(self, x: torch.Tensor) -> torch.Tensor:       # (B, T, C) -> (B, T, C)
        B, T, _ = x.shape
        E, K, dt = self.num_experts, self.top_k, self.dtype
        capacity = max(1, int(math.ceil(T * K * self.capacity_factor / E)))
        probs = torch.softmax(self.router(x.float()), dim=-1)   # (B, T, E)
        topk_p, topk_i = top_k_stable(probs, K)
        gates = topk_p if K == 1 else topk_p / torch.clamp_min(
            topk_p.sum(dim=-1, keepdim=True), 1e-9)
        mask0 = one_hot(topk_i[..., 0], E)
        frac, mean_prob = mask0.mean(dim=1), probs.mean(dim=1)  # (B, E)
        self.aux_loss = E * torch.mean(torch.sum(frac * mean_prob, dim=-1))
        dispatch = combine = None
        count = torch.zeros((B, 1, E), dtype=torch.float32, device=x.device)
        for j in range(K):                  # choice-major slots
            mask_j = one_hot(topk_i[..., j], E)
            pos_j = torch.where(mask_j > 0, torch.cumsum(mask_j, dim=1) - 1.0 + count,
                                torch.full_like(mask_j, -1.0))
            disp_j = _slots(pos_j.to(torch.int32), capacity)   # (B, T, E, Cap)
            weighted = disp_j * gates[:, :, j, None, None]
            dispatch = disp_j if dispatch is None else dispatch + disp_j
            combine = weighted if combine is None else combine + weighted
            count = count + mask_j.sum(dim=1, keepdim=True)
        group = self.ep_group
        if group is not None:               # this rank's experts
            from tpu_ddp_torch.parallel.tensor_parallel import copy_to_model

            lo = self.expert_offset
            hi = lo + self.w_up.shape[0]
            x = copy_to_model(x, group)
            dispatch = dispatch[:, :, lo:hi]
            combine = copy_to_model(combine, group)[:, :, lo:hi]
        xd = _product("btec,btm->ebcm", dispatch, x, dt)       # (E, B, Cap, C)
        h = _product("ebcm,emh->ebch", xd, self.w_up, dt) + self.b_up[:, None, None, :].to(dt)
        h = F.gelu(h, approximate="tanh")
        out = (_product("ebch,ehm->ebcm", h, self.w_down, dt)
               + self.b_down[:, None, None, :].to(dt))
        y = _product("btec,ebcm->btm", combine, out, dt)
        if group is not None:
            from tpu_ddp_torch.parallel.tensor_parallel import reduce_from_model

            y = reduce_from_model(y, group)
        return y


class MoETransformerBlock(nn.Module):
    """Pre-LN block whose FFN is an ``MoEMlp`` (the residual carries a
    dropped token through unchanged)."""

    def __init__(self, dim: int, num_heads: int, num_experts: int, generator: torch.Generator,
                 top_k: int = 1, capacity_factor: float = 1.25, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(dim, LN_EPS, dtype)
        self.attn = MultiHeadSelfAttention(dim, num_heads, generator, dtype)
        self.ln2 = LayerNorm(dim, LN_EPS, dtype)
        self.moe = MoEMlp(dim, num_experts, generator, top_k=top_k,
                          capacity_factor=capacity_factor, mlp_ratio=mlp_ratio, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.moe(self.ln2(x))


class MoEViT(nn.Module):
    """ViT with every ``moe_every``-th FFN an ``MoEMlp`` (the Switch/GShard
    interleave); the interface of ``models/vit.py``'s ``ViT``, without
    ``attention_impl``. Parameters are created in Flax's order (patch
    embed, ``pos_embed``, the blocks, ``ln_f``, ``head``)."""

    def __init__(self, patch_size: int = 4, hidden_dim: int = 192, depth: int = 6,
                 num_heads: int = 3, num_classes: int = 10, num_experts: int = 8,
                 top_k: int = 1, moe_every: int = 2, capacity_factor: float = 1.25,
                 mlp_ratio: int = 4, image_size: int = 32,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} does not divide by "
                             f"patch {patch_size}")
        self.hidden_dim, self.dtype, self.remat = hidden_dim, dtype, remat
        self.patch_size, self.depth = patch_size, depth
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
            if moe_every and (i + 1) % moe_every == 0:
                block = MoETransformerBlock(hidden_dim, num_heads, num_experts, generator,
                                            top_k=top_k, capacity_factor=capacity_factor,
                                            mlp_ratio=mlp_ratio, dtype=dtype)
            else:
                block = TransformerBlock(hidden_dim, num_heads, mlp_ratio, generator, dtype)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.ln_f = LayerNorm(hidden_dim, LN_EPS, dtype)
        self.head = _dense(hidden_dim, num_classes, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(B, -1, self.hidden_dim)
        x = x + self.pos_embed.to(x.dtype)
        x = run_blocks(self.blocks, x, self.remat)
        return self.head(self.ln_f(x).mean(dim=1)).float()


#: model -> its ``MoEMlp`` layers with their JAX paths, found once a model
_MOE_LAYERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def sown_aux_losses(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The load-balance losses the last forward of ``model`` kept (Flax's
    ``aux_loss`` collection), keyed by the JAX path of each ``MoEMlp``
    (``block_1/moe``), and cleared on the modules; empty for a model
    without one (every step calls it, so the layers are looked up once)."""
    layers = _MOE_LAYERS.get(model)
    if layers is None:
        layers = _MOE_LAYERS[model] = [(name.replace(".", "/"), m)
                                       for name, m in model.named_modules()
                                       if isinstance(m, MoEMlp)]
    out = {}
    for path, m in layers:
        if m.aux_loss is not None:
            out[path], m.aux_loss = m.aux_loss, None
    return out


def set_expert_parallel(model: nn.Module, group, size: int, index: int) -> None:
    """Each ``MoEMlp`` of ``model`` runs experts ``[index * E / size,
    (index + 1) * E / size)`` over ``group`` (module docstring); its expert
    weights must already hold those rows."""
    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.ep_group, m.expert_offset = group, index * (m.num_experts // size)


@register("vit_moe_s4")
def vit_moe_s4(num_classes: int = 10, generator: Optional[torch.Generator] = None,
               image_size: int = 32, dtype: torch.dtype = torch.float32,
               bn_cross_replica_axis: Optional[str] = None) -> MoEViT:
    """Small MoE ViT for 32x32 inputs: 8 experts, MoE every other block."""
    del bn_cross_replica_axis  # no BatchNorm; the JAX factory ignores it too
    return MoEViT(patch_size=4, hidden_dim=192, depth=6, num_heads=3,
                  num_classes=num_classes, num_experts=8, image_size=image_size,
                  generator=generator, dtype=dtype)


@register("vit_moe_s4_top2")
def vit_moe_s4_top2(num_classes: int = 10, generator: Optional[torch.Generator] = None,
                    image_size: int = 32, dtype: torch.dtype = torch.float32,
                    bn_cross_replica_axis: Optional[str] = None) -> MoEViT:
    """vit_moe_s4 with GShard top-2 routing (normalised pair gates)."""
    del bn_cross_replica_axis
    return MoEViT(patch_size=4, hidden_dim=192, depth=6, num_heads=3,
                  num_classes=num_classes, num_experts=8, top_k=2, image_size=image_size,
                  generator=generator, dtype=dtype)
