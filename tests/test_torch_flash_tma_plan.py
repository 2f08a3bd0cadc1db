"""The bfloat16 K4-K6 load their operands by TMA, which describes a tensor
by a tensor map: a 16-byte-aligned base and batch, token and head strides
that are multiples of 16 bytes. ``tma_operand`` (in
``tpu_ddp_torch/ops/flash_attention.py``) hands the kernels each operand
that ``tma_ready`` as it lies, and any other as a copy with the same values
whose rows lie at D rounded up to 8 elements, zero beyond D, viewed back to
D; the kernels take the score scale from that true D. K6 also reads each
query tile's ``lse`` and ``di`` by TMA: ``tma_rows`` hands them over as they
lie where T is a multiple of 4, else as a copy whose rows lie at T rounded
up to 4, zero beyond T.

On the CPU: the main paths' operands (ViT-S/4's and LM-32k's q, k, v views
of one qkv product, and the gradient dO the backward hands K5 and K6) pass
with no copy; D = 36 tensors, unaligned and non-contiguous views are
copied; the plain versions on the copies equal those on the originals
bitwise and stay within two bf16 units of the JAX Pallas kernels in
interpret mode on the same numpy inputs (of each output's largest value,
and for dk and dv of each key row's), while the same storage read at its
padded width would take the scale of the wrong D."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp_torch.models import CausalTransformerLM, ViT
from tpu_ddp_torch.ops import flash_attention as fa
from tpu_ddp_torch.tools.variants import bf16_row_units

jfa = importlib.import_module("tpu_ddp.ops.flash_attention")

BF16 = torch.bfloat16


def _bf16(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(BF16)


def _ready_and_kept(t):
    out = fa.tma_operand(t)
    return fa.tma_ready(t) and out is t and out.data_ptr() == t.data_ptr()


@pytest.mark.parametrize("B,T,H,D", [(32, 64, 3, 64), (4, 4096, 8, 64)])
def test_qkv_views_pass_as_they_lie(B, T, H, D):
    """The ViT-S/4 and LM-32k shapes' q, k, v: views of one (B, T, 3 H D)
    product, split as the models split it."""
    qkv = torch.empty((B, T, 3 * H * D), dtype=BF16)
    for x in qkv.split(H * D, dim=-1):
        assert _ready_and_kept(x.reshape(B, T, H, D))


def _recorded(model, x, monkeypatch):
    """q, k, v of every K4 call, dO of every K5 call and q, k, v, dO of
    every K6 call in a forward and backward of ``model`` on ``x`` (through
    the plain versions, on the CPU)."""
    seen = []
    fwd, dq, dkv = fa.flash_forward, fa.flash_dq, fa.flash_dkv

    def record_fwd(q, k, v, *args):
        seen.extend([q, k, v])
        return fwd(q, k, v, *args)

    def record_dq(q, k, v, do, *args):
        seen.append(do)
        return dq(q, k, v, do, *args)

    def record_dkv(q, k, v, do, *args):
        seen.extend([q, k, v, do])
        return dkv(q, k, v, do, *args)

    monkeypatch.setattr(fa, "flash_forward", record_fwd)
    monkeypatch.setattr(fa, "flash_dq", record_dq)
    monkeypatch.setattr(fa, "flash_dkv", record_dkv)
    out = model(x)
    out.float().square().mean().backward()
    return seen


def test_vit_s4_path_operands_pass_as_they_lie(monkeypatch):
    """ViT-S/4's widths (hidden 192, 3 heads of 64, 64 tokens) in bfloat16
    under --attention flash: every operand K4, K5 and K6 get is taken as it
    lies."""
    model = ViT(patch_size=4, hidden_dim=192, depth=1, num_heads=3, dtype=BF16)
    model.attention_impl = fa.flash_attention
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    seen = _recorded(model, x, monkeypatch)
    assert len(seen) == 8 and all(t.dtype == BF16 for t in seen)
    assert all(_ready_and_kept(t) for t in seen)


def test_lm_path_operands_pass_as_they_lie(monkeypatch):
    """LM-32k's widths (hidden 512, 8 heads of 64) in bfloat16 with flash
    attention, at 128 tokens: every operand K4, K5 and K6 get is taken as it
    lies."""
    model = CausalTransformerLM(vocab_size=64, hidden_dim=512, depth=1, num_heads=8,
                                seq_len=128, use_flash=True, dtype=BF16)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 128)))
    seen = _recorded(model, tokens, monkeypatch)
    assert len(seen) == 8 and all(t.dtype == BF16 for t in seen)
    assert all(_ready_and_kept(t) for t in seen)


def _views():
    """name -> a bf16 (2, 5, 3, D) tensor TMA cannot take as it lies."""
    base = _bf16((2 * 5 * 3 * 48 + 1,), 1)
    wide = _bf16((2, 5, 3, 52), 2)
    bhtd = _bf16((2, 3, 5, 48), 3)
    return {
        # rows of 72 bytes
        "d36": _bf16((2, 5, 3, 36), 4),
        # a D = 48 view 2 bytes past a 16-byte boundary
        "d48_unaligned": base[1:].view(2, 5, 3, 48),
        # D = 48 of rows of 52: a head stride of 104 bytes
        "d48_of_52": wide[..., :48],
        # (B, H, T, D) transposed: the token stride below the head stride
        "d48_transposed": bhtd.transpose(1, 2),
        # every token the same row: a token stride of 0
        "d48_expanded": _bf16((2, 1, 3, 48), 5).expand(2, 5, 3, 48),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_other_operands_are_copied_and_padded(name):
    t = _views()[name]
    B, T, H, D = t.shape
    assert not fa.tma_ready(t)
    got = fa.tma_operand(t)
    Dp = -(-D // 8) * 8
    assert got.shape == t.shape and got.dtype == BF16
    assert got.stride() == (T * H * Dp, H * Dp, Dp, 1)
    assert got.data_ptr() % 16 == 0 and fa.tma_ready(got)
    assert torch.equal(got, t)
    # the rows' tail beyond D is zero
    padded = got.as_strided((B, T, H, Dp), got.stride())
    assert torch.equal(padded[..., D:], torch.zeros_like(padded[..., D:]))


def test_d48_contiguous_passes_as_it_lies():
    """Rows of 48 bf16 are 96 bytes, a multiple of 16: no copy."""
    assert _ready_and_kept(_bf16((2, 5, 3, 48), 6))


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _np32(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _jax_forward(q, k, v, causal, mask):
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    out = jfa.flash_attention(_jax(q), _jax(k), _jax(v), causal=causal, kv_mask=jmask,
                              interpret=True)
    return _np32(out)


def _jax_dkv(q, k, v, do, causal, mask):
    """dk and dv of the JAX ``flash_attention`` in interpret mode, by
    ``jax.vjp`` with the cotangent ``do``."""
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, causal=causal, kv_mask=jmask, interpret=True), _jax(q), _jax(k), _jax(v))
    _, dk, dv = vjp(_jax(do))
    return _np32(dk), _np32(dv)


@pytest.mark.parametrize("causal,masked", [(False, False), (True, True)])
def test_padded_plain_path_is_the_unpadded_one(causal, masked):
    """D = 36 (the copied case), T = 77 (lse and di copied for K6):
    forward_plain, dq_plain and dkv_plain on the planned operands equal them
    on the originals bitwise; the output stays within two bf16 units of its
    largest value of the JAX kernel's, and dk and dv within two bf16 units
    of each key row's largest value of the JAX gradients; the padded storage
    read at its width of 40 would scale by 1/sqrt(40)."""
    B, T, H, D = 2, 77, 2, 36
    q, k, v, do = (_bf16((B, T, H, D), 10 + i) for i in range(4))
    mask = None
    if masked:
        mask = torch.ones((B, T))
        mask[1, : T // 4] = 0
    planned = [fa.tma_operand(t) for t in (q, k, v, do)]
    assert all(p.data_ptr() != t.data_ptr() for p, t in zip(planned, (q, k, v, do)))
    out, lse = fa.forward_plain(q, k, v, mask, causal)
    p_out, p_lse = fa.forward_plain(*planned[:3], mask, causal)
    assert torch.equal(out, p_out) and torch.equal(lse, p_lse)
    di = fa.row_dot(do, out)
    assert torch.equal(fa.dq_plain(q, k, v, do, lse, di, mask, causal),
                       fa.dq_plain(*planned, lse, di, mask, causal))
    rows = [fa.tma_rows(t) for t in (lse, di)]
    assert all(r.data_ptr() != t.data_ptr() for r, t in zip(rows, (lse, di)))
    dk, dv = fa.dkv_plain(q, k, v, do, lse, di, mask, causal)
    p_dk, p_dv = fa.dkv_plain(*planned, *rows, mask, causal)
    assert torch.equal(dk, p_dk) and torch.equal(dv, p_dv)
    for got, want in zip((p_dk, p_dv), _jax_dkv(q, k, v, do, causal, mask)):
        assert float(bf16_row_units(got, want).max()) <= 2

    want = _jax_forward(q, k, v, causal, mask)
    unit = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    assert float((p_out.float() - want).abs().max()) <= 2 * unit

    wide = [p.as_strided(p.shape[:3] + (40,), p.stride()) for p in planned[:3]]
    w_out, w_lse = fa.forward_plain(*wide, mask, causal)
    assert not torch.equal(w_lse, lse)   # the scale of D = 40
    assert torch.equal(w_out[..., D:], torch.zeros_like(w_out[..., D:]))


@pytest.mark.parametrize("T", [1, 77, 100, 4096])
def test_row_statistics_plan(T):
    """K6's lse and di rows: T a multiple of 4 (the LM's 4,096, 100) as they
    lie; else (77, 1) a copy whose rows lie at T rounded up to 4, bitwise
    the original over T and zero beyond it."""
    t = torch.from_numpy(np.random.default_rng(T).standard_normal((2, 3, T))
                         .astype(np.float32))
    got = fa.tma_rows(t)
    Tp = -(-T // 4) * 4
    if T % 4 == 0:
        assert got is t
        return
    assert got.shape == t.shape and got.stride() == (3 * Tp, Tp, 1)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
    padded = got.as_strided((2, 3, Tp), got.stride())
    assert torch.equal(padded[..., T:], torch.zeros_like(padded[..., T:]))


def test_plan_runs_only_for_bfloat16_on_the_card():
    """float32 operands, which the 3xTF32 kernels read by cp.async with any
    strides, are not the plan's: the CPU wrapper returns the plain version
    whatever the layout."""
    q, k, v = (_bf16((2, 5, 3, 36), 20 + i).float() for i in range(3))
    out, _ = fa.flash_forward(q, k, v)
    assert out.dtype == torch.float32 and torch.equal(out, fa.forward_plain(q, k, v)[0])
