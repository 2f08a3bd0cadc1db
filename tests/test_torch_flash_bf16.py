"""Flash attention in bfloat16: the port's K4-K6 plain versions against the
JAX Pallas kernels in interpret mode, on the same bfloat16 inputs.

On the CPU the port's ``flash_attention`` runs ``FlashAttention`` through
the plain versions of its three kernels, in the bfloat16 dtype flow of the
CUDA kernels (``tpu_ddp_torch/ops/flash_attention.py``): exact products
summed in float32, p and ds rounded to bfloat16 before P V, dS K, Pᵀ dO
and dSᵀ Q, float32 ``lse`` and ``di``, bfloat16 results. The JAX kernels
promote the bfloat16 operand of those four products to float32 instead, so
the two differ by the rounding of p and ds and by the final rounding of
each output. Tolerance: two bfloat16 units in the last place of the largest
``|value|`` of each output (``bf16_atol``); measured on these cases the
largest difference is at most one such unit. ``lse`` is float32 on both
sides: ``atol=2e-5``, ``tests/test_ops.py``'s forward tolerance.

``reference`` keeps the JAX ``_reference``'s dtype flow on bfloat16 inputs
(scores rounded to bfloat16, then float32; a float32 output): its output
within ``atol=1e-5`` of JAX's, its bfloat16 gradients within
``bf16_atol``."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.ops import flash_attention as fa

jfa = importlib.import_module("tpu_ddp.ops.flash_attention")

#: name -> (B, T, H, D, causal, kv mask kind)
CASES = {
    "t64_d32": (2, 64, 2, 32, False, None),
    "t64_d32_causal": (2, 64, 2, 32, True, None),
    "t128_d64": (1, 128, 2, 64, False, None),
    "t128_d64_causal": (1, 128, 2, 64, True, None),
    "t128_d64_causal_dead": (2, 128, 2, 64, True, "dead"),
}
#: the cases whose Pallas kernels are also run one by one
KERNEL_CASES = ("t64_d32", "t128_d64_causal", "t128_d64_causal_dead")
LSE_TOL = dict(atol=2e-5, rtol=0)


def bf16_atol(want, ulps=2):
    """``ulps`` bfloat16 units in the last place of the largest ``|want|``."""
    top = float(np.max(np.abs(np.asarray(want, np.float32))))
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def assert_bf16_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.all(np.isfinite(got)), what
    np.testing.assert_allclose(got, want, rtol=0, atol=bf16_atol(want), err_msg=what)


@pytest.fixture(autouse=True, scope="module")
def _drop_cached_jax_results():
    """Clear this module's caches when its tests end: their results can be
    numpy views of JAX buffers, which would otherwise stay alive in the
    worker process and count in a later file's ``jax.live_arrays()``
    (``tests/test_memtrack.py``)."""
    yield
    for fn in (_inputs, _jax_flash,):
        fn.cache_clear()


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """q, k, v, g as bfloat16-exact float32 numpy arrays, and the mask."""
    B, T, H, D, causal, mask_kind = CASES[case]
    rng = np.random.default_rng(T + D)
    q, k, v, g = (np.asarray(jnp.asarray(rng.standard_normal((B, T, H, D)), jnp.bfloat16)
                             .astype(jnp.float32)) for _ in range(4))
    mask = None
    if mask_kind == "dead":
        mask = np.ones((B, T), np.float32)
        mask[0, 3 * T // 4:] = 0
        mask[1, :T // 4] = 0      # under causal its first T/4 queries see no key
    return q, k, v, g, mask, causal


def _jax(x):
    return jnp.asarray(x, jnp.bfloat16)


def _torch(x, grad=False):
    return torch.tensor(x).to(torch.bfloat16).requires_grad_(grad)


@functools.lru_cache(maxsize=None)
def _jax_flash(case):
    """The JAX ``flash_attention`` in interpret mode, forward and vjp."""
    q, k, v, g, mask, causal = _inputs(case)
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, 64, 64, True, causal=causal, kv_mask=jm), _jax(q), _jax(k), _jax(v))
    grads = vjp(_jax(g))
    assert out.dtype == jnp.bfloat16 and all(x.dtype == jnp.bfloat16 for x in grads)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (out, *grads))


@pytest.mark.parametrize("impl", ["flash_attention", "FlashAttention.apply"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_flash_attention_matches_pallas(case, impl):
    q, k, v, g, mask, causal = _inputs(case)
    tq, tk, tv = (_torch(x, grad=True) for x in (q, k, v))
    tm = None if mask is None else torch.tensor(mask)
    ops.reset_launch_counts()
    if impl == "flash_attention":
        out = fa.flash_attention(tq, tk, tv, causal=causal, kv_mask=tm)
    else:
        out = fa.FlashAttention.apply(tq, tk, tv, tm, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), _torch(g))
    assert all(n == 0 for n in ops.launch_counts().values())   # the plain path
    assert out.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in grads)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), _jax_flash(case)):
        assert_bf16_close(got.detach().float().numpy(), want, name)
    if mask is not None:
        T = q.shape[1]
        assert torch.all(out[1, :T // 4] == 0) and torch.all(grads[0][1, :T // 4] == 0)
        hidden = torch.tensor(mask == 0)
        assert torch.all(grads[1][hidden] == 0) and torch.all(grads[2][hidden] == 0)


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_bf16_plain_kernels_match_pallas_kernels(case):
    """K4's ``(out, lse)`` against ``_flash_forward`` in interpret mode, and
    K5/K6 against ``_flash_backward`` given the same forward residuals (the
    Pallas ``out`` and ``lse``) and ``di`` from them, all on bfloat16."""
    q, k, v, g, mask, causal = _inputs(case)
    B, T, H, D = q.shape
    jm = None if mask is None else jnp.asarray(mask)
    j_out, j_lse = jfa._flash_forward(_jax(q), _jax(k), _jax(v), jm, block_q=64,
                                      block_k=64, interpret=True, causal=causal)
    assert j_lse is not None and j_out.dtype == jnp.bfloat16
    jdq, jdk, jdv = jfa._flash_backward(_jax(q), _jax(k), _jax(v), j_out, j_lse, _jax(g),
                                        jm, block_q=64, block_k=64, interpret=True,
                                        causal=causal)
    j_lse = np.asarray(j_lse)[:, :, 0].reshape(B, H, T)

    tq, tk, tv, tg = (_torch(x) for x in (q, k, v, g))
    tm = None if mask is None else torch.tensor(mask)
    out, lse = fa.flash_forward(tq, tk, tv, tm, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert_bf16_close(out.float().numpy(), np.asarray(j_out.astype(jnp.float32)), "out")
    np.testing.assert_allclose(lse.numpy(), j_lse, **LSE_TOL)

    t_out = torch.tensor(np.asarray(j_out.astype(jnp.float32))).to(torch.bfloat16)
    di = fa.row_dot(tg, t_out)
    assert di.dtype == torch.float32
    t_lse = torch.tensor(j_lse)
    dq = fa.flash_dq(tq, tk, tv, tg, t_lse, di, tm, causal)
    dk, dv = fa.flash_dkv(tq, tk, tv, tg, t_lse, di, tm, causal)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == torch.bfloat16, name
        assert_bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), name)


@pytest.mark.parametrize("case", ["t64_d32", "t128_d64_causal_dead"])
def test_bf16_reference_matches_jax_reference(case):
    """``reference`` on bfloat16 inputs returns float32 as ``_reference``
    does (bf16-rounded scores, then float32), and its bfloat16 gradients
    match under a float32 cotangent."""
    q, k, v, g, mask, causal = _inputs(case)
    jm = None if mask is None else jnp.asarray(mask)
    j_out, vjp = jax.vjp(lambda a, b, c: jfa._reference(a, b, c, causal=causal, kv_mask=jm),
                         _jax(q), _jax(k), _jax(v))
    assert j_out.dtype == jnp.float32
    j_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (_torch(x, grad=True) for x in (q, k, v))
    tm = None if mask is None else torch.tensor(mask)
    out = fa.reference(tq, tk, tv, causal=causal, kv_mask=tm)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    for name, got, want in zip(("dq", "dk", "dv"), grads, j_grads):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, name
        assert_bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), name)


def test_bf16_plain_versions_round_p_and_ds():
    """The design the kernels take: P V on p rounded to bfloat16 (the
    rounding shows: the result differs from the unrounded product's), the
    division by the row sum of the unrounded p after it."""
    q, k, v, g, mask, causal = _inputs("t64_d32")
    tq, tk, tv = (_torch(x) for x in (q, k, v))
    out, _ = fa.forward_plain(tq, tk, tv)
    s = fa._scores(tq, tk, None)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).transpose(1, 2)[..., None]
    for p_used, same in ((p.to(torch.bfloat16).float(), True), (p, False)):
        o = torch.einsum("bhqk,bkhd->bqhd", p_used, tv.float()) / l
        assert torch.equal(out, o.to(torch.bfloat16)) is same
