"""Flash attention in the PyTorch port against the JAX package, on the same
numpy inputs.

On the CPU the port's ``flash_attention`` goes through the
``FlashAttention`` autograd function, which runs the plain versions of its
three kernels (``forward_plain``, ``dq_plain``, ``dkv_plain``: the CUDA
kernels' arithmetic on whole score matrices); ``reference`` is the plain
attention with autograd through it. Each is held against the JAX
``flash_attention`` run as ``tests/test_ops.py`` runs it on the CPU (Pallas
in interpret mode, blocks of 64; a prime T takes the JAX package's jnp
path) and against its ``_reference``, forward and q/k/v gradients under a
weighted cotangent. The kernels' own outputs are held against the Pallas
kernels': K4's row log-sum-exp against ``_flash_forward``'s, and K5/K6
against ``_flash_backward``.

Tolerances are those of ``tests/test_ops.py``: forward ``atol=2e-5``
(``5e-5``/``rtol=5e-5`` for the sharp logits), gradients ``atol=5e-5``,
``rtol=1e-4``."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.ops import flash_attention as fa

FWD_TOL = dict(atol=2e-5, rtol=0)
SHARP_TOL = dict(atol=5e-5, rtol=5e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)

# ``tpu_ddp.ops`` binds the name ``flash_attention`` to the function, which
# hides the module from ``from tpu_ddp.ops import flash_attention``
jfa = importlib.import_module("tpu_ddp.ops.flash_attention")

#: name -> (B, T, H, D, seed, q scale, causal, kv mask kind)
CASES = {
    "plain": (2, 128, 2, 64, 0, 1.0, False, None),
    "d48": (2, 128, 2, 48, 1, 1.0, False, None),
    "sharp": (2, 128, 2, 64, 2, 8.0, False, None),
    "causal": (2, 128, 2, 64, 3, 1.0, True, None),
    "mask_dead_rows": (2, 128, 2, 64, 4, 1.0, True, "dead"),
    "prime_t67": (1, 67, 2, 32, 5, 1.0, True, "tail"),
    "d128": (1, 128, 2, 128, 6, 1.0, False, None),
}
PORT_IMPLS = ("reference", "flash_attention_cpu", "kernel_functions")


def _mask(kind, B, T):
    """(B, T) float32 key mask: ragged lengths; "dead" also hides a prefix
    of batch 1, so under causal its first T//4 queries see no key."""
    if kind is None:
        return None
    m = np.ones((B, T), np.float32)
    m[0, 3 * T // 4:] = 0
    if kind == "dead":
        m[1, :T // 4] = 0
    return m


@functools.lru_cache(maxsize=None)
def _inputs(case):
    B, T, H, D, seed, qs, causal, mkind = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    return q * np.float32(qs), k, v, g, _mask(mkind, B, T), causal


@functools.lru_cache(maxsize=None)
def _jax_results(case, impl):
    """(out, dq, dk, dv) of the JAX package under the cotangent g."""
    q, k, v, g, mask, causal = _inputs(case)
    jm = None if mask is None else jnp.asarray(mask)
    if impl == "flash":
        fn = lambda a, b, c: jfa.flash_attention(  # noqa: E731
            a, b, c, 64, 64, True, causal=causal, kv_mask=jm)
    else:
        fn = lambda a, b, c: jfa._reference(a, b, c, causal=causal,  # noqa: E731
                                            kv_mask=jm)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(g))
    return tuple(np.asarray(x) for x in (out,) + tuple(grads))


def _port_results(case, impl):
    q, k, v, g, mask, causal = _inputs(case)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tm = None if mask is None else torch.tensor(mask)
    if impl == "reference":
        out = fa.reference(tq, tk, tv, causal=causal, kv_mask=tm)
    elif impl == "flash_attention_cpu":
        out = fa.flash_attention(tq, tk, tv, causal=causal, kv_mask=tm)
    else:
        out = fa.FlashAttention.apply(tq, tk, tv, tm, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    return tuple(x.detach().numpy() for x in (out,) + grads)


@pytest.mark.parametrize("oracle", ["flash", "reference"])
@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_port_matches_jax(case, impl, oracle):
    want = _jax_results(case, oracle)
    got = _port_results(case, impl)
    fwd_tol = SHARP_TOL if case == "sharp" else FWD_TOL
    np.testing.assert_allclose(got[0], want[0], **fwd_tol, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_dead_rows_are_exact_zeros(impl):
    """Batch 1's first T//4 queries see no key (causal + prefix mask): their
    output and their dq are exactly 0, and no gradient is NaN."""
    T = CASES["mask_dead_rows"][1]
    out, dq, dk, dv = _port_results("mask_dead_rows", impl)
    assert np.all(out[1, :T // 4] == 0.0)
    assert np.all(dq[1, :T // 4] == 0.0)
    # the hidden keys get no gradient either
    assert np.all(dk[1, :T // 4] == 0.0) and np.all(dv[1, :T // 4] == 0.0)


@functools.lru_cache(maxsize=None)
def _pallas_kernels(case):
    """The Pallas kernels in interpret mode: ``_flash_forward``'s ``(out,
    lse)``, its lse as ``(B, H, T)``, and ``_flash_backward``'s ``(dq, dk,
    dv)`` from those residuals under the cotangent g, all as numpy."""
    q, k, v, g, mask, causal = _inputs(case)
    B, T, H, D = q.shape
    jm = None if mask is None else jnp.asarray(mask)
    j_out, j_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, block_q=64,
        block_k=64, interpret=True, causal=causal)
    assert j_lse is not None  # the Pallas kernel ran, not the jnp path
    grads = jfa._flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_out, j_lse,
        jnp.asarray(g), jm, block_q=64, block_k=64, interpret=True,
        causal=causal)
    lse = np.asarray(j_lse)[:, :, 0].reshape(B, H, T)
    return (np.asarray(j_out), lse) + tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("case", [c for c in CASES if c != "prime_t67"])
def test_kernel_plain_versions_match_pallas_kernels(case):
    """K4's ``(out, lse)`` against ``_flash_forward`` (its lane-broadcast
    ``(B*H, T, 128)`` lse, column 0), and K5/K6 against ``_flash_backward``
    given the same forward residuals: the plain versions that the CUDA
    kernels are held to on the card compute what the Pallas kernels do."""
    q, k, v, g, mask, causal = _inputs(case)
    j_out, j_lse, jdq, jdk, jdv = _pallas_kernels(case)
    tq, tk, tv, tg = (torch.tensor(x) for x in (q, k, v, g))
    tm = None if mask is None else torch.tensor(mask)
    out, lse = fa.flash_forward(tq, tk, tv, tm, causal)
    fwd_tol = SHARP_TOL if case == "sharp" else FWD_TOL
    np.testing.assert_allclose(out.numpy(), j_out, **fwd_tol)
    np.testing.assert_allclose(lse.numpy(), j_lse, **fwd_tol)

    di = fa.row_dot(tg, out)
    dq = fa.flash_dq(tq, tk, tv, tg, lse, di, tm, causal)
    dk, dv = fa.flash_dkv(tq, tk, tv, tg, lse, di, tm, causal)
    for name, a, b in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL, err_msg=name)


def _tf32_split(x: torch.Tensor):
    """K5/K6's operand split on int32 views, as the tensor core sees it:
    ``hi = tf32(x)``, rounded as K4 rounds it (add half a TF32 unit to the
    bit pattern, clear the 13 bits below it), and ``lo = x - hi``, handed
    over unrounded, of which the tensor core reads the top 19 bits."""
    def bits(t):
        return t.contiguous().view(torch.int32)

    hi = ((bits(x) + 0x1000) & -0x2000).view(torch.float32)
    return hi, (bits(x - hi) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels form it: three products of TF32 values
    (lo.hi + hi.lo, then hi.hi; lo.lo dropped), summed in float32."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated_backward(case, lse, out):
    """dq, dk, dv by K5/K6's arithmetic on whole (T, T) matrices: S and dP
    in 3xTF32, ``p = 2^(s * scale2 - lse * log2e)`` rounded once (the
    kernels' fma; ``scale2 = scale * log2e`` in float32), invisible entries
    0 by selection, ``ds = p * (dp - di) * scale``, then dQ, dK and dV in
    3xTF32."""
    q, k, v, g, mask, causal = _inputs(case)
    B, T, H, D = q.shape
    log2e = np.float32(1.4426950408889634)
    scale = np.float32(1.0 / np.sqrt(D))
    scale2 = np.float32(scale * log2e)
    tq, tk, tv, tg = (torch.tensor(x).transpose(1, 2) for x in (q, k, v, g))
    di = torch.tensor((g * out).sum(-1)).transpose(1, 2)          # (B, H, T)
    lse2 = torch.tensor(lse) * float(log2e)
    s = _mm_3xtf32(tq, tk.transpose(-1, -2))
    dp = _mm_3xtf32(tg, tv.transpose(-1, -2))
    arg = (s.double() * float(scale2) - lse2[..., None].double()).float()
    vis = torch.ones((T, T), dtype=torch.bool)
    if causal:
        vis = torch.tril(vis)
    vis = vis[None, None]
    if mask is not None:
        vis = vis & torch.tensor(mask > 0)[:, None, None, :]
    p = torch.where(vis, torch.exp2(arg), torch.zeros(()))
    ds = p * (dp - di[..., None]) * float(scale)
    dq = _mm_3xtf32(ds, tk)
    dk = _mm_3xtf32(ds.transpose(-1, -2), tq)
    dv = _mm_3xtf32(p.transpose(-1, -2), tg)
    return tuple(x.transpose(1, 2).numpy() for x in (dq, dk, dv))


@pytest.mark.parametrize("case", ["plain", "d48", "causal", "mask_dead_rows", "d128"])
def test_kernel_arithmetic_emulated_matches_pallas_backward(case):
    """The precision argument of K5/K6 on the card, pinned on the CPU: their
    arithmetic (3xTF32 products, base-2 exp from ``lse * log2e``) emulated
    in torch is within ``tests/test_ops.py``'s gradient tolerance of the
    Pallas ``_flash_backward`` given the same forward residuals; dead rows'
    dq and masked keys' dk and dv stay exactly 0."""
    j_out, j_lse, jdq, jdk, jdv = _pallas_kernels(case)
    got = _emulated_backward(case, j_lse, j_out)
    for name, a, b in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=name)
    mask = _inputs(case)[4]
    if mask is not None:
        T = mask.shape[1]
        hidden = mask == 0
        assert np.all(got[0][1, :T // 4] == 0.0)
        assert np.all(got[1][hidden] == 0.0) and np.all(got[2][hidden] == 0.0)


def test_strided_qkv_views_match_contiguous():
    """The ViT hands the kernels views of its qkv split; the wrappers take
    them as they are (strides, not copies) and give the contiguous result."""
    rng = np.random.default_rng(7)
    B, T, H, D = 2, 64, 3, 16
    qkv = torch.tensor(rng.standard_normal((B, T, 3 * H * D)).astype(np.float32))
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous() and q.stride(-1) == 1
    out, lse = fa.flash_forward(q, k, v)
    want, want_lse = fa.flash_forward(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    ops.reset_launch_counts()
    q, k, v, g, mask, causal = _inputs("causal")
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.FlashAttention.apply(tq, tk, tv, None, True)
    out.backward(torch.tensor(g))
    fa.flash_attention(tq, tk, tv, causal=True).sum().backward()
    assert all(n == 0 for n in ops.launch_counts().values())
    sources = {fa.FWD: "flash_forward.cu", fa.DQ: "flash_attention.cu",
               fa.DKV: "flash_attention.cu"}
    for name, source in sources.items():
        entry = ops.resolve(name)
        assert entry["route"] == "cuda"
        assert entry["source"] == "tpu_ddp_torch/ops/csrc/" + source
        assert entry["wrapper"].__module__ == fa.__name__
    assert ops.KERNELS[fa.FWD]["replaces"] == "tpu_ddp/ops/flash_attention.py:108"
    assert ops.KERNELS[fa.DQ]["replaces"] == "tpu_ddp/ops/flash_attention.py:327"
    assert ops.KERNELS[fa.DKV]["replaces"] == "tpu_ddp/ops/flash_attention.py:366"


@pytest.mark.parametrize("shape,dtype,match", [
    ((1, 8, 1, 160), torch.float32, "head dim 160 is above the kernels' limit of 128"),
    ((1, 8, 1, 16), torch.float64, "float32 only"),
])
def test_limits_raise(shape, dtype, match):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, q, q)


def test_other_devices_raise():
    q = torch.zeros((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fa.flash_forward(q, q, q)


def test_each_library_has_its_own_flags_in_its_hash(monkeypatch):
    """K1 keeps ``-fmad=false`` (bitwise with its plain version); the flash
    kernels, held to a tolerance, do not take it, and K4-K6, whose launch
    bounds set their register caps, take no ``-maxrregcount``; the build's
    file name covers the flags a library is built with."""
    from tpu_ddp_torch.ops import _build

    assert "-fmad=false" in _build.flags("fused_update")
    for name in ("flash_forward", "flash_attention"):
        assert not any(f.startswith(("-fmad", "-maxrregcount"))
                       for f in _build.flags(name)), name
    before = _build.library_path("flash_attention")
    source, extra, fns = _build.LIBRARIES["flash_attention"]
    monkeypatch.setitem(_build.LIBRARIES, "flash_attention",
                        (source, extra + ("-lineinfo",), fns))
    assert _build.library_path("flash_attention") != before
    assert all(e["library"] in _build.LIBRARIES for e in ops.KERNELS.values())


def test_k4_design_variants_edit_the_source_once():
    """``tools/k4_variants.py`` rebuilds K4 with one design choice undone
    by textual edits of ``flash_forward.cu``; each edit must still find
    its text exactly once."""
    from tpu_ddp_torch.ops import _build
    from tpu_ddp_torch.tools import k4_variants

    src = (_build.CSRC / _build.LIBRARIES[k4_variants.LIBRARY][0]).read_text()
    assert k4_variants.VARIANTS["built"] == []
    for name, edits in k4_variants.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


def test_k56_design_variants_edit_the_source_once():
    """``tools/k56_variants.py`` rebuilds K5/K6 with one design choice
    undone by textual edits of ``flash_attention.cu``; each edit must still
    find its text exactly once."""
    from tpu_ddp_torch.ops import _build
    from tpu_ddp_torch.tools import k56_variants

    src = (_build.CSRC / _build.LIBRARIES[k56_variants.LIBRARY][0]).read_text()
    assert k56_variants.VARIANTS["built"] == []
    for name, edits in k56_variants.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
