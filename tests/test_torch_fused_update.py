"""K1 (the fused optimizer update) in the PyTorch port against the JAX
package. On the CPU the port's wrapper runs the kernel's plain version,
``update_math``; the JAX side runs as ``tests/test_fused_kernels.py`` runs
it: ``make_optimizer(kernels=True).fused.apply`` (the bit-exact jnp mirror
of the optax chain) or ``FusedUpdate(recipe, interpret=True)`` (the Pallas
interpreter). The port's plain optax-order chain (``kernels=False``) is held
to the same reference.

Tolerance ``rtol=3e-6, atol=1e-7`` (the one of test_fused_kernels.py's
interpret test): XLA:CPU may contract a multiply and an add into one FMA
where torch rounds twice, and its pow/cos/sum orders differ by an ulp."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import jax
import numpy as np
import pytest
import torch

from tpu_ddp.ops.fused_update import FusedUpdate as JaxFusedUpdate
from tpu_ddp.train.optim import make_optimizer as jax_make_optimizer
from tpu_ddp_torch.checkpoint.convert import convert_tree, from_jax
from tpu_ddp_torch.ops import LAUNCHES
from tpu_ddp_torch.ops.fused_update import LeafConfig, fused_update_, update_math
from tpu_ddp_torch.train.optim import make_optimizer

TOL = dict(rtol=3e-6, atol=1e-7)

VARIANTS = {
    "sgd": dict(optimizer="sgd", lr=1e-2),
    "sgd_mom_wd_clip_ema": dict(optimizer="sgd", lr=1e-2, momentum=0.9,
                                weight_decay=5e-4, grad_clip_norm=1.0,
                                ema_decay=0.99),
    "adamw_wd_clip_ema": dict(optimizer="adamw", lr=1e-2, weight_decay=0.05,
                              grad_clip_norm=1.0, ema_decay=0.99),
}
SCHEDULES = {
    "constant": {},
    "cosine": dict(schedule="cosine", total_steps=10, warmup_steps=2),
}
N_STEPS = 3


def _tree(rng, scale=1.0):
    def arr(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    # a conv kernel and a dense kernel (decayed, transposed by the
    # converter), a bias and a BatchNorm scale (not decayed)
    return {"conv": {"kernel": arr(3, 3, 4, 8)},
            "dense": {"kernel": arr(40, 16), "bias": arr(16)},
            "bn": {"scale": arr(8)}}


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    # the last step's grads are small: the clip branch not taken
    grads = [_tree(rng, scale) for scale in (1.0, 3.0, 1e-3)][:N_STEPS]
    return params, grads


def _jax_apply(jax_side, kw):
    fused = jax_make_optimizer(kernels=True, **kw).fused
    assert fused is not None
    if jax_side == "interpret":
        fused = JaxFusedUpdate(fused.recipe, interpret=True)
    return jax.jit(fused.apply)


def _compare_state(got, want):
    for slot in ("trace", "mu", "nu", "ema"):
        w, g = getattr(want, slot), getattr(got, slot)
        assert (w is None) == (g is None), slot
        for name in w or {}:
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                       **TOL, err_msg=f"{slot} {name}")
    for slot in ("count", "sched_count"):
        w, g = getattr(want, slot), getattr(got, slot)
        assert (w is None) == (g is None), slot
        if w is not None:
            assert int(g) == int(w), slot


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("jax_side,port_kernels", [
    ("mirror", True), ("interpret", True), ("mirror", False)])
def test_update_matches_jax(variant, schedule, jax_side, port_kernels):
    kw = dict(VARIANTS[variant], **SCHEDULES[schedule])
    params, grads = _problem()
    jax_apply = _jax_apply(jax_side, kw)
    jax_tx = jax_make_optimizer(kernels=True, **kw)
    j_params, j_state = params, jax_tx.init(params)

    tx = make_optimizer(kernels=port_kernels, **kw)
    p = from_jax(params, {})["model"]
    state = tx.init(p)
    for g in grads:
        j_params, j_u, j_state = jax_apply(g, j_state, j_params)
        j_params, j_u, j_state = jax.device_get((j_params, j_u, j_state))
        u = tx.apply(convert_tree(g), state, p)
        for name, want in convert_tree(j_params).items():
            np.testing.assert_allclose(p[name].numpy(), want.numpy(), **TOL,
                                       err_msg=f"param {name}")
        for name, want in convert_tree(j_u).items():
            np.testing.assert_allclose(u[name].numpy(), want.numpy(), **TOL,
                                       err_msg=f"update {name}")
        _compare_state(state, from_jax({}, {}, j_state)["opt_state"])


def _leaf_operands(n, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda: torch.from_numpy(rng.standard_normal(n).astype(np.float32))  # noqa: E731
    g, p, m, e = t(), t(), t(), t()
    v = t().abs()
    scalars = torch.tensor([2.5, -0.01, 0.1, 0.001], dtype=torch.float32)
    return g, p, m, v, e, scalars


@pytest.mark.parametrize("kind,momentum,step_const", [
    ("sgd", 0.0, -0.01), ("sgd", 0.9, None), ("adamw", 0.0, -0.001)])
def test_cpu_wrapper_is_plain_version_in_place(kind, momentum, step_const):
    """On CPU tensors the wrapper is ``update_math``, bit for bit, written
    in place, and it counts no kernel launch."""
    cfg = LeafConfig(kind=kind, momentum=momentum, wd=5e-4, wd_apply=True,
                     has_clip=True, max_norm=1.0, step_const=step_const,
                     ema_decay=0.99, b1=0.9, b2=0.999, eps=1e-8)
    g, p, m, v, e, scalars = _leaf_operands(1000)
    u_want, m_want, v_want, e_want = update_math(g, p, m, v, e, scalars, cfg)
    p_want = p + u_want
    u = torch.empty_like(p)
    before = LAUNCHES["fused_update"]
    fused_update_(g, p, m, v, e, u, scalars, cfg)
    assert LAUNCHES["fused_update"] == before
    assert torch.equal(u, u_want) and torch.equal(p, p_want)
    assert torch.equal(e, e_want)
    if cfg.has_m:
        assert torch.equal(m, m_want)
    if cfg.has_v:
        assert torch.equal(v, v_want)


def test_registry_resolves_and_reports_no_kernel_without_cuda(monkeypatch):
    from tpu_ddp_torch import ops

    entry = ops.resolve("fused_update")
    assert entry["wrapper"] is fused_update_ and entry["plain"] is update_math
    assert entry["route"] == "cuda" and "dp" in entry["strategies"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ops.kernel_available("fused_update") is False


def test_wrapper_refuses_what_the_kernel_does_not_take():
    cfg = LeafConfig(kind="sgd", momentum=0.0, wd=0.0, wd_apply=False,
                     has_clip=False, max_norm=0.0, step_const=-0.01,
                     ema_decay=0.0, b1=0.9, b2=0.999, eps=1e-8)
    g, p, _, _, _, scalars = _leaf_operands(64)
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_update_(g.to("meta"), p.to("meta"), None, None, None,
                      torch.empty(64, device="meta"), scalars.to("meta"), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fused_update_(g.view(8, 8).t(), p.view(8, 8), None, None, None,
                      torch.empty(8, 8), scalars, cfg)
    with pytest.raises(ValueError, match="elements"):
        fused_update_(g[:32], p, None, None, None, torch.empty(64), scalars, cfg)
    with pytest.raises(ValueError, match="share storage"):
        fused_update_(g, p, None, None, None, p, scalars, cfg)
    with pytest.raises(ValueError, match="float32"):
        fused_update_(g.double(), p, None, None, None, torch.empty(64),
                      scalars, cfg)
