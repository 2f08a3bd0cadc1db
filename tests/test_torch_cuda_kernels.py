"""The port's kernels on the card: K1, the int8 quantize and dequantize K2
and K3, and the flash-attention kernels K4-K6 against their plain PyTorch
versions, and train steps that go through them.
These need an NVIDIA GPU and nvcc and skip without them; run them on a GPU
machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``chip_smoke.py`` holds the kernels to the same comparisons at the main
path's sizes.) K1 runs every leaf of a step in one launch. K1, K2 and K3
are held bitwise (K2's int8 bytes of a block
whose scale is not finite excepted: there the scales agree and the block
dequantizes non-finite); K4-K6 are held to the tolerances of ``tests/test_ops.py``:
forward ``atol=2e-5``, gradients ``atol=5e-5``, ``rtol=1e-4``."""

import numpy as np
import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.ops.fused_update import LeafBatch, LeafConfig, fused_update_, update_math

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,momentum,ema,step_const,wd,clip", [
    ("sgd", 0.0, 0.0, -0.01, 5e-4, True), ("sgd", 0.9, 0.99, None, 5e-4, True),
    ("adamw", 0.0, 0.99, -0.001, 5e-4, True),
    # the ViT path's recipe: AdamW, no decay, no clip, no EMA, constant lr
    ("adamw", 0.0, 0.0, -0.001, 0.0, False)])
@pytest.mark.parametrize("n,offset", [(1, 0), (127, 0), (65536, 0), (1003, 1)])
def test_kernel_bitwise_equal_to_plain(cuda, kind, momentum, ema, step_const,
                                       wd, clip, n, offset):
    cfg = LeafConfig(kind=kind, momentum=momentum, wd=wd, wd_apply=wd > 0,
                     has_clip=clip, max_norm=1.0 if clip else 0.0,
                     step_const=step_const, ema_decay=ema, b1=0.9, b2=0.999,
                     eps=1e-8)
    gen = torch.Generator(device=cuda).manual_seed(n)
    t = lambda: torch.randn(n + offset, generator=gen, device=cuda)[offset:]  # noqa: E731
    g, p, m, v, e = t(), t(), t(), t().abs(), t()
    scalars = torch.tensor([3.0, -0.007, 0.271, 0.002997], device=cuda)
    u_ref, m_ref, v_ref, e_ref = update_math(g, p, m, v, e, scalars, cfg)
    p_ref = p + u_ref
    u = torch.empty(n + offset, device=cuda)[offset:]
    before = ops.LAUNCHES["fused_update"]
    fused_update_(g, p, m, v, e, u, scalars, cfg)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_update"] == before + 1
    assert torch.equal(u, u_ref) and torch.equal(p, p_ref)
    for got, want in ((m, m_ref), (v, v_ref), (e, e_ref)):
        if want is not None:
            assert torch.equal(got, want)


#: (elements, offset in floats from a 16-byte boundary, decayed)
MIXED = [(4096, 0, True), (333, 0, False), (1000, 1, True), (100_003, 1, False),
         (65_541, 0, True), (7, 3, False), (16_384, 2, True), (0, 0, True)]


@pytest.mark.parametrize("kind,momentum,ema,step_const", [
    ("sgd", 0.0, 0.0, -0.01), ("sgd", 0.9, 0.99, None), ("adamw", 0.0, 0.99, -0.001)])
def test_one_launch_bitwise_over_mixed_leaves(cuda, kind, momentum, ema, step_const):
    """Aligned and unaligned leaves, decayed and not, small and spanning
    several blocks' chunks, in one launch, each bitwise equal to
    ``update_math``."""
    cfg = LeafConfig(kind=kind, momentum=momentum, wd=5e-4, wd_apply=False,
                     has_clip=True, max_norm=1.0, step_const=step_const,
                     ema_decay=ema, b1=0.9, b2=0.999, eps=1e-8)
    gen = torch.Generator(device=cuda).manual_seed(4)
    t = lambda n, o: torch.randn(n + o, generator=gen, device=cuda)[o:]  # noqa: E731
    leaves = [dict(g=t(n, o), p=t(n, o), m=t(n, o), v=t(n, o).abs(), e=t(n, o),
                   u=torch.empty(n + o, device=cuda)[o:]) for n, o, _ in MIXED]
    scalars = torch.tensor([3.0, -0.007, 0.271, 0.002997], device=cuda)
    want = []
    for lf, (_, _, wd) in zip(leaves, MIXED):
        c = LeafConfig(**{**cfg.__dict__, "wd_apply": wd})
        u, m, v, e = update_math(lf["g"], lf["p"], lf["m"], lf["v"], lf["e"], scalars, c)
        want.append(dict(u=u, p=lf["p"] + u, m=m, v=v, e=e))
    ops.reset_launch_counts()
    batch = LeafBatch(*([lf[k] for lf in leaves] for k in "pmve"), cfg,
                      [wd for _, _, wd in MIXED], us=[lf["u"] for lf in leaves])
    batch.run([lf["g"] for lf in leaves], scalars)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_update"] == 1
    for lf, w in zip(leaves, want):
        for k, ref in w.items():
            if ref is not None:
                assert torch.equal(lf[k], ref), k


def test_train_step_launches_k1_once_a_step(cuda):
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

    tx = make_optimizer(lr=1e-2, kernels=True)
    state = create_train_state(NetResDeep(), tx, cuda)
    images, labels = synthetic_cifar10(32, 10, 0)
    batch = batch_to_device({"image": images, "label": labels,
                             "mask": np.ones(32, bool)}, cuda)
    step = make_train_step(tx)
    ops.reset_launch_counts()
    for _ in range(2):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_update"] == 2
    assert torch.isfinite(metrics["loss"])


#: (B, T, H, D, causal, kv mask kind, qkv as views of one product)
FLASH_CASES = {
    "vit_s4": (4, 64, 3, 64, False, None, True),
    "t196": (2, 196, 2, 64, False, None, False),
    "d48": (2, 128, 2, 48, False, None, False),
    "t67_causal_tail": (1, 67, 2, 32, True, "tail", False),
    "causal_dead_rows": (2, 256, 2, 64, True, "dead", False),
    "d128_t130": (1, 130, 2, 128, False, None, False),
    "t1": (1, 1, 1, 8, False, None, False),
    # D not a multiple of 4 (4-byte copies, zero-filled columns), T not a
    # multiple of any tile
    "d37_t77": (3, 77, 2, 37, False, None, False),
    "d37_t77_causal_dead": (3, 77, 2, 37, True, "dead", False),
}


def _flash_inputs(case, device):
    from tpu_ddp_torch.ops import flash_attention as fa

    B, T, H, D, causal, mask_kind, views = FLASH_CASES[case]
    gen = torch.Generator(device=device).manual_seed(T * D)
    if views:
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=device)
        q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=device)
                   for _ in range(3))
    do = torch.randn((B, T, H, D), generator=gen, device=device)
    mask = None
    if mask_kind is not None:
        mask = torch.ones((B, T), device=device)
        mask[0, 3 * T // 4:] = 0
        if mask_kind == "dead" and B > 1:
            mask[1, :T // 4] = 0
    return fa, q, k, v, do, mask, causal


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain(cuda, case):
    fa, q, k, v, do, mask, causal = _flash_inputs(case, cuda)
    ops.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    want_out, want_lse = fa.forward_plain(q, k, v, mask, causal)
    di = fa.row_dot(do, want_out)
    dq = fa.flash_dq(q, k, v, do, want_lse, di, mask, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fused_update": 0, fa.FWD: 1, fa.DQ: 1, fa.DKV: 1,
                                   "fused_quant": 0, "fused_dequant": 0}
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    want_dq = fa.dq_plain(q, k, v, do, want_lse, di, mask, causal)
    want_dk, want_dv = fa.dkv_plain(q, k, v, do, want_lse, di, mask, causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)
    if FLASH_CASES[case][5] == "dead":
        T = q.shape[1]
        assert torch.all(out[1, :T // 4] == 0) and torch.all(dq[1, :T // 4] == 0)
        assert torch.all(lse[1, :, :T // 4] == fa.NEG)
        # masked keys get no gradient, exactly
        hidden = mask == 0
        assert torch.all(dk[hidden] == 0) and torch.all(dv[hidden] == 0)


@pytest.mark.parametrize("case", ["vit_s4", "d37_t77_causal_dead", "d128_t130"])
def test_flash_backward_is_bitwise_repeatable(cuda, case):
    """Each output row of K5/K6 is written once by its block, with no
    atomics: two calls on the same inputs give the same bits."""
    fa, q, k, v, do, mask, causal = _flash_inputs(case, cuda)
    out, lse = fa.forward_plain(q, k, v, mask, causal)
    di = fa.row_dot(do, out)
    first = (fa.flash_dq(q, k, v, do, lse, di, mask, causal),
             *fa.flash_dkv(q, k, v, do, lse, di, mask, causal))
    second = (fa.flash_dq(q, k, v, do, lse, di, mask, causal),
              *fa.flash_dkv(q, k, v, do, lse, di, mask, causal))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_backward_launch_info(cuda):
    """K5/K6's resources from the runtime: no spill at D = 64, at least two
    blocks an SM at D = 128 (128 threads a block, 64 own rows)."""
    from tpu_ddp_torch.ops import flash_attention as fa

    for kind in ("dq", "dkv"):
        small, large = fa.backward_launch_info(kind, 64), fa.backward_launch_info(kind, 128)
        assert small["spill_bytes"] == 0, (kind, small)
        assert large["blocks_per_sm"] >= 2, (kind, large)
        own = "query_rows" if kind == "dq" else "key_rows"
        assert small["threads"] == large["threads"] == 128
        assert small[own] == large[own] == 64


#: K4 alone: the ViT path's shape (qkv views), the long regime at D = 128,
#: and an odd head dim (4-byte copies)
K4_CASES = {"vit_s4": (32, 64, 3, 64, True), "t2048_d128": (4, 2048, 8, 128, False),
            "d13": (2, 40, 2, 13, False)}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_flash_forward_matches_plain(cuda, case):
    from tpu_ddp_torch.ops import flash_attention as fa

    B, T, H, D, views = K4_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    if views:
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=cuda)
        q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=cuda)
                   for _ in range(3))
    out, lse = fa.flash_forward(q, k, v)
    want_out, want_lse = fa.forward_plain(q, k, v)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    info = fa.forward_launch_info(D)
    assert info["registers"] <= 128 and info["blocks_per_sm"] >= 2


def test_flash_attention_autograd_matches_reference(cuda):
    fa, q, k, v, do, mask, causal = _flash_inputs("causal_dead_rows", cuda)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, kv_mask=mask)
    want = fa.reference(*ref_leaves, causal=True, kv_mask=mask)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    grads = torch.autograd.grad(out, leaves, do)
    want_grads = torch.autograd.grad(want, ref_leaves, do)
    for got, w in zip(grads, want_grads):
        torch.testing.assert_close(got, w, atol=5e-5, rtol=1e-4)


def test_flash_limits_raise_on_cuda(cuda):
    from tpu_ddp_torch.ops import flash_attention as fa

    q = torch.zeros((1, 8, 1, 160), device=cuda)
    with pytest.raises(ValueError, match="limit of 128"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 1, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 only"):
        fa.flash_attention(q, q, q)


def test_vit_train_step_launches_flash_kernels(cuda):
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
    from tpu_ddp_torch.models import MODEL_REGISTRY
    from tpu_ddp_torch.ops.flash_attention import flash_attention
    from tpu_ddp_torch.train.optim import make_optimizer
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.steps import batch_to_device, make_eval_step, make_train_step

    model = MODEL_REGISTRY["vit_s4"]()
    model.attention_impl = flash_attention
    tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True)
    state = create_train_state(model, tx, cuda)
    images, labels = synthetic_cifar10(32, 10, 0)
    batch = batch_to_device({"image": images, "label": labels,
                             "mask": np.ones(32, bool)}, cuda)
    ops.reset_launch_counts()
    state, metrics = make_train_step(tx)(state, batch)
    make_eval_step()(state, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fused_update": 1, "flash_attention_fwd": 12,
                                   "flash_attention_dq": 6, "flash_attention_dkv": 6,
                                   "fused_quant": 0, "fused_dequant": 0}
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("size,block,offset", [
    (5, 256, 0), (432, 256, 0), (32768, 256, 0), (1000003, 256, 1),
    (100003, 1, 0), (100003, 64, 0), (100003, 1000, 0), (100003, 4096, 0)])
def test_quant_kernels_bitwise_equal_to_plain(cuda, size, block, offset):
    from tpu_ddp_torch.ops.fused_quant import fused_dequant, fused_quant
    from tpu_ddp_torch.parallel.compression import dequantize_chunk, quantize_chunk

    gen = torch.Generator(device=cuda).manual_seed(size + block)
    x = torch.randn(size + offset, generator=gen, device=cuda)[offset:] * 3
    x[size // 3] = 0.0
    if size > 3 * block:
        x[block:2 * block] = 0.0                    # an all-zero block
        x[2 * block + 1] = float("nan")             # a NaN block
    acc = torch.randn(size, generator=gen, device=cuda)
    ops.reset_launch_counts()
    got = fused_quant(x, block)
    want = quantize_chunk(x, "int8", block)
    finite = torch.isfinite(want["scale"])
    assert torch.equal(torch.isnan(got["scale"]), torch.isnan(want["scale"]))
    assert torch.equal(got["scale"][finite], want["scale"][finite])
    rows = finite.repeat_interleave(block)
    assert torch.equal(got["q"][rows], want["q"][rows])
    for add in (None, acc):
        d = fused_dequant(got, block, size, add_to=add)
        ref = dequantize_chunk(got, "int8", block, size)
        ref = ref if add is None else add + ref
        fin = torch.isfinite(ref)
        assert torch.equal(fin, torch.isfinite(d))
        assert torch.equal(d[fin], ref[fin])
        assert not fin[~finite.repeat_interleave(block)[:size]].any()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_quant"] == 1 and ops.LAUNCHES["fused_dequant"] == 2
