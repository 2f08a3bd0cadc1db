"""The port's kernels on the card: K1, the int8 quantize and dequantize K2
and K3, and the flash-attention kernels K4-K6 against their plain PyTorch
versions, and train steps that go through them.
These need an NVIDIA GPU and nvcc and skip without them; run them on a GPU
machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``chip_smoke.py`` holds the kernels to the same comparisons at the main
path's sizes.) K1 runs every leaf of a step in one launch, ZeRO-1's
shards with their pad mask too, and frozen leaves (``--freeze``) in the
same launches. K1, K2 and K3
are held bitwise (K2's int8 bytes of a block
whose scale is not finite excepted: there the scales agree and the block
dequantizes non-finite); K4-K6 are held to the tolerances of ``tests/test_ops.py``:
forward ``atol=2e-5``, gradients ``atol=5e-5``, ``rtol=1e-4``, and their
bfloat16 kernels to two bf16 units of each row's largest value
(``assert_bf16_rows``)."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.ops.fused_update import LeafBatch, LeafConfig, fused_update_, update_math

pytestmark = pytest.mark.cuda

#: every kernel's launch count at 0
_NO_LAUNCHES = {name: 0 for name in ops.KERNELS}


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


#: ZeRO-1 shards with the pad mask: (leaf size, ranks, rank, offset in
#: floats from a 16-byte boundary). The live count inside a float4, in a
#: shard's second 16,384-element chunk (NetResDeep's fc1.weight at 3 ranks),
#: at a chunk's end, 0 (a 1-element leaf past rank 0), on the scalar path
#: (unaligned), and a shard without pad beside them
MASKED = [(4094, 4, 3, 0), (65_536, 3, 2, 0), (32_769, 2, 1, 0), (1, 4, 1, 0),
          (1, 4, 3, 0), (10, 3, 2, 0), (1003, 2, 1, 1), (100_001, 3, 2, 3),
          (1003, 2, 0, 0)]


@pytest.mark.parametrize("kind,momentum,ema,step_const,wd,clip", [
    ("sgd", 0.0, 0.0, -0.01, 0.0, False), ("sgd", 0.9, 0.99, None, 5e-4, True),
    ("adamw", 0.0, 0.99, -0.001, 0.05, True), ("adamw", 0.0, 0.0, None, 0.0, False)])
def test_masked_kernel_bitwise_equal_to_plain(cuda, kind, momentum, ema, step_const,
                                              wd, clip):
    """K1 with ZeRO-1's pad mask, all shards in one launch, each bitwise
    equal to ``update_math_masked``; the pad's u is +0 and its p unchanged."""
    from tpu_ddp_torch.ops.fused_update import shard_valid, update_math_masked

    cfg = LeafConfig(kind=kind, momentum=momentum, wd=wd, wd_apply=wd > 0,
                     has_clip=clip, max_norm=1.0, step_const=step_const,
                     ema_decay=ema, b1=0.9, b2=0.999, eps=1e-8)
    gen = torch.Generator(device=cuda).manual_seed(6)
    t = lambda n, o: torch.randn(n + o, generator=gen, device=cuda)[o:]  # noqa: E731
    leaves, valid = [], []
    for size, n, r, o in MASKED:
        s = -(-size // n)
        valid.append(shard_valid(size, r * s, s))
        leaves.append(dict(g=t(s, o), p=t(s, o), m=t(s, o), v=t(s, o).abs(),
                           e=t(s, o), u=torch.empty(s + o, device=cuda)[o:]))
    scalars = torch.tensor([3.0, -0.007, 0.271, 0.002997], device=cuda)
    want = []
    for lf, live in zip(leaves, valid):
        n = lf["g"].numel()
        u, p, m, v, e = update_math_masked(
            lf["g"], lf["p"], lf["m"] if cfg.has_m else None,
            lf["v"] if cfg.has_v else None, lf["e"] if ema else None, scalars, cfg,
            start=0, mask_size=live if live < n else None)
        want.append(dict(u=u, p=p, m=m, v=v, e=e, p0=lf["p"].clone()))
    assert any(live < lf["g"].numel() for lf, live in zip(leaves, valid))
    ops.reset_launch_counts()
    batch = LeafBatch(*([lf[k] for lf in leaves] for k in "pmve"), cfg,
                      [cfg.wd_apply] * len(leaves), us=[lf["u"] for lf in leaves],
                      valid=valid)
    batch.run([lf["g"] for lf in leaves], scalars)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_update"] == 1
    for lf, w, live in zip(leaves, want, valid):
        for k in "upmve":
            if w[k] is not None:
                assert torch.equal(lf[k], w[k]), k
        assert not bool(lf["u"][live:].view(torch.int32).any())       # +0.0
        assert torch.equal(lf["p"][live:], w["p0"][live:] + 0.0)


@pytest.mark.parametrize("kind,momentum,ema,step_const,wd,clip", [
    ("sgd", 0.9, 0.0, -0.01, 0.0, False), ("sgd", 0.9, 0.99, None, 5e-4, True),
    ("adamw", 0.0, 0.99, -0.001, 0.05, True)])
def test_frozen_rows_bitwise_equal_to_plain(cuda, kind, momentum, ema, step_const,
                                            wd, clip):
    """K1's frozen rows (``--freeze``) beside trainable ones, unpadded and as
    ZeRO-1 shards with a live pad mask, 130 leaves in two launches: each
    frozen leaf bitwise ``update_math_frozen`` (u +0.0, p + 0.0 turning -0.0
    into +0.0, the EMA of p + 0.0), each trainable one ``update_math_masked``."""
    from tpu_ddp_torch.ops.fused_update import update_math_frozen, update_math_masked

    cfg = LeafConfig(kind=kind, momentum=momentum, wd=wd, wd_apply=wd > 0,
                     has_clip=clip, max_norm=1.0, step_const=step_const,
                     ema_decay=ema, b1=0.9, b2=0.999, eps=1e-8)
    gen = torch.Generator(device=cuda).manual_seed(8)
    t = lambda n, o: torch.randn(n + o, generator=gen, device=cuda)[o:]  # noqa: E731
    specs = [(size, o, valid, i % 3 != 2) for i, (size, o, valid) in enumerate(
        [(4096, 0, 4096), (1003, 1, 1003), (65_541, 0, 65_541), (1022, 0, 1019),
         (7, 3, 7), (16_385, 0, 16_380)] * 21 + [(33, 0, 30)] * 4)]
    leaves, want = [], []
    scalars = torch.tensor([3.0, -0.007, 0.271, 0.002997], device=cuda)
    for size, o, valid, frozen in specs:
        lf = dict(g=t(size, o), p=t(size, o), m=None if frozen else t(size, o),
                  v=None if frozen else t(size, o).abs(), e=t(size, o),
                  u=torch.empty(size + o, device=cuda)[o:])
        lf["p"][::5] = -0.0
        if frozen:
            u, p, m, v, e = update_math_frozen(lf["p"], lf["e"] if ema else None, cfg)
        else:
            u, p, m, v, e = update_math_masked(
                lf["g"], lf["p"], lf["m"] if cfg.has_m else None,
                lf["v"] if cfg.has_v else None, lf["e"] if ema else None, scalars,
                cfg, start=0, mask_size=valid if valid < size else None)
        leaves.append(lf)
        want.append(dict(u=u, p=p, m=m, v=v, e=e if ema else None))
    ops.reset_launch_counts()
    batch = LeafBatch(*([lf[k] for lf in leaves] for k in "pmve"), cfg,
                      [cfg.wd_apply] * len(leaves), us=[lf["u"] for lf in leaves],
                      valid=[v for _, _, v, _ in specs],
                      frozen=[f for _, _, _, f in specs])
    batch.run([lf["g"] for lf in leaves], scalars)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_update"] == 2
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    for lf, w, (_, _, _, frozen) in zip(leaves, want, specs):
        for k in "upmve":
            if w[k] is not None:
                assert torch.equal(bits(lf[k]), bits(w[k])), k
        if frozen:
            assert not bool(lf["u"].view(torch.int32).any())           # +0.0


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


def test_zero1_train_step_launches_k1_once_a_step(cuda):
    """``--zero1`` at one rank: K1 runs once a step on the shards, its leaf
    table built once, and the params follow the replicated run's bits."""
    from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
    from tpu_ddp_torch.models import NetResDeep
    from tpu_ddp_torch.parallel.zero import Zero1Partition
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
    from tpu_ddp_torch.train.state import create_train_state
    from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

    torch.backends.cudnn.deterministic = True
    images, labels = synthetic_cifar10(32, 10, 0)
    batch = batch_to_device({"image": images, "label": labels,
                             "mask": np.ones(32, bool)}, cuda)
    kw = dict(optimizer="adamw", lr=1e-3, weight_decay=0.05, grad_clip_norm=1.0,
              ema_decay=0.9, kernels=True)
    models = {}
    try:
        for zero1 in (False, True):
            model = NetResDeep()
            params = dict(model.named_parameters())
            tx = (make_optimizer(zero1_axis="data", decay_mask=decay_mask(params), **kw)
                  if zero1 else make_optimizer(**kw))
            part = Zero1Partition(tx, params, 1) if zero1 else None
            state = create_train_state(model, tx, cuda, zero1=part)
            step = make_train_step(tx, zero1=part)
            ops.reset_launch_counts()
            batches = []
            for _ in range(3):
                state, metrics = step(state, batch)
                batches.append(tx.fused._batch)
            torch.cuda.synchronize()
            assert ops.launch_counts()["fused_update"] == 3
            assert all(b is batches[0] for b in batches)
            assert torch.isfinite(metrics["loss"])
            models[zero1] = state.model.state_dict()
    finally:
        torch.backends.cudnn.deterministic = False
    for name, want in models[False].items():
        torch.testing.assert_close(models[True][name], want, rtol=0, atol=1e-6)


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
    assert ops.launch_counts() == {**_NO_LAUNCHES, fa.FWD: 1, fa.DQ: 1, fa.DKV: 1}
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


#: the bfloat16 kernels' cases: ViT-S/4's shape (qkv views), with dead rows
#: under a key mask, the LM's causal views at T = 1,024 and at the LM-32k
#: path's (4, 4096, 8, 64), an odd T with D = 48 (zero-filled columns),
#: D = 36 (the kernels read a padded copy), D = 128 at T = 130 and, causal
#: with dead rows, at T = 200 (T not a multiple of the 128-row query tile),
#: and one token
BF16_CASES = {
    "vit_s4": (32, 64, 3, 64, False, None, True),
    "vit_s4_dead": (4, 64, 3, 64, True, "dead", True),
    "lm_causal_t1024": (2, 1024, 2, 64, True, None, True),
    "lm_causal_t4096": (4, 4096, 8, 64, True, None, True),
    "t100_d48": (4, 100, 2, 48, False, None, False),
    "d36_t77_causal_dead": (3, 77, 2, 36, True, "dead", False),
    "d128_t130": (1, 130, 2, 128, False, None, False),
    "d128_t200_causal_dead": (3, 200, 2, 128, True, "dead", False),
    "t1": (1, 1, 1, 16, False, None, False),
}


def assert_bf16_rows(got, want, ulps=2, floor=2.0 ** -12):
    """``got`` within ``ulps`` bfloat16 units in the last place of the
    largest ``|want|`` of its own row (the last axis: a query row of out and
    dq, a key row of dk and dv), so that a row of small values, far along a
    causal sequence, is held to its own scale. A row's scale is at least
    ``floor`` of the tensor's largest value: a row whose terms cancel (causal
    row 0 of dq, ds = p (dO v - di) with di = dO v) holds the float32 sums'
    residual, which scales with the tensor. K4 rounds p against its tile's
    running max and the plain version against the row's, both round the
    output once, and the sums run in other orders, so a kernel and its
    plain version differ by a rounding or two of a row's largest value."""
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().amax(-1, keepdim=True)
    top = top.clamp(min=float(top.max()) * floor)
    unit = torch.exp2(torch.floor(torch.log2(top)) - 7)     # 0 where all of want is 0
    bad = diff > ulps * unit
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements beyond {ulps} units of their row; worst "
        f"{float(torch.where(diff == 0, 0.0, diff / unit).max()):.3g} units")


def _bf16_inputs(case, device):
    from tpu_ddp_torch.ops import flash_attention as fa

    B, T, H, D, causal, mask_kind, views = BF16_CASES[case]
    gen = torch.Generator(device=device).manual_seed(T * D + 1)
    if views:
        qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=device)
        q, k, v = (x.reshape(B, T, H, D)
                   for x in qkv.to(torch.bfloat16).split(H * D, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=device
                               ).to(torch.bfloat16) for _ in range(3))
    do = torch.randn((B, T, H, D), generator=gen, device=device).to(torch.bfloat16)
    mask = None
    if mask_kind is not None:
        mask = torch.ones((B, T), device=device)
        mask[0, 3 * T // 4:] = 0
        mask[1, :T // 4] = 0
    return fa, q, k, v, do, mask, causal


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_bf16_flash_kernels_match_plain(cuda, case):
    """K4-K6's bfloat16 kernels against their plain versions in bfloat16:
    out, dq, dk and dv bfloat16 within two bf16 units of each row's largest
    value (``assert_bf16_rows``), lse float32 within ``atol=2e-5``; launches counted
    under the ``_bf16`` names; dead rows and masked keys exactly 0."""
    fa, q, k, v, do, mask, causal = _bf16_inputs(case, cuda)
    ops.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, mask, causal)
    want_out, want_lse = fa.forward_plain(q, k, v, mask, causal)
    di = fa.row_dot(do, want_out)
    dq = fa.flash_dq(q, k, v, do, want_lse, di, mask, causal)
    dk, dv = fa.flash_dkv(q, k, v, do, want_lse, di, mask, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**_NO_LAUNCHES, fa.FWD_BF16: 1, fa.DQ_BF16: 1,
                                   fa.DKV_BF16: 1}
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.dtype == torch.float32
    assert_bf16_rows(out, want_out)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    want_dq = fa.dq_plain(q, k, v, do, want_lse, di, mask, causal)
    want_dk, want_dv = fa.dkv_plain(q, k, v, do, want_lse, di, mask, causal)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got.float()).all()
        assert_bf16_rows(got, want)
    if BF16_CASES[case][5] == "dead":
        T = q.shape[1]
        assert torch.all(out[1, :T // 4] == 0) and torch.all(dq[1, :T // 4] == 0)
        assert torch.all(lse[1, :, :T // 4] == fa.NEG)
        hidden = mask == 0
        assert torch.all(dk[hidden] == 0) and torch.all(dv[hidden] == 0)


def test_bf16_flash_backward_is_bitwise_repeatable(cuda):
    fa, q, k, v, do, mask, causal = _bf16_inputs("d36_t77_causal_dead", cuda)
    out, lse = fa.forward_plain(q, k, v, mask, causal)
    di = fa.row_dot(do, out)
    first = (fa.flash_dq(q, k, v, do, lse, di, mask, causal),
             *fa.flash_dkv(q, k, v, do, lse, di, mask, causal))
    second = (fa.flash_dq(q, k, v, do, lse, di, mask, causal),
              *fa.flash_dkv(q, k, v, do, lse, di, mask, causal))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bf16_launch_info(cuda):
    """The bfloat16 kernels' resources: two warpgroups (256 threads) each,
    K4 and K5 over a 128-row query tile and 64-key tiles, K6 over 128 keys
    and 64-query tiles; no spill at D = 64."""
    from tpu_ddp_torch.ops import flash_attention as fa

    k4 = fa.forward_launch_info(64, torch.bfloat16)
    k5, k6 = (fa.backward_launch_info(kind, 64, torch.bfloat16) for kind in ("dq", "dkv"))
    for info in (k4, k5):
        assert info["threads"] == 256, info
        assert (info["query_rows"], info["key_rows"]) == (128, 64), info
    assert k6["threads"] == 256, k6
    assert (k6["query_rows"], k6["key_rows"]) == (64, 128), k6
    for info in (k4, k5, k6):
        assert info["spill_bytes"] == 0, info
        assert info["blocks_per_sm"] >= 1, info


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
    with pytest.raises(ValueError, match="float32 or bfloat16 only"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 1, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention(q, q.float(), q)


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
    assert ops.launch_counts() == {**_NO_LAUNCHES, "fused_update": 1,
                                   "flash_attention_fwd": 12, "flash_attention_dq": 6,
                                   "flash_attention_dkv": 6}
    assert torch.isfinite(metrics["loss"])


def test_lm_train_step_launches_causal_flash_kernels(cuda):
    """One LM step at tiny widths with ``use_flash``: K4, K5 and K6 once a
    block each (causal), K1 once; the loss finite."""
    from tpu_ddp_torch.models import CausalTransformerLM
    from tpu_ddp_torch.train import create_lm_train_state, make_lm_train_step
    from tpu_ddp_torch.train.optim import make_optimizer

    depth = 2
    model = CausalTransformerLM(vocab_size=17, hidden_dim=32, depth=depth, num_heads=2,
                                seq_len=64, use_flash=True)
    tx = make_optimizer(lr=1e-3, optimizer="adamw", kernels=True)
    state = create_lm_train_state(model, tx, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, 17, (4, 64), generator=gen, device=cuda)
    ops.reset_launch_counts()
    state, metrics = make_lm_train_step(tx)(state, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**_NO_LAUNCHES, "fused_update": 1,
                                   "flash_attention_fwd": depth,
                                   "flash_attention_dq": depth,
                                   "flash_attention_dkv": depth}
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


#: (leaf lengths, ranks, block): NetResDeep's nine leaves at three ranks;
#: ragged small leaves at four ranks with block 7 (a message of an odd
#: number of bytes, so the gathered rows start unaligned); 200 leaves, past
#: K1's table of 128
SEGMENT_CASES = {
    "netresdeep_3": ([864, 32, 9216, 32, 32, 65536, 32, 320, 10], 3, 256),
    "ragged_4_block7": ([36, 5, 1, 63, 3, 100], 4, 7),
    "leaves_200": ([17 * (i % 13) + 1 for i in range(200)], 2, 16),
}


def _f32_bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_kernels_bitwise_equal_to_plain(cuda, case):
    """K2 over every leaf in one launch (the message, and the error in the
    same pass) and K3 (accumulating into the running sums, in place too,
    into the shard row, and the n-row gather) against their plain
    versions, bitwise, one launch each."""
    from tpu_ddp_torch.ops.fused_quant import (
        segment_dequant,
        segment_dequant_plain,
        segment_quant,
        segment_quant_plain,
    )
    from tpu_ddp_torch.parallel.collectives import FlatLayout

    sizes, n, block = SEGMENT_CASES[case]
    layout = FlatLayout([s + (-s) % n for s in sizes], n, block)
    gen = torch.Generator(device=cuda).manual_seed(layout.total)
    x = torch.randn(layout.total, generator=gen, device=cuda) * 3
    x[layout.offsets[-1]:] = 0.0                     # an all-zero leaf
    ops.reset_launch_counts()
    msgs = []
    for c in range(n):
        err, err_p = torch.zeros_like(x), torch.zeros_like(x)
        msg = segment_quant(x, layout, c, err=err)
        assert torch.equal(msg, segment_quant_plain(x, layout, c, "int8", err=err_p))
        assert torch.equal(_f32_bits(err), _f32_bits(err_p))
        assert torch.equal(segment_quant(x, layout, c), msg)
        c2 = (c + 1) % n
        acc, acc_p, inplace = torch.zeros_like(x), torch.zeros_like(x), x.clone()
        segment_dequant(msg, layout, acc, add=x, add_chunk=c2, out_chunk=c2)
        segment_dequant(msg, layout, inplace, add=inplace, add_chunk=c2, out_chunk=c2)
        segment_dequant_plain(msg, layout, "int8", acc_p, add=x, add_chunk=c2,
                              out_chunk=c2)
        assert torch.equal(_f32_bits(acc), _f32_bits(acc_p))
        assert torch.equal(_f32_bits(layout.chunk(inplace, 0, c2)),
                           _f32_bits(layout.chunk(acc, 0, c2)))
        row = torch.zeros(layout.rows.width, device=cuda)
        row_p = torch.zeros_like(row)
        segment_dequant(msg, layout, row, add=x, add_chunk=c, to_rows=True)
        segment_dequant_plain(msg, layout, "int8", row_p, add=x, add_chunk=c,
                              to_rows=True)
        assert torch.equal(_f32_bits(row), _f32_bits(row_p))
        msgs.append(msg)
    gathered = torch.stack(msgs)
    out = segment_dequant(gathered, layout, torch.empty_like(x))
    want = segment_dequant_plain(gathered, layout, "int8", torch.empty_like(x))
    assert torch.equal(_f32_bits(out), _f32_bits(want))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_quant"] == 2 * n
    assert ops.LAUNCHES["fused_dequant"] == 3 * n + 1


def _two_rank_ring(rank, world, out_dir):
    """One step's compressed ring over NetResDeep's nine leaves on one rank
    of two sharing ``cuda:0`` over gloo, through K2/K3 and through the plain
    versions: launches, wire calls and results."""
    from tpu_ddp_torch.parallel import collectives
    from tpu_ddp_torch.parallel.compression import GradCompression, GradCompressor

    torch.cuda.set_device(0)
    wire = [0]
    for name in ("exchange", "all_gather_bytes"):
        fn = getattr(collectives, name)

        def counted(*a, _fn=fn, **kw):
            wire[0] += 1
            return _fn(*a, **kw)

        setattr(collectives, name, counted)
    shapes = [(32, 3, 3, 3), (32,), (32, 32, 3, 3), (32,), (32,), (32, 2048), (32,),
              (10, 32), (10,)]
    gen = torch.Generator(device="cuda").manual_seed(rank)
    grads = {f"leaf{i}": torch.randn(s, generator=gen, device="cuda")
             for i, s in enumerate(shapes)}
    out = {}
    for kernels in (True, False):
        comp = GradCompressor(GradCompression(mode="int8", error_feedback=True,
                                              kernels=kernels), grads, world)
        residual = comp.init_residual("cuda")
        for kind in ("all_reduce", "reduce_scatter"):
            fn = (comp.all_reduce_mean if kind == "all_reduce" else
                  lambda g, r, with_error, c=comp: c.reduce_scatter_mean_flat(
                      c.flatten(g), r, with_error=with_error))
            ops.reset_launch_counts()
            before = wire[0]
            got, err = fn(grads, residual, with_error=True)
            torch.cuda.synchronize()
            out[f"{kind}/{kernels}"] = {
                "launches": ops.launch_counts(), "wire": wire[0] - before,
                "got": {k: v.cpu() for k, v in got.items()},
                "err": {k: v.cpu() for k, v in err.items()}}
    torch.save(out, f"{out_dir}/rank{rank}.pt")


def test_two_rank_ring_one_launch_a_hop(cuda, tmp_path):
    """Two ranks on one card: the all-reduce makes K2 and K3 two launches a
    step each (one a hop, one for the gather) and two wire calls, the
    reduce-scatter one of each; the results and residuals are bitwise those
    of the plain versions."""
    from tpu_ddp_torch.parallel.runtime import spawn

    spawn(_two_rank_ring, 2, str(tmp_path), init_file=str(tmp_path / "rdzv"),
          timeout=300)
    for rank in range(2):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        for kind, hops in (("all_reduce", 2), ("reduce_scatter", 1)):
            k, p = res[f"{kind}/True"], res[f"{kind}/False"]
            assert k["launches"]["fused_quant"] == hops
            assert k["launches"]["fused_dequant"] == hops
            assert sum(p["launches"].values()) == 0
            assert k["wire"] == p["wire"] == hops
            for key in ("got", "err"):
                for name, v in k[key].items():
                    assert torch.equal(_f32_bits(v), _f32_bits(p[key][name])), (kind, key)
