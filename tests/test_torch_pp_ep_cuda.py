"""The kernels of the pipeline and expert paths on the card: K4-K6 at the pp
microbatch shape of ViT-S/4 (``--microbatches 4`` at batch 32: (8, 64, 3,
64), q, k and v views of one qkv product) against their plain versions
with ``tests/test_ops.py``'s tolerances (forward ``atol=2e-5``, gradients
``atol=5e-5, rtol=1e-4``), and K1 over ``vit_moe_s4``'s 85 leaves in one
launch, bitwise equal to its plain version (``update_math``), under the ViT
recipe (AdamW) and with decay, clip and EMA. Needs an NVIDIA GPU and nvcc
and skips without them; run it on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_pp_ep_cuda.py -q

(``chip_smoke.py`` phase 27 drives the pp and ep paths at full width.)"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest
import torch

from tpu_ddp_torch import ops

pytestmark = pytest.mark.cuda

PP_MICRO = (8, 64, 3, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_flash_kernels_at_the_pp_microbatch(cuda):
    from tpu_ddp_torch.ops import flash_attention as fa

    B, T, H, D = PP_MICRO
    gen = torch.Generator(device=cuda).manual_seed(27)
    qkv = torch.randn((B, T, 3 * H * D), generator=gen, device=cuda)
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    do = torch.randn((B, T, H, D), generator=gen, device=cuda)
    ops.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v)
    want_out, want_lse = fa.forward_plain(q, k, v)
    di = fa.row_dot(do, want_out)
    dq = fa.flash_dq(q, k, v, do, want_lse, di)
    dk, dv = fa.flash_dkv(q, k, v, do, want_lse, di)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**{n: 0 for n in ops.KERNELS},
                                   fa.FWD: 1, fa.DQ: 1, fa.DKV: 1}
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)
    want_dk, want_dv = fa.dkv_plain(q, k, v, do, want_lse, di)
    for got, want in ((dq, fa.dq_plain(q, k, v, do, want_lse, di)), (dk, want_dk),
                      (dv, want_dv)):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("kind,wd,clip,ema", [("adamw", 0.0, False, 0.0),
                                              ("adamw", 0.05, True, 0.99)])
def test_k1_at_the_moe_vit_leaves(cuda, kind, wd, clip, ema):
    from tpu_ddp_torch.models import MODEL_REGISTRY
    from tpu_ddp_torch.ops.fused_update import LeafBatch, LeafConfig, update_math

    shapes = [tuple(p.shape) for p in MODEL_REGISTRY["vit_moe_s4"]().parameters()]
    assert len(shapes) == 85
    cfg = LeafConfig(kind=kind, momentum=0.0, wd=wd, wd_apply=False, has_clip=clip,
                     max_norm=1.0 if clip else 0.0, step_const=-0.001, ema_decay=ema,
                     b1=0.9, b2=0.999, eps=1e-8)
    gen = torch.Generator(device=cuda).manual_seed(85)
    t = lambda s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    leaves = [dict(g=t(s), p=t(s), m=t(s), v=t(s).abs(), e=t(s),
                   u=torch.empty(s, device=cuda)) for s in shapes]
    decay = [wd > 0 and len(s) >= 2 for s in shapes]
    scalars = torch.tensor([3.0, -0.007, 0.271, 0.002997], device=cuda)
    want = []
    for lf, d in zip(leaves, decay):
        c = LeafConfig(**{**cfg.__dict__, "wd_apply": d})
        u, m, v, e = update_math(lf["g"], lf["p"], lf["m"], lf["v"], lf["e"], scalars, c)
        want.append(dict(u=u, p=lf["p"] + u, m=m, v=v, e=e))
    ops.reset_launch_counts()
    batch = LeafBatch(*([lf[k] for lf in leaves] for k in "pmve"), cfg, decay,
                      us=[lf["u"] for lf in leaves])
    batch.run([lf["g"] for lf in leaves], scalars)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_update"] == 1
    for lf, w in zip(leaves, want):
        for k, ref in w.items():
            if ref is not None:
                assert torch.equal(lf[k], ref), k
