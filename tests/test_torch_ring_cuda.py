"""The flash ring on the card: ``ring_flash_attention`` (K4 a forward hop,
K5 and K6 a backward hop) against the same ring with the plain tiles
(``ring_attention``), two gloo ranks sharing the card. Needs an NVIDIA GPU
and nvcc and skips without them; run it on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_ring_cuda.py -q

Shapes: ViT-S/4's stripes, ``(8, 32, 3, 64)`` a rank, causal and not, one
case with a key mask; float32 within ``tests/test_ops.py``'s tolerances
(forward and lse ``atol=2e-5``, gradients ``atol=5e-5, rtol=1e-4``). In
bfloat16 each of the n tiles a result sums is within two bf16 units of its
plain version's rows, and each is rounded to bfloat16 before the ring sums
it, so the result is held within ``2 n + 1`` units of each row's largest
value (``test_torch_cuda_kernels.py::assert_bf16_rows``; lse
``atol=2e-5``); ``chip_smoke.py`` phase 25a holds each tile to two units.
Each rank launches K4, K5 and K6 n times a pass, ``s + 1`` times under
``causal`` (s: its place on the ring). ``chip_smoke.py`` phase 25a holds
the ring at the ViT's and the LM-32k's full shapes."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest
import torch

pytestmark = pytest.mark.cuda

N = 2
SHAPE = (8, 32, 3, 64)
#: case -> (dtype, causal, masked)
CASES = {"f32": (torch.float32, False, False), "f32_causal": (torch.float32, True, False),
         "f32_masked": (torch.float32, False, True), "bf16": (torch.bfloat16, False, False),
         "bf16_causal": (torch.bfloat16, True, False)}


def _worker(rank, n, path):
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.parallel.ring_attention import (
        ring_attention,
        ring_flash_attention,
        ring_forward,
    )

    torch.cuda.set_device(0)
    mesh = create_mesh({"sequence": n})
    group, s = mesh.sequence_group(), mesh.sequence_index
    B, T, H, D = SHAPE
    rows = slice(s * T, (s + 1) * T)
    out = {}
    for name, (dtype, causal, masked) in CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, g = (torch.randn((B, n * T, H, D), generator=gen, device="cuda")
                      .to(dtype)[:, rows] for _ in range(4))
        km = None
        if masked:
            km = (torch.rand((B, n * T), generator=gen, device="cuda") > 0.3).float()
            km[0] = 0.0                                   # a dead batch row
            km = km[:, rows].contiguous()
        res = {}
        for tile, ring in (("flash", ring_flash_attention), ("plain", ring_attention)):
            a, b, c = (t.clone().requires_grad_() for t in (q, k, v))
            ops.reset_launch_counts()
            o = ring(a, b, c, group=group, causal=causal, kv_mask=km)
            o.backward(g)
            torch.cuda.synchronize()
            res[tile] = ([t.detach().cpu() for t in (o, a.grad, b.grad, c.grad)],
                         ops.launch_counts())
            res[tile + "_lse"] = ring_forward(q, k, v, km, group, causal,
                                              tile == "flash")[1].cpu()
        out[name] = res
    torch.save(out, f"{path}/rank{rank}.pt")


def test_flash_ring_against_plain_ring(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from test_torch_cuda_kernels import assert_bf16_rows

    from tpu_ddp_torch.parallel.runtime import spawn

    spawn(_worker, N, str(tmp_path), init_file=str(tmp_path / "rdzv"), timeout=300)
    for rank in range(N):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        for name, (dtype, causal, _) in CASES.items():
            (got, counts), (want, plain_counts) = res[name]["flash"], res[name]["plain"]
            suffix = "_bf16" if dtype == torch.bfloat16 else ""
            tiles = rank + 1 if causal else N
            for kind in ("fwd", "dq", "dkv"):
                assert counts[f"flash_attention_{kind}{suffix}"] == tiles, (name, kind)
            assert not any(plain_counts.values())
            torch.testing.assert_close(res[name]["flash_lse"], res[name]["plain_lse"],
                                       atol=2e-5, rtol=0)
            for i, (a, b) in enumerate(zip(got, want)):
                if dtype == torch.bfloat16:
                    assert_bf16_rows(a, b, ulps=2 * N + 1)
                elif i == 0:
                    torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
                else:
                    torch.testing.assert_close(a, b, atol=5e-5, rtol=1e-4)
