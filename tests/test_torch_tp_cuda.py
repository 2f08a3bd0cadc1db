"""Tensor parallelism and FSDP on the card (``parallel/tensor_parallel.py``):
two gloo ranks sharing the card, a ViT (patch 4, hidden 96, depth 2, 3
heads: 2 and 1 a rank at model=2) under ``tp`` (``data=1,model=2``) and
``fsdp`` (``data=2``), three SGD steps (momentum, clip; AdamW would scale
the key third of qkv.bias, whose gradient is float noise, to +-lr in either
run) with ``--attention flash`` and
``--kernels`` (K4-K6 on each rank's heads, K1 on its leaves or shards)
against the same steps with full attention and the plain update. Needs an
NVIDIA GPU and nvcc and skips without them; run it on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_tp_cuda.py -q

Expected: K1 once a step, K4, K5 and K6 once a block a step (the plain run
none); losses within ``rtol=1e-5`` and the gathered params within
``atol=1e-5, rtol=1e-4`` of the plain run's; both ranks' params equal to
the bit. ``chip_smoke.py`` phase 26 runs the families at full width."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import pytest
import torch

pytestmark = pytest.mark.cuda

VIT = dict(patch_size=4, hidden_dim=96, depth=2, num_heads=3, num_classes=10)
STEPS = 3
BUILDS = {"tp": {"data": 1, "model": 2}, "fsdp": {"data": 2}}


def _worker(rank, n, path, build):
    from tpu_ddp_torch import ops
    from tpu_ddp_torch.models import ViT
    from tpu_ddp_torch.ops.flash_attention import flash_attention
    from tpu_ddp_torch.parallel.mesh import create_mesh
    from tpu_ddp_torch.train.optim import decay_mask, make_optimizer
    from tpu_ddp_torch.train.strategy import build_strategy

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(3)
    images = torch.randn((STEPS, 16, 32, 32, 3), generator=gen)
    labels = torch.randint(0, 10, (STEPS, 16), generator=gen)
    out = {}
    mesh = create_mesh(BUILDS[build])
    rows = slice(mesh.data_index * 16 // mesh.data_size,
                 (mesh.data_index + 1) * 16 // mesh.data_size)
    for kernels in (True, False):
        model = ViT(**VIT, generator=torch.Generator().manual_seed(0))
        if kernels:
            model.attention_impl = flash_attention
        fsdp = build == "fsdp"
        tx = make_optimizer(lr=0.05, momentum=0.9, grad_clip_norm=1.0,
                            kernels=kernels, zero1_axis="data" if fsdp else None,
                            decay_mask=decay_mask(dict(model.named_parameters())))
        strat = build_strategy(build, mesh, model, tx, device)
        ops.reset_launch_counts()
        losses = []
        for s in range(STEPS):
            batch = {"image": images[s, rows].to(device), "label": labels[s, rows].to(device)}
            _, metrics = strat.train_step(strat.state, batch)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        out[(build, kernels)] = {
            "losses": losses, "launches": ops.launch_counts(),
            "params": {k: v.cpu() for k, v in strat.layout.model_state(strat.state).items()}}
    torch.save(out, f"{path}/rank{rank}.pt")


@pytest.mark.parametrize("build", list(BUILDS))
def test_gspmd_kernels_on_the_card(tmp_path, build):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tpu_ddp_torch.parallel.runtime import spawn

    spawn(_worker, 2, str(tmp_path), build, init_file=str(tmp_path / "rdzv"), timeout=300)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for res in ranks:
        got, want = res[(build, True)], res[(build, False)]
        expect = {k: 0 for k in got["launches"]}
        expect["fused_update"] = STEPS
        for kind in ("fwd", "dq", "dkv"):
            expect[f"flash_attention_{kind}"] = VIT["depth"] * STEPS
        assert got["launches"] == expect
        assert not any(want["launches"].values())
        torch.testing.assert_close(torch.tensor(got["losses"]), torch.tensor(want["losses"]),
                                   rtol=1e-5, atol=0)
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, atol=1e-5, rtol=1e-4)
    for k, v in ranks[0][(build, True)]["params"].items():
        assert torch.equal(ranks[1][(build, True)]["params"][k], v), k
