"""The flight recorder's skip-step guard on the card (phase 21a of
``chip_smoke.py`` at a small width): NetResDeep with ``--kernels`` (K1
writes p and the momentum in place) under ``skip_step``, a NaN batch
between two clean ones, under deterministic cuDNN. The params, the
momentum, ``sched_count`` and the BatchNorm buffers after the NaN step
bitwise as before it, K1 launched on every step (the skipped one too), the next
step finite; the same steps with the plain update give the same health
stats to the bit. Also the sentinels' multi-tensor passes on CUDA tensors:
a NaN or an infinity anywhere in a large leaf is found, a finite leaf whose
norm overflows is not. These need an NVIDIA GPU and nvcc and skip without
them; run them on a GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_health_cuda.py -q
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.data.cifar10 import synthetic_cifar10
from tpu_ddp_torch.health.stats import HealthConfig, nonfinite_leaves
from tpu_ddp_torch.models import NetResDeep
from tpu_ddp_torch.train.optim import make_optimizer
from tpu_ddp_torch.train.state import COUNTS, SLOTS, create_train_state
from tpu_ddp_torch.train.steps import batch_to_device, make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    return torch.device("cuda")


def _bits(state):
    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    for slot in SLOTS:
        for n, t in (getattr(state.opt_state, slot) or {}).items():
            out[f"opt/{slot}/{n}"] = t.clone()
    for c in COUNTS:
        if getattr(state.opt_state, c) is not None:
            out[f"opt/{c}"] = getattr(state.opt_state, c).clone()
    return out


def _run(device, kernels):
    images, labels = synthetic_cifar10(3 * 16, 10, seed=2)
    images = np.array(images)
    images[16:32] = np.nan
    tx = make_optimizer(lr=1e-2, momentum=0.9, schedule="cosine", total_steps=6,
                        kernels=kernels)
    state = create_train_state(NetResDeep(n_chans1=8, n_blocks=2,
                                          generator=torch.Generator().manual_seed(0)),
                               tx, device)
    step = make_train_step(tx, health=HealthConfig(per_layer=True, skip_nonfinite=True))
    stats, bits = [], []
    ops.reset_launch_counts()
    for i in range(3):
        batch = batch_to_device({"image": images[16 * i:16 * (i + 1)],
                                 "label": labels[16 * i:16 * (i + 1)],
                                 "mask": np.ones(16, bool)}, device)
        bits.append(_bits(state))
        state, metrics = step(state, batch)
        h = metrics["health"]
        stats.append({k: v.item() for k, v in h.items() if k != "per_layer"})
    torch.cuda.synchronize()
    return state, stats, bits + [_bits(state)], ops.launch_counts()["fused_update"]


def test_skip_step_on_the_card_is_bitwise(cuda):
    torch.backends.cudnn.deterministic = True
    try:
        state, stats, bits, k1 = _run(cuda, True)
        _, plain_stats, _, plain_k1 = _run(cuda, False)
    finally:
        torch.backends.cudnn.deterministic = False
    assert [s["all_finite"] for s in stats] == [True, False, True]
    before, after = bits[1], bits[2]
    assert set(before) == set(after)
    for k in before:
        a, b = before[k], after[k]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    assert k1 == 3 and plain_k1 == 0
    assert all(bool(torch.isfinite(p).all()) for p in state.params().values())
    assert str(stats) == str(plain_stats)


def test_sentinels_on_cuda_tensors(cuda):
    big = torch.randn(1 << 22, device=cuda)
    for bad in (float("nan"), float("inf"), float("-inf")):
        x = big.clone()
        x[(1 << 22) - 3] = bad
        assert float(nonfinite_leaves([big, x])) == 1.0
    huge = torch.full((1 << 20,), 3e38, device=cuda)
    assert float(nonfinite_leaves([huge])) == 0.0
