"""K1 on the card: the CUDA kernel against its plain PyTorch version, and a
train step that goes through it. These need an NVIDIA GPU and nvcc and skip
without them; run them on a GPU machine with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q

(``chip_smoke.py`` holds the kernel to the same comparison at every size.)"""

import numpy as np
import pytest
import torch

from tpu_ddp_torch import ops
from tpu_ddp_torch.ops.fused_update import LeafConfig, fused_update_, update_math

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,momentum,ema,step_const", [
    ("sgd", 0.0, 0.0, -0.01), ("sgd", 0.9, 0.99, None),
    ("adamw", 0.0, 0.99, -0.001)])
@pytest.mark.parametrize("n,offset", [(1, 0), (127, 0), (65536, 0), (1003, 1)])
def test_kernel_bitwise_equal_to_plain(cuda, kind, momentum, ema, step_const,
                                       n, offset):
    cfg = LeafConfig(kind=kind, momentum=momentum, wd=5e-4, wd_apply=True,
                     has_clip=True, max_norm=1.0, step_const=step_const,
                     ema_decay=ema, b1=0.9, b2=0.999, eps=1e-8)
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


def test_train_step_launches_k1_per_leaf(cuda):
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
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_update"] == 9
    assert torch.isfinite(metrics["loss"])
