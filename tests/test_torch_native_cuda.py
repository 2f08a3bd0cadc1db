"""The native ring's pinned slots on the card: each acquired slot is
page-locked, its rows reach the card through an asynchronous copy on a side
stream, and the slot is released once an event behind the copy completes.
Skips without a GPU; on the card (no JAX there):

    python -m pytest --noconftest -m cuda tests/test_torch_native_cuda.py -q
"""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

from tpu_ddp_torch.native.prefetch import BatchPrefetcher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_pinned_slots_copy_to_the_card(cuda):
    rng = np.random.default_rng(6)
    images = rng.normal(size=(64, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=64).astype(np.int32)
    stream = torch.cuda.Stream()
    with BatchPrefetcher(images, labels, max_batch=32, depth=3, pin_memory=True) as pf:
        for k in range(6):
            idx = rng.integers(0, 64, size=32)
            pf.submit(idx)
            img, lbl, slot = pf.acquire()
            assert img.is_pinned()
            with torch.cuda.stream(stream):
                dev = img.to(cuda, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
            event.synchronize()
            pf.release(slot)
            np.testing.assert_array_equal(dev.cpu().numpy(), images[idx])
