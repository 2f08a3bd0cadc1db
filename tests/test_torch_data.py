"""The port's data layer against the JAX package's: the same seed gives
bit-identical arrays, sampler indices, batches and masks."""

import numpy as np
import pytest

from tpu_ddp.data import cifar10 as jax_cifar10
from tpu_ddp.data import loader as jax_loader
from tpu_ddp_torch.data import cifar10, loader


def test_synthetic_cifar10_bit_identical():
    for seed in (0, 3):
        want = jax_cifar10.synthetic_cifar10(96, 10, seed)
        got = cifar10.synthetic_cifar10(96, 10, seed)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


def test_normalize_and_decode_bit_identical():
    raw = np.random.default_rng(0).integers(0, 256, size=(5, 3072), dtype=np.uint8)
    hwc = raw.reshape(5, 3, 32, 32).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(cifar10.normalize(hwc), jax_cifar10.normalize(hwc))
    np.testing.assert_array_equal(cifar10.decode_normalize(raw),
                                  jax_cifar10.normalize(hwc))


@pytest.mark.parametrize("n,ws,shuffle,epoch", [
    (10, 1, True, 0), (10, 3, True, 2), (17, 4, False, 0), (5, 8, True, 1)])
def test_shard_indices_bit_identical(n, ws, shuffle, epoch):
    kw = dict(shuffle=shuffle, seed=7, epoch=epoch)
    np.testing.assert_array_equal(loader.shard_indices(n, ws, **kw),
                                  jax_loader.shard_indices(n, ws, **kw))


@pytest.mark.parametrize("ws,exclude_pad,shuffle", [
    (1, False, True), (2, True, True), (3, False, False)])
def test_loader_batches_bit_identical(ws, exclude_pad, shuffle):
    """Includes a short last batch (wrap-padded, masked)."""
    images, labels = cifar10.synthetic_cifar10(45, 10, 1)
    kw = dict(world_size=ws, per_shard_batch=4, seed=5,
              exclude_sampler_pad=exclude_pad, shuffle=shuffle)
    port = loader.ShardedBatchLoader(images, labels, **kw)
    ref = jax_loader.ShardedBatchLoader(images, labels, **kw)
    assert len(port) == len(ref)
    short = False
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        pairs = list(zip(port.epoch_batches(), ref.epoch_batches(), strict=True))
        assert len(pairs) == len(ref)
        for got, want in pairs:
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            short |= not want["mask"].all()
    assert short
