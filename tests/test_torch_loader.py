"""The port's loader against the JAX package's under the options this slice
ports: ``reshuffle_each_epoch=False`` (``--faithful-epoch-order``),
``drop_last``, and multi-process slicing (``process_index`` /
``process_count``), the ``(idx, mask)`` batches and the gathered batches
equal to the bit. The port's one-process-a-rank slicing ``(rank, world)``
gives each rank exactly the rows ``shard=rank`` cut from the global batch."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest

from tpu_ddp.data import loader as jax_loader
from tpu_ddp_torch.data import cifar10, loader


def _pair(n=45, **kw):
    images, labels = cifar10.synthetic_cifar10(n, 10, 1)
    kw = {"per_shard_batch": 4, "seed": 5, **kw}
    return (loader.ShardedBatchLoader(images, labels, **kw),
            jax_loader.ShardedBatchLoader(images, labels, **kw))


CASES = [
    dict(world_size=2, reshuffle_each_epoch=False),
    dict(world_size=2, drop_last=True),
    dict(world_size=3, drop_last=True, reshuffle_each_epoch=False),
    dict(world_size=2, process_index=0, process_count=2),
    dict(world_size=2, process_index=1, process_count=2),
    dict(world_size=4, process_index=1, process_count=2, drop_last=True),
    dict(world_size=2, process_index=1, process_count=2, exclude_sampler_pad=True,
         shuffle=False),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_index_and_gathered_batches_bit_identical(kw):
    port, ref = _pair(**kw)
    assert len(port) == len(ref) == port.steps_per_epoch
    assert port.local_batch == ref.local_batch and port.global_batch == ref.global_batch
    for epoch in (1, 2, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        pairs = list(zip(port.epoch_index_batches(), ref.epoch_index_batches(), strict=True))
        assert len(pairs) == len(ref)
        for (pi, pm), (ri, rm) in pairs:
            np.testing.assert_array_equal(pi, ri)
            np.testing.assert_array_equal(pm, rm)
        for got, want in zip(port.epoch_batches(), ref.epoch_batches(), strict=True):
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_faithful_order_repeats_epoch_zero():
    port, _ = _pair(world_size=2, reshuffle_each_epoch=False)
    orders = [np.concatenate([i for i, _ in port.epoch_index_batches(epoch=e)])
              for e in (0, 1, 5)]
    assert all(np.array_equal(orders[0], o) for o in orders[1:])
    shuffled, _ = _pair(world_size=2)
    assert not np.array_equal(
        np.concatenate([i for i, _ in shuffled.epoch_index_batches(epoch=1)]),
        np.concatenate([i for i, _ in shuffled.epoch_index_batches(epoch=2)]))


def test_drop_last_has_no_short_batch():
    port, _ = _pair(world_size=2, drop_last=True)       # 23 rows a shard, batch 4
    assert port.steps_per_epoch == 5
    assert all(m.all() for _, m in port.epoch_index_batches(epoch=1))
    keep, _ = _pair(world_size=2)
    assert keep.steps_per_epoch == 6
    assert not list(keep.epoch_index_batches(epoch=1))[-1][1].all()


@pytest.mark.parametrize("world", [2, 3])
def test_rank_slicing_is_the_global_batch_shard(world):
    """``(process_index, process_count) = (rank, world)``: rank r's batches
    are, bit for bit, rows ``shard=r`` of the global loader's."""
    images, labels = cifar10.synthetic_cifar10(45, 10, 2)
    common = dict(world_size=world, per_shard_batch=4, seed=3)
    glob = loader.ShardedBatchLoader(images, labels, **common)
    for r in range(world):
        local = loader.ShardedBatchLoader(images, labels, process_index=r,
                                          process_count=world, **common)
        assert local.local_batch == 4
        for epoch in (1, 2):
            for got, want in zip(local.epoch_batches(epoch=epoch),
                                 glob.epoch_batches(epoch=epoch, shard=r), strict=True):
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])


def test_start_skips_without_gathering():
    port, _ = _pair(world_size=2, process_index=1, process_count=2)
    full = list(port.epoch_batches(epoch=2))
    port.gather_seconds = 0.0
    tail = list(port.epoch_batches(epoch=2, start=3))
    assert len(tail) == len(full) - 3
    for got, want in zip(tail, full[3:]):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert port.gather_seconds > 0.0


def test_process_count_must_divide_the_world():
    images, labels = cifar10.synthetic_cifar10(8, 10, 0)
    with pytest.raises(ValueError, match="not divisible by 2 hosts"):
        loader.ShardedBatchLoader(images, labels, world_size=3, process_count=2)
    with pytest.raises(AssertionError, match="not divisible by 2 hosts"):
        jax_loader.ShardedBatchLoader(images, labels, world_size=3, process_count=2)


def test_step_groups_stack_what_the_ring_concatenates():
    """A fused group's stacked batch is the rows of its K index batches
    concatenated, which is what the native ring gathers in one submission."""
    port, _ = _pair(world_size=1)
    index = list(port.epoch_index_batches(epoch=1))
    groups = list(loader.step_groups(port.epoch_batches(epoch=1), 5))   # 12 steps
    assert [k for k, _ in groups] == ["stacked", "stacked", "single", "single"]
    for g, (_, stacked) in enumerate(groups[:2]):
        part = index[5 * g:5 * g + 5]
        idx = np.concatenate([i for i, _ in part])
        np.testing.assert_array_equal(stacked["image"].reshape(-1, 32, 32, 3),
                                      port.images[idx])
        np.testing.assert_array_equal(stacked["mask"], np.stack([m for _, m in part]))
