"""Static-shape batch loader with ``DistributedSampler`` semantics.

A numpy copy of the sampler math of ``tpu_ddp/data/loader.py``
(``shard_indices`` :55, ``ShardedBatchLoader`` :76), so that both packages
yield the same batches for the same seed:

* pad by wrapping so every shard has ``ceil(N / world_size)`` samples;
* shard ``r`` takes ``padded[r::world_size]`` (interleaved);
* a seeded permutation per epoch (``seed + epoch``);
* every batch has the same shape: the short last batch is wrap-padded and a
  boolean ``mask`` marks its real rows.

``step_groups`` fuses an epoch's batches into stacked groups of K for
``--steps-per-call`` (the JAX trainer's ``_epoch_stream``, :1439-1531).

The JAX loader's telemetry and observer hooks, multi-host slicing,
``drop_last``, frozen epoch order and the host prefetchers are not ported
yet; the gather is numpy fancy indexing.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterable, Iterator, Optional

import numpy as np


def shard_indices(n: int, world_size: int, *, shuffle: bool, seed: int = 0,
                  epoch: int = 0) -> np.ndarray:
    """(world_size, ceil(n/ws)) index matrix; row r is the rank-r order of
    torch's ``DistributedSampler`` (wrap-padded, interleaved)."""
    if shuffle:
        order = np.random.default_rng(seed + epoch).permutation(n)
    else:
        order = np.arange(n)
    per_shard = math.ceil(n / world_size)
    total = per_shard * world_size
    if total > n:
        order = np.concatenate([order, order[: total - n]])
    return order.reshape(per_shard, world_size).T


class ShardedBatchLoader:
    """Yields ``{image, label, mask}`` batches of the fixed global shape
    ``(world_size * per_shard_batch, ...)``, shard-major."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 world_size: int = 1, per_shard_batch: int = 32,
                 shuffle: bool = True, seed: int = 0,
                 exclude_sampler_pad: bool = False):
        """exclude_sampler_pad: also mask the sampler's wrap-pad duplicates
        (True for eval, so metrics count every sample once)."""
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images, self.labels = images, labels
        self.world_size = world_size
        self.per_shard_batch = per_shard_batch
        self.shuffle = shuffle
        self.seed = seed
        self.exclude_sampler_pad = exclude_sampler_pad
        self._epoch = 0
        per_shard = math.ceil(len(images) / world_size)
        self.steps_per_epoch = math.ceil(per_shard / per_shard_batch)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def epoch_index_batches(self, epoch: Optional[int] = None) -> Iterator[tuple]:
        """Yield ``(idx, mask)`` per step."""
        epoch = self._epoch if epoch is None else epoch
        shards = shard_indices(
            len(self.images), self.world_size, shuffle=self.shuffle,
            seed=self.seed, epoch=epoch,
        )
        per_shard = shards.shape[1]
        n = len(self.images)
        # positions >= n in the padded order are wrap-pad duplicates
        total = per_shard * self.world_size
        is_real = (np.arange(total) < n).reshape(per_shard, self.world_size).T
        bs = self.per_shard_batch
        for step in range(self.steps_per_epoch):
            lo, hi = step * bs, min((step + 1) * bs, per_shard)
            chunk = shards[:, lo:hi]
            real = is_real[:, lo:hi]
            valid = hi - lo
            if valid < bs:  # wrap-pad the short final batch; mask it out
                deficit = bs - valid
                reps = -(-deficit // per_shard)
                pad = np.tile(shards, (1, reps))[:, :deficit]
                chunk = np.concatenate([chunk, pad], axis=1)
            mask = np.zeros((self.world_size, bs), bool)
            mask[:, :valid] = True
            if self.exclude_sampler_pad:
                mask[:, :valid] &= real
            yield chunk.reshape(-1), mask.reshape(-1)

    def epoch_batches(self, epoch: Optional[int] = None,
                      shard: Optional[int] = None,
                      start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The global batches or, with ``shard``, that shard's
        ``per_shard_batch`` rows of each (the batch is shard-major).
        ``start`` skips the epoch's first index batches without gathering
        them (a mid-epoch resume)."""
        bs = self.per_shard_batch
        for idx, mask in itertools.islice(self.epoch_index_batches(epoch), start, None):
            if shard is not None:
                idx = idx[shard * bs:(shard + 1) * bs]
                mask = mask[shard * bs:(shard + 1) * bs]
            yield {
                "image": np.ascontiguousarray(self.images[idx]),
                "label": np.ascontiguousarray(self.labels[idx]),
                "mask": mask,
            }

    def __len__(self):
        return self.steps_per_epoch


def step_groups(batches: Iterable[Dict[str, np.ndarray]],
                steps_per_call: int) -> Iterator[tuple]:
    """Yield ``("stacked", group)`` for each run of ``steps_per_call``
    batches, every array of ``group`` stacked on a new leading (K,) axis (one
    host-to-device copy a group), and ``("single", batch)`` for the epoch's
    remainder, shorter than K, so the fused call's shapes stay static. With
    ``steps_per_call <= 1`` every batch is single."""
    if steps_per_call <= 1:
        for batch in batches:
            yield "single", batch
        return
    pending = []
    for batch in batches:
        pending.append(batch)
        if len(pending) == steps_per_call:
            yield "stacked", {k: np.stack([b[k] for b in pending]) for k in pending[0]}
            pending = []
    for batch in pending:
        yield "single", batch
