"""Static-shape batch loader with ``DistributedSampler`` semantics.

A numpy copy of the sampler math of ``tpu_ddp/data/loader.py``
(``shard_indices`` :55, ``ShardedBatchLoader`` :76), so that both packages
yield the same batches for the same seed:

* pad by wrapping so every shard has ``ceil(N / world_size)`` samples;
* shard ``r`` takes ``padded[r::world_size]`` (interleaved);
* a seeded permutation per epoch (``seed + epoch``), or the epoch-0
  order every epoch under ``reshuffle_each_epoch=False`` (the reference's
  missing ``sampler.set_epoch``, ``--faithful-epoch-order``);
* every batch has the same shape: the short last batch is wrap-padded and a
  boolean ``mask`` marks its real rows; ``drop_last`` drops it instead;
* ``process_index``/``process_count``: ``world_size`` stays the global
  shard count and every process computes the same sampler math; process p
  yields only the rows of its contiguous block of ``world_size /
  process_count`` shards (``local_batch`` rows a step). The port runs one
  process a rank, so its trainer passes ``(rank, world_size)``: each rank
  gathers only its own ``per_shard_batch`` rows.

The gather goes through ``native.gather_rows`` (the JAX loader's
``_gather``, :36-40). ``step_groups`` fuses an epoch's batches into stacked
groups of K for ``--steps-per-call`` (the JAX trainer's ``_epoch_stream``,
:1439-1531). The host prefetchers that run ahead of the step are
``native/prefetch.py`` and ``datapath/prefetch.py``; ``Trainer`` drives
them. ``epoch_batches`` runs the JAX loader's stages (:223-280: index,
gather, collate, shard), each batch's in a ``data/<stage>`` span of
``telemetry=`` (a ``Telemetry``; the inert ``NULL`` by default), and counts
``loader/batches``. It has no ``data/augment`` span: the port's
augmentation runs inside the step. ``gather_seconds`` counts the time
spent in the gather. The JAX loader's stage observer (``observer=``,
``datapath/stages.py``) is not ported yet.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from tpu_ddp_torch import native


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
    """Yields ``{image, label, mask}`` batches of the fixed shape
    ``(local_batch, ...)``, shard-major: the global batch of
    ``world_size * per_shard_batch`` rows at one process."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 world_size: int = 1, per_shard_batch: int = 32,
                 shuffle: bool = True, reshuffle_each_epoch: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 exclude_sampler_pad: bool = False,
                 process_index: int = 0, process_count: int = 1,
                 telemetry=None):
        """exclude_sampler_pad: also mask the sampler's wrap-pad duplicates
        (True for eval, so metrics count every sample once)."""
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        if world_size % process_count:
            raise ValueError(f"{world_size} devices not divisible by "
                             f"{process_count} hosts")
        self.images, self.labels = images, labels
        self.world_size = world_size
        self.per_shard_batch = per_shard_batch
        self.shuffle = shuffle
        self.reshuffle_each_epoch = reshuffle_each_epoch
        self.seed = seed
        self.drop_last = drop_last
        self.exclude_sampler_pad = exclude_sampler_pad
        self.process_index = process_index
        self.process_count = process_count
        self.local_world_size = world_size // process_count
        self.gather_seconds = 0.0
        if telemetry is None:
            from tpu_ddp_torch.telemetry import NULL as telemetry
        self.telemetry = telemetry
        self._epoch = 0
        per_shard = math.ceil(len(images) / world_size)
        if drop_last:
            self.steps_per_epoch = per_shard // per_shard_batch
        else:
            self.steps_per_epoch = math.ceil(per_shard / per_shard_batch)

    @property
    def global_batch(self) -> int:
        return self.per_shard_batch * self.world_size

    @property
    def local_batch(self) -> int:
        """Rows this process gathers a step (``global_batch`` at one
        process)."""
        return self.per_shard_batch * self.local_world_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def epoch_index_batches(self, epoch: Optional[int] = None) -> Iterator[tuple]:
        """Yield this process's ``(idx, mask)`` per step."""
        epoch = self._epoch if epoch is None else epoch
        shards = shard_indices(
            len(self.images), self.world_size, shuffle=self.shuffle,
            seed=self.seed, epoch=epoch if self.reshuffle_each_epoch else 0,
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
            # process p owns the contiguous shard block [p * lws, (p+1) * lws)
            lo_r = self.process_index * self.local_world_size
            hi_r = lo_r + self.local_world_size
            yield chunk[lo_r:hi_r].reshape(-1), mask[lo_r:hi_r].reshape(-1)

    def gather(self, idx: np.ndarray) -> tuple:
        """``(images[idx], labels[idx])`` through ``native.gather_rows``."""
        t0 = time.perf_counter()
        out = native.gather_rows(self.images, idx), native.gather_rows(self.labels, idx)
        self.gather_seconds += time.perf_counter() - t0
        return out

    def epoch_batches(self, epoch: Optional[int] = None,
                      shard: Optional[int] = None,
                      start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """This process's batches or, with ``shard``, that shard's
        ``per_shard_batch`` rows of each (the batch is shard-major; ``shard``
        counts from this process's first). ``start`` skips the epoch's
        first index batches without gathering them (a mid-epoch resume).
        Each batch passes the five stages (module docstring)."""
        bs = self.per_shard_batch
        index = itertools.islice(self.epoch_index_batches(epoch), start, None)
        span = self.telemetry.span
        while True:
            with span("data/index"):
                pair = next(index, None)
                if pair is not None and shard is not None:
                    idx, mask = pair
                    pair = idx[shard * bs:(shard + 1) * bs], mask[shard * bs:(shard + 1) * bs]
            if pair is None:
                return
            idx, mask = pair
            with span("data/gather"):
                images, labels = self.gather(idx)
            with span("data/collate"):
                batch = {"image": images, "label": labels, "mask": mask}
            with span("data/shard"):
                batch = {k: np.ascontiguousarray(v) for k, v in batch.items()}
            self.telemetry.count("loader/batches")
            yield batch

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
