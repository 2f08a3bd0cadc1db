"""Batch prefetcher: the native ring that gathers batches ahead of the step.

Counterpart of ``tpu_ddp/native/prefetch.py`` (``_NativeRing`` :28,
``BatchPrefetcher`` :158) over the port's copy of ``prefetcher.cpp``. A
C++ worker thread gathers each submitted batch's rows (multithreaded) into
one of a ring of slot buffers, so that the gather of batch N+depth overlaps
the training step of batch N.

The slots are torch tensors this class owns: with ``pin_memory`` (a run on
the card) page-locked host memory, so that the copy to the card out of a
slot is an asynchronous DMA on a copy stream (``Trainer._prefetched_stream``
is the consumer). The JAX package's fallback, a Python thread gathering
into fresh arrays when the library does not build, is not carried over: the
library builds and loads, or the constructor raises.

Consumption contract: ``acquire()`` returns views of slot memory, valid
ONLY until ``release(slot)``. Release a slot only after the copy out of it
has finished: on the card, after the CUDA event recorded behind the copy;
on the CPU, after a copy (``torch.from_numpy`` and ``torch.as_tensor``
alias host memory, so a step that kept the view would read the next
gather's rows).

Digests: given ``digest_seed``, the C++ gather also writes each row's keyed
BLAKE2b digest of the slot's image and label rows (``blake2b.h``), and
``row_digests(slot, n)`` reads them, with the same lifetime as the slot's
rows. ``datapath/audit.py::xor_row_digests`` folds a batch's into the
digest that ``batch_digest`` computes from the rows, so the trainer's data
audit hashes nothing on the training thread.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_ddp_torch import native

#: slot buffers start on this many bytes, so every dtype's view is aligned
SLOT_ALIGN = 64


def _row_bytes(a: np.ndarray) -> int:
    return int(np.prod(a.shape[1:], dtype=np.int64)) * a.itemsize


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class BatchPrefetcher:
    """FIFO prefetcher over an in-memory dataset.

    ``submit(idx)`` enqueues a gather of rows ``idx`` (at most
    ``max_batch``); ``acquire()`` returns ``(images, labels, slot)`` for the
    oldest submission, as CPU tensors viewing the slot. ``depth`` is the
    number of slots; ``digest_seed`` (module docstring) keys the rows'
    digests, None for none."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 max_batch: int, depth: int = 3, pin_memory: bool = False,
                 digest_seed: Optional[int] = None):
        if depth < 1:
            raise ValueError(f"prefetcher depth must be >= 1, got {depth}")
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels)
        if len(self.images) != len(self.labels):
            raise ValueError(f"{len(self.images)} images but {len(self.labels)} labels")
        self.img_row, self.lbl_row = _row_bytes(self.images), _row_bytes(self.labels)
        self.max_batch = max_batch
        caps = [-(-max_batch * row // SLOT_ALIGN) * SLOT_ALIGN
                for row in (self.img_row, self.lbl_row)]
        self._slots = [torch.empty((depth, cap), dtype=torch.uint8, pin_memory=pin_memory)
                       for cap in caps]
        self._dtypes = (_torch_dtype(self.images.dtype), _torch_dtype(self.labels.dtype))
        ptrs = [(ctypes.c_void_p * depth)(*(s[i].data_ptr() for i in range(depth)))
                for s in self._slots]
        self._digests = None
        dig_ptrs, key = None, 0
        if digest_seed is not None:
            self._digests = np.zeros((depth, max_batch, 8), np.uint8)
            dig_ptrs = (ctypes.c_void_p * depth)(
                *(self._digests[i].ctypes.data for i in range(depth)))
            key = int(digest_seed) & 0xFFFFFFFFFFFFFFFF     # batch_digest's key
        self._lib = native.lib()
        self._h = self._lib.bp_create(depth, ptrs[0], ptrs[1], dig_ptrs, caps[0], caps[1],
                                      max_batch * 8, key)
        if not self._h:
            raise RuntimeError("bp_create failed")
        self._sizes: collections.deque = collections.deque()

    def submit(self, idx: np.ndarray) -> None:
        idx64 = np.ascontiguousarray(idx, np.int64)
        if idx64.size > self.max_batch:
            raise ValueError(f"batch of {idx64.size} exceeds slot capacity {self.max_batch}")
        # the C++ gather copies unvalidated src + idx * row_bytes: bound the
        # indices here, so a bad index raises as numpy's fancy indexing does
        if idx64.size and (int(idx64.min()) < 0 or int(idx64.max()) >= len(self.images)):
            raise IndexError(f"prefetch indices out of range [0, {len(self.images)})")
        rc = self._lib.bp_submit(self._h, self.images.ctypes.data, self.labels.ctypes.data,
                                 idx64.ctypes.data, idx64.size, self.img_row, self.lbl_row)
        if rc < 0:
            raise RuntimeError(f"bp_submit failed ({rc})")
        self._sizes.append(idx64.size)

    def acquire(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        n = self._sizes.popleft()
        slot = self._lib.bp_acquire(self._h)
        if slot < 0:
            raise RuntimeError("bp_acquire on a stopping prefetcher")
        views = []
        for buf, row, dtype, arr in zip(self._slots, (self.img_row, self.lbl_row),
                                        self._dtypes, (self.images, self.labels)):
            views.append(buf[slot, :n * row].view(dtype).view((n,) + arr.shape[1:]))
        return views[0], views[1], slot

    def row_digests(self, slot: int, n: int) -> np.ndarray:
        """The 8 digest bytes of each of the ``n`` rows in ``slot``, a
        ``(n, 8)`` view valid until ``release(slot)``."""
        if self._digests is None:
            raise RuntimeError("row_digests on a prefetcher built without digest_seed")
        return self._digests[slot, :n]

    def release(self, slot: int) -> None:
        self._lib.bp_release(self._h, slot)

    def close(self) -> None:
        """Stop the worker (its in-flight gather finishes first); the slots
        are freed after it."""
        if getattr(self, "_h", None):
            self._lib.bp_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        self.close()
