"""The port's native host data-path library (``tpu_ddp_torch/native``)
against the JAX package's (``tpu_ddp/native``, built by g++ here too) and
numpy: the codec and the gather bit for bit, the ring's FIFO order, its
index checks, multi-hot labels and the slot-reuse hazard (ported from
``tests/test_native.py``; the port has no Python thread fallback, so that
file's fallback cases have no counterpart). The ring's pinned slots on the
card: ``tests/test_torch_native_cuda.py``."""

import torch_threads  # noqa: F401  (first: one torch thread a process)
import numpy as np
import pytest
import torch

from tpu_ddp import native as jax_native
from tpu_ddp.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD
from tpu_ddp_torch import native
from tpu_ddp_torch.native.prefetch import BatchPrefetcher


def test_library_builds_into_the_checkout():
    assert native.available()
    path = native.library_path()
    assert path.is_file() and path.parent.name == "tpu_ddp_torch"
    assert path.parent.parent.name == "build"
    assert native.build() == 0.0          # built once, keyed by its sources


def test_decode_normalize_bitwise_jax_native_and_close_to_numpy():
    assert jax_native.AVAILABLE
    raw = np.random.default_rng(0).integers(0, 256, size=(37, 3072), dtype=np.uint8)
    got = native.decode_normalize(raw, CIFAR10_MEAN, CIFAR10_STD)
    assert got.shape == (37, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jax_native.decode_normalize(raw, CIFAR10_MEAN, CIFAR10_STD))
    ref = raw.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    np.testing.assert_allclose(got, (ref - CIFAR10_MEAN) / CIFAR10_STD, rtol=0, atol=1e-6)


def test_decode_normalize_rejects_bad_records():
    with pytest.raises(ValueError, match="3072"):
        native.decode_normalize(np.zeros((2, 100), np.uint8), CIFAR10_MEAN, CIFAR10_STD)


@pytest.mark.parametrize("rows,n_idx", [(50, 128), (64, 512)])   # 1.5 MB / 6 MB
def test_gather_rows_bitwise_numpy_and_jax_native(rows, n_idx):
    """Below 1 MiB numpy's fancy indexing, above it the threaded native
    copy (the JAX package's dispatch): every dtype bit for bit."""
    rng = np.random.default_rng(rows)
    src = rng.normal(size=(rows, 32, 32, 3)).astype(np.float32)
    idx = rng.integers(0, rows, size=n_idx)
    labels = rng.integers(0, 10, size=rows).astype(np.int32)
    for a in (src, labels, labels.astype(np.int64)):
        got = native.gather_rows(a, idx)
        np.testing.assert_array_equal(got, a[idx])
        np.testing.assert_array_equal(got, jax_native.gather_rows(a, idx))
        assert got.dtype == a.dtype


def test_gather_rows_oob_and_negative_match_numpy():
    """Bounds stay numpy's: out of range raises, negatives wrap."""
    src = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(native.gather_rows(src, np.array([-1, 0])), src[[-1, 0]])
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([7]))


def _roundtrip(images, labels, max_batch, depth, schedules):
    """Keep ``depth`` submissions in flight; return what each acquire gave,
    copied out before its slot is released."""
    out, in_flight = [], 0
    with BatchPrefetcher(images, labels, max_batch=max_batch, depth=depth) as pf:
        for idx in schedules:
            pf.submit(idx)
            in_flight += 1
            if in_flight == depth:
                img, lbl, slot = pf.acquire()
                out.append((img.clone(), lbl.clone()))
                pf.release(slot)
                in_flight -= 1
        while in_flight:
            img, lbl, slot = pf.acquire()
            out.append((img.clone(), lbl.clone()))
            pf.release(slot)
            in_flight -= 1
    return out


@pytest.mark.parametrize("label_dtype", [np.int64, np.int32])
def test_prefetcher_ring_fifo_parity(label_dtype):
    rng = np.random.default_rng(4)
    images = rng.normal(size=(40, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=40).astype(label_dtype)
    schedules = [rng.integers(0, 40, size=int(rng.integers(1, 17))) for _ in range(9)]
    out = _roundtrip(images, labels, 16, 3, schedules)
    assert len(out) == len(schedules)
    for (img, lbl), idx in zip(out, schedules):
        np.testing.assert_array_equal(img.numpy(), images[idx])
        np.testing.assert_array_equal(lbl.numpy(), labels[idx])
        assert lbl.dtype == torch.from_numpy(labels).dtype


def test_prefetcher_rejects_bad_indices():
    """The C++ gather copies unvalidated rows: the Python face raises first,
    as numpy's fancy indexing would."""
    images = np.zeros((10, 2, 2, 3), np.float32)
    labels = np.zeros(10, np.int64)
    with BatchPrefetcher(images, labels, max_batch=4, depth=2) as pf:
        with pytest.raises(IndexError):
            pf.submit(np.array([0, 10]))
        with pytest.raises(IndexError):
            pf.submit(np.array([-1, 0]))
        with pytest.raises(ValueError):
            pf.submit(np.arange(5))          # exceeds the slot capacity


def test_prefetcher_multihot_float_labels():
    """BCE's (N, C) float32 targets ride the byte-row gather too."""
    rng = np.random.default_rng(5)
    images = rng.normal(size=(30, 4, 4, 3)).astype(np.float32)
    labels = (rng.random((30, 3)) < 0.5).astype(np.float32)
    with BatchPrefetcher(images, labels, max_batch=8, depth=2) as pf:
        idx = rng.integers(0, 30, size=8)
        pf.submit(idx)
        img, lbl, slot = pf.acquire()
        np.testing.assert_array_equal(img.numpy(), images[idx])
        np.testing.assert_array_equal(lbl.numpy(), labels[idx])
        assert lbl.shape == (8, 3) and lbl.dtype == torch.float32
        pf.release(slot)


def test_slot_reuse_overwrites_a_held_view():
    """The hazard the consumer must avoid: a view kept past ``release`` is
    overwritten by a later gather into the same slot (one slot: the next
    submission takes it), while a copy taken before the release is not."""
    images = np.arange(8 * 12, dtype=np.float32).reshape(8, 2, 2, 3)
    labels = np.arange(8, dtype=np.int32)
    with BatchPrefetcher(images, labels, max_batch=4, depth=1) as pf:
        pf.submit(np.array([0, 1, 2, 3]))
        view, _, slot = pf.acquire()
        copy = view.clone()
        pf.release(slot)
        pf.submit(np.array([4, 5, 6, 7]))
        _, _, slot = pf.acquire()
        np.testing.assert_array_equal(copy.numpy(), images[:4])
        np.testing.assert_array_equal(view.numpy(), images[4:])   # overwritten
        pf.release(slot)


def test_prefetcher_fans_out_large_batches():
    """Jobs of 1 MiB or more take the threaded gather (smaller ones the
    worker copies alone): both give the rows."""
    rng = np.random.default_rng(7)
    images = rng.normal(size=(300, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=300).astype(np.int32)
    schedules = [rng.integers(0, 300, size=n) for n in (200, 8, 120, 200, 1)]
    out = _roundtrip(images, labels, 200, 2, schedules)   # 200 rows: 2.4 MiB
    for (img, lbl), idx in zip(out, schedules):
        np.testing.assert_array_equal(img.numpy(), images[idx])
        np.testing.assert_array_equal(lbl.numpy(), labels[idx])
