"""CIFAR-10 and CIFAR-100 as numpy arrays: the raw python-pickle batches,
or synthetic data.

A numpy copy of ``tpu_ddp/data/cifar10.py`` (``DATASET_LAYOUTS`` :35,
``load_cifar10`` :181, ``load_cifar100`` :189, ``_load_pickles`` :201,
``normalize`` :217, ``synthetic_cifar10`` :224, ``synthetic_cifar10_hard``
:245, ``synthetic_multilabel`` :311), so that the same seed gives
bit-identical arrays in both packages. Images are NHWC float32, normalised
with the reference's per-channel constants (CIFAR-10's for CIFAR-100 too,
as in the JAX package). The directory holds the batches
(``cifar-10-batches-py`` or ``cifar-100-python``) or the tarball that
torchvision leaves behind, which ``_find_dataset_dir`` extracts as the JAX
package's (:86) does; ``data/download.py`` fetches the tarball
(``--download``), with the probes ``extracted_dataset_dir``,
``existing_tarball`` and ``ensure_extracted`` (the JAX :43-81).
``decode_normalize`` runs the C++ codec of ``native/`` (the JAX
``_load_pickles`` :209-212 calls the JAX package's copy of it), so both
packages decode to the same bits.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tarfile
from typing import Tuple

import numpy as np

CIFAR10_MEAN = np.array([0.4915, 0.4823, 0.4468], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)

#: dataset -> (subdir, marker files, tarball, name), the JAX package's
#: on-disk layouts
DATASET_LAYOUTS = {
    "cifar10": ("cifar-10-batches-py", ("data_batch_1", "test_batch"),
                "cifar-10-python.tar.gz", "CIFAR-10"),
    "cifar100": ("cifar-100-python", ("train", "test"),
                 "cifar-100-python.tar.gz", "CIFAR-100"),
}
_TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_FILES = ["test_batch"]
_C100_TRAIN_FILES = ["train"]
_C100_TEST_FILES = ["test"]


def _find_batches_dir(data_dir: str) -> str:
    """CIFAR-10's batches dir (``_find_dataset_dir``)."""
    return _find_dataset_dir(data_dir, "cifar10")


def extracted_dataset_dir(data_dir: str, dataset: str):
    """The extracted batches dir holding every marker file, else None. A pure
    probe: it never extracts, never raises (ranks waiting for local rank 0's
    extraction poll it, and extraction lands atomically)."""
    subdir, markers, _, what = DATASET_LAYOUTS[dataset]
    for c in (data_dir, os.path.join(data_dir, subdir),
              os.path.join(data_dir, what, subdir)):
        if all(os.path.isfile(os.path.join(c, m)) for m in markers):
            return c
    return None


def existing_tarball(data_dir: str, dataset: str):
    """The canonical tarball already under ``data_dir``, else None."""
    _, _, tarball, what = DATASET_LAYOUTS[dataset]
    for c in (data_dir, os.path.join(data_dir, what)):
        p = os.path.join(c, tarball)
        if os.path.isfile(p):
            return p
    return None


def ensure_extracted(data_dir: str, dataset: str) -> bool:
    """Extract the tarball now unless the batches are on disk; whether the
    extracted dir exists afterwards (``download.ensure_dataset`` has one
    process do the extraction up front)."""
    if extracted_dataset_dir(data_dir, dataset) is not None:
        return True
    if existing_tarball(data_dir, dataset) is None:
        return False
    _find_dataset_dir(data_dir, dataset)  # extracts
    return extracted_dataset_dir(data_dir, dataset) is not None


def _find_dataset_dir(data_dir: str, dataset: str) -> str:
    """The batches dir of ``dataset`` under ``data_dir``: one holding every
    marker file; else the tarball's, extracted; else, with no tarball, one
    holding any marker (an eval-only placement holds just the test split,
    and the split's own files are checked when they are opened).

    Extraction is atomic, as in the JAX package: into a pid-named temp dir
    beside the tarball (temp dirs of dead processes are swept first), then
    one ``os.rename`` into place, so no reader sees half a dir. Where the
    rename finds a dir, a complete one is kept and an incomplete one is
    replaced."""
    subdir, markers, tarball, what = DATASET_LAYOUTS[dataset]
    candidates = (data_dir, os.path.join(data_dir, subdir),
                  os.path.join(data_dir, what, subdir))

    def complete(c: str) -> bool:
        return all(os.path.isfile(os.path.join(c, m)) for m in markers)

    for c in candidates:
        if complete(c):
            return c
    for c in (data_dir, os.path.join(data_dir, what)):
        tar = os.path.join(c, tarball)
        if os.path.isfile(tar):
            return _extract(tar, c, subdir, complete)
    for c in candidates:
        if any(os.path.isfile(os.path.join(c, m)) for m in markers):
            return c
    raise FileNotFoundError(
        f"{what} batches not found under {data_dir!r}: expected "
        f"{subdir}/{markers[0]} and {markers[1]}, or {tarball}. Use "
        "--synthetic-data for runs without the dataset."
    )


def _extract(tar: str, parent: str, subdir: str, complete) -> str:
    """``tar`` into ``parent/<subdir>`` (``_find_dataset_dir``)."""
    for stale in os.listdir(parent):
        if not stale.startswith(".extract.tmp."):
            continue
        try:
            os.kill(int(stale.rsplit(".", 1)[1]), 0)
        except (ValueError, ProcessLookupError):
            shutil.rmtree(os.path.join(parent, stale), ignore_errors=True)
        except PermissionError:
            pass    # a live process of another user owns it
    dst = os.path.join(parent, subdir)
    tmp = os.path.join(parent, f".extract.tmp.{os.getpid()}")
    try:
        with tarfile.open(tar) as tf:
            tf.extractall(tmp, filter="data")   # no absolute paths, no ..
        src = os.path.join(tmp, subdir)
        if not os.path.isdir(src):
            raise FileNotFoundError(
                f"{tar} does not hold the canonical {subdir}/ layout")
        try:
            os.rename(src, dst)
        except OSError:
            if not complete(dst):
                shutil.rmtree(dst, ignore_errors=True)
                try:
                    os.rename(src, dst)
                except OSError:
                    if not complete(dst):
                        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dst


def load_cifar10(data_dir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(images float32 NHWC normalised, labels int32)."""
    return _load_pickles(_find_batches_dir(data_dir),
                         _TRAIN_FILES if train else _TEST_FILES, b"labels")


def load_cifar100(data_dir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-100 with its 100 fine labels, laid out and normalised as
    CIFAR-10."""
    return _load_pickles(_find_dataset_dir(data_dir, "cifar100"),
                         _C100_TRAIN_FILES if train else _C100_TEST_FILES,
                         b"fine_labels")


def _load_pickles(batches_dir: str, files, label_key: bytes):
    imgs, labels = [], []
    for name in files:
        with open(os.path.join(batches_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"])
        labels.extend(d[label_key])
    raw = np.concatenate(imgs)  # (N, 3072) planar RGB, uint8
    return decode_normalize(raw), np.asarray(labels, np.int32)


def decode_normalize(raw: np.ndarray) -> np.ndarray:
    """(N, 3072) uint8 planar RGB -> (N, 32, 32, 3) float32 normalised, by
    the C++ codec (``native.decode_normalize``): ``byte * (1 / (255 std)) -
    mean / std``, which differs from ``normalize``'s ``(byte / 255 - mean)
    / std`` in the last bit."""
    from tpu_ddp_torch import native

    return native.decode_normalize(raw, CIFAR10_MEAN, CIFAR10_STD)


def normalize(images_uint8: np.ndarray) -> np.ndarray:
    """uint8 HWC [0,255] -> float32, /255, per-channel mean/std."""
    x = images_uint8.astype(np.float32) / 255.0
    return (x - CIFAR10_MEAN) / CIFAR10_STD


def synthetic_cifar10(
    n: int = 2048, num_classes: int = 10, seed: int = 0, centers_seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic CIFAR-10-shaped data: class-conditional Gaussians around
    per-class colour centres that depend only on ``centers_seed``, so train
    and test drawn with different ``seed`` share one distribution."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    centers = (
        np.random.default_rng(centers_seed)
        .normal(0.0, 1.0, size=(num_classes, 1, 1, 3))
        .astype(np.float32)
    )
    imgs = rng.normal(0.0, 0.3, size=(n, 32, 32, 3)).astype(np.float32)
    imgs += centers[labels]
    return imgs, labels


def synthetic_cifar10_hard(
    n: int = 2048, num_classes: int = 10, seed: int = 0, centers_seed: int = 0,
    *, separation: float = 0.3, label_noise: float = 0.1, max_shift: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """A CIFAR-shaped task that does not saturate: each class a fixed
    low-frequency zero-mean texture (from ``centers_seed``), circularly
    shifted by a random offset in ``[0, max_shift)`` a sample, at
    ``separation`` over unit Gaussian noise, with ``label_noise`` of the
    labels flipped to uniform classes."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)

    crng = np.random.default_rng(centers_seed)
    tex = crng.normal(size=(num_classes, 32, 32, 3)).astype(np.float32)
    # keep the lowest 6 spatial frequencies an axis, then zero mean and
    # unit power
    f = np.fft.rfft2(tex, axes=(1, 2))
    keep = 6
    f[:, keep:-keep or None, :] = 0
    f[:, :, keep:] = 0
    tex = np.fft.irfft2(f, s=(32, 32), axes=(1, 2)).astype(np.float32)
    tex -= tex.mean(axis=(1, 2), keepdims=True)
    tex /= np.sqrt((tex ** 2).mean(axis=(1, 2, 3), keepdims=True))

    shifts = rng.integers(0, max(max_shift, 1), size=(n, 2))
    rows = (np.arange(32)[None, :, None] + shifts[:, 0, None, None]) % 32
    cols = (np.arange(32)[None, None, :] + shifts[:, 1, None, None]) % 32
    shifted = tex[labels][np.arange(n)[:, None, None], rows, cols, :]

    imgs = rng.normal(0.0, 1.0, size=(n, 32, 32, 3)).astype(np.float32)
    imgs += separation * shifted

    if label_noise > 0:
        flip = rng.random(n) < label_noise
        labels = np.where(flip, rng.integers(0, num_classes, size=n),
                          labels).astype(np.int32)
    return imgs, labels


def synthetic_multilabel(
    n: int = 512, num_classes: int = 3, seed: int = 0, centers_seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-label data for the BCE fine-tune: (images, multi-hot float32
    targets), each class active with probability 0.35 and adding its
    colour centre to the image."""
    rng = np.random.default_rng(seed)
    targets = (rng.random((n, num_classes)) < 0.35).astype(np.float32)
    centers = (
        np.random.default_rng(centers_seed)
        .normal(0.0, 1.0, size=(num_classes, 1, 1, 3))
        .astype(np.float32)
    )
    imgs = rng.normal(0.0, 0.3, size=(n, 32, 32, 3)).astype(np.float32)
    imgs += np.einsum("nc,chwk->nhwk", targets, centers)
    return imgs, targets
