"""CIFAR-10 as numpy arrays: the raw python-pickle batches, or synthetic data.

A numpy copy of ``tpu_ddp/data/cifar10.py`` (``load_cifar10`` :181,
``_load_pickles`` :201, ``normalize`` :217, ``synthetic_cifar10`` :224), so
that the same seed gives bit-identical arrays in both packages. Images are
NHWC float32, normalised with the reference's per-channel constants.
Fetching the dataset (``download.py``) is not ported yet: the directory must
already hold ``cifar-10-batches-py`` or the ``cifar-10-python.tar.gz`` that
torchvision leaves behind, which ``_find_batches_dir`` extracts as the JAX
package's ``_find_dataset_dir`` (:86) does.
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

_SUBDIR = "cifar-10-batches-py"
_TARBALL = "cifar-10-python.tar.gz"
_MARKERS = ("data_batch_1", "test_batch")
_TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_FILES = ["test_batch"]


def _find_batches_dir(data_dir: str) -> str:
    """The batches dir under ``data_dir``: one holding every marker file;
    else the tarball's, extracted; else, with no tarball, one holding any
    marker (an eval-only placement holds just the test split, and the
    split's own files are checked when they are opened).

    Extraction is atomic, as in the JAX package: into a pid-named temp dir
    beside the tarball (temp dirs of dead processes are swept first), then
    one ``os.rename`` into place, so no reader sees half a dir. Where the
    rename finds a dir, a complete one is kept and an incomplete one is
    replaced."""
    candidates = (data_dir, os.path.join(data_dir, _SUBDIR),
                  os.path.join(data_dir, "CIFAR-10", _SUBDIR))

    def complete(c: str) -> bool:
        return all(os.path.isfile(os.path.join(c, m)) for m in _MARKERS)

    for c in candidates:
        if complete(c):
            return c
    for c in (data_dir, os.path.join(data_dir, "CIFAR-10")):
        tar = os.path.join(c, _TARBALL)
        if os.path.isfile(tar):
            return _extract(tar, c, complete)
    for c in candidates:
        if any(os.path.isfile(os.path.join(c, m)) for m in _MARKERS):
            return c
    raise FileNotFoundError(
        f"CIFAR-10 batches not found under {data_dir!r}: expected "
        f"{_SUBDIR}/data_batch_1 and test_batch, or {_TARBALL}. Use "
        "--synthetic-data for runs without the dataset."
    )


def _extract(tar: str, parent: str, complete) -> str:
    """``tar`` into ``parent/cifar-10-batches-py`` (``_find_batches_dir``)."""
    for stale in os.listdir(parent):
        if not stale.startswith(".extract.tmp."):
            continue
        try:
            os.kill(int(stale.rsplit(".", 1)[1]), 0)
        except (ValueError, ProcessLookupError):
            shutil.rmtree(os.path.join(parent, stale), ignore_errors=True)
        except PermissionError:
            pass    # a live process of another user owns it
    dst = os.path.join(parent, _SUBDIR)
    tmp = os.path.join(parent, f".extract.tmp.{os.getpid()}")
    try:
        with tarfile.open(tar) as tf:
            tf.extractall(tmp, filter="data")   # no absolute paths, no ..
        src = os.path.join(tmp, _SUBDIR)
        if not os.path.isdir(src):
            raise FileNotFoundError(
                f"{tar} does not hold the canonical {_SUBDIR}/ layout")
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
    batches_dir = _find_batches_dir(data_dir)
    imgs, labels = [], []
    for name in _TRAIN_FILES if train else _TEST_FILES:
        with open(os.path.join(batches_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"])
        labels.extend(d[b"labels"])
    raw = np.concatenate(imgs)  # (N, 3072) planar RGB, uint8
    return decode_normalize(raw), np.asarray(labels, np.int32)


def decode_normalize(raw: np.ndarray) -> np.ndarray:
    """(N, 3072) uint8 planar RGB -> (N, 32, 32, 3) float32 normalised."""
    n = raw.shape[0]
    x = raw.reshape(n, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    return (x - CIFAR10_MEAN) / CIFAR10_STD


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
