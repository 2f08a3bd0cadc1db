"""Dataset fetch: the ``download=True`` convenience of the reference.

The port's copy of ``tpu_ddp/data/download.py`` (``_md5`` :55, ``_fetch``
:66, ``ensure_dataset`` :91). The loader reads the raw pickle batches
(``data/cifar10.py``); ``ensure_dataset`` gets the canonical tarball onto
disk, torchvision-style:

- extracted batches already present -> no-op;
- a tarball already present -> MD5-verify it; a bad (truncated) tarball is
  deleted and fetched again rather than handed to the loader;
- otherwise fetch (stdlib ``urllib``), checksum, and land atomically via a
  per-process temp file and ``os.replace``;
- under the launcher only local rank 0 of a host fetches and extracts; the
  other ranks poll for the extracted batches.

With ``download=False`` a missing dataset is left to the loader's own error.
``url`` and ``md5`` override the canonical source (mirrors; the tests serve
a fake tarball over ``file://``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
import urllib.request

from tpu_ddp_torch.data.cifar10 import (
    DATASET_LAYOUTS,
    ensure_extracted,
    existing_tarball,
    extracted_dataset_dir,
)
from tpu_ddp_torch.parallel.runtime import local_rank

log = logging.getLogger(__name__)

CANON = {
    "cifar10": ("https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
                "c58f30108f718f92721af3b95e74349a"),
    "cifar100": ("https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
                 "eb9058c3a382ffc7106e4002c42a8d85"),
}


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fetch(url: str, dest: str, md5: str) -> None:
    """Download to a per-process temp file, verify, land atomically: two
    racing processes each verify their own bytes, and ``dest`` is never
    half written."""
    part = f"{dest}.part.{os.getpid()}"
    try:
        with urllib.request.urlopen(url) as r, open(part, "wb") as f:
            while True:
                b = r.read(1 << 20)
                if not b:
                    break
                f.write(b)
        got = _md5(part)
        if got != md5:
            raise IOError(f"checksum mismatch for {url}: got {got}, want {md5} "
                          f"(truncated or tampered download; removed)")
        os.replace(part, dest)
    finally:
        if os.path.exists(part):
            os.remove(part)


def ensure_dataset(data_dir: str, dataset: str = "cifar10", *, download: bool = False,
                   url: str | None = None, md5: str | None = None,
                   wait_timeout: float = 900.0) -> str:
    """Make sure ``data_dir`` holds ``dataset``; returns ``data_dir`` (module
    docstring). ``wait_timeout`` caps a non-zero local rank's wait for rank
    0's extraction."""
    if dataset not in DATASET_LAYOUTS:
        raise ValueError(f"unknown dataset {dataset!r}; one of {list(DATASET_LAYOUTS)}")
    default_url, default_md5 = CANON[dataset]
    url = url or default_url
    md5 = md5 or default_md5
    tarball = DATASET_LAYOUTS[dataset][2]

    if extracted_dataset_dir(data_dir, dataset) is not None:
        return data_dir

    rank = local_rank()
    have = existing_tarball(data_dir, dataset)
    if rank != 0 and (download or have is not None):
        # one fetch and one extraction a host: rank 0 owns the artifact; the
        # others wait for the extracted batches, never for a tarball rank 0
        # may be about to delete
        deadline = time.monotonic() + wait_timeout
        while time.monotonic() < deadline:
            if extracted_dataset_dir(data_dir, dataset) is not None:
                return data_dir
            time.sleep(1.0)
        raise TimeoutError(f"local rank {rank}: waited {wait_timeout:.0f}s for rank "
                           f"0's extracted {dataset} batches under {data_dir!r}")

    if have is not None:
        if not download:
            ensure_extracted(data_dir, dataset)
            return data_dir
        if _md5(have) == md5:
            ensure_extracted(data_dir, dataset)
            return data_dir
        log.warning("%s fails its checksum; re-downloading", have)
        os.remove(have)
    if not download:
        return data_dir  # the loader raises its own error

    os.makedirs(data_dir, exist_ok=True)
    _fetch(url, os.path.join(data_dir, tarball), md5)
    ensure_extracted(data_dir, dataset)
    return data_dir
