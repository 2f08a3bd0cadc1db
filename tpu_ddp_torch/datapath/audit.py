"""Batch-provenance digests: the writer's half of the determinism audit.

Counterpart of ``tpu_ddp/datapath/audit.py`` (``batch_digest``, ``xor_hex``,
``DataDigestWriter`` :78), record for record: both packages' host batches
are float32 NHWC images and int32 labels, bit for bit
(``data/cifar10.py``), so a run's digests equal the JAX trainer's.

- :func:`batch_digest` — a seeded per-step content digest: each mask-true
  sample's bytes (image row + label) are hashed with keyed blake2b and
  XOR-combined into one 64-bit value. XOR makes the digest
  partition-invariant: a step's global digest is the XOR of the ranks'
  digests for any split of the same global sample set.
- :func:`xor_row_digests` — the same digest from per-row digests that the
  native prefetcher's gather hashed (``native/blake2b.h``), equal to
  ``batch_digest`` of the rows; the trainer's native ring path takes it.
- :class:`DataDigestWriter` — appends per-step records to the
  incarnation-stamped ``data-p<i>[.i<k>].jsonl`` sink (the telemetry naming
  grammar), one header + one line a step, flushed a line at a time so a
  kill loses at most the in-flight step.

The reader and its audit (``audit_digests``, ``tpu-ddp data audit``) are
not ported yet. numpy + stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from tpu_ddp_torch.telemetry import sink_file_name

#: bump on any breaking change to the digest-sink record shape
DATA_DIGEST_SCHEMA_VERSION = 1

DIGEST_SINK_PREFIX = "data"


def batch_digest(
    image: np.ndarray,
    label: np.ndarray,
    mask: np.ndarray,
    *,
    seed: int = 0,
) -> Tuple[str, int]:
    """XOR-of-keyed-blake2b digest over the batch's mask-true samples.

    Returns ``(hex16, n_real)``. Order-independent and
    partition-invariant by construction (XOR is commutative), so the
    same global sample set digests identically regardless of shuffle
    order within the step or host/device placement.
    """
    img = np.ascontiguousarray(image)
    lab = np.ascontiguousarray(label)
    msk = np.asarray(mask).reshape(-1).astype(bool)
    key = (int(seed) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    acc = 0
    n = 0
    for i in np.flatnonzero(msk):
        h = hashlib.blake2b(digest_size=8, key=key)
        h.update(img[i].tobytes())
        h.update(lab[i].tobytes())
        acc ^= int.from_bytes(h.digest(), "big")
        n += 1
    return f"{acc:016x}", n


def xor_row_digests(row_digests: np.ndarray, mask: np.ndarray) -> Tuple[str, int]:
    """``batch_digest`` from each row's 8 digest bytes (``(n, 8)`` uint8,
    each the keyed blake2b that ``batch_digest`` takes of the row, as the
    native prefetcher writes them): the XOR over the mask-true rows, read
    big-endian. Returns ``(hex16, n_real)``."""
    msk = np.asarray(mask).reshape(-1).astype(bool)
    vals = np.ascontiguousarray(row_digests[msk]).view(">u8").reshape(-1)
    acc = int(np.bitwise_xor.reduce(vals)) if vals.size else 0
    return f"{acc:016x}", int(vals.size)


def xor_hex(a: str, b: str) -> str:
    return f"{int(a, 16) ^ int(b, 16):016x}"


class DataDigestWriter:
    """Append per-step digest records to ``data-p<i>.i<k>.jsonl``.

    The file is opened fresh per incarnation (the incarnation stamp
    makes the name unique), a header record first, then one record per
    recorded step. Lines are flushed immediately: after a kill the sink
    holds every completed step of that life.
    """

    def __init__(
        self,
        run_dir: str,
        *,
        process_index: int = 0,
        incarnation: int = 0,
        seed: int = 0,
        run_id: Optional[str] = None,
        global_batch: Optional[int] = None,
    ) -> None:
        self.path = os.path.join(
            run_dir,
            sink_file_name(DIGEST_SINK_PREFIX, process_index, incarnation),
        )
        self.seed = int(seed)
        self._f = open(self.path, "w", encoding="utf-8")
        self._emit(
            {
                "type": "header",
                "data_digest_schema_version": DATA_DIGEST_SCHEMA_VERSION,
                "process_index": int(process_index),
                "incarnation": int(incarnation),
                "seed": self.seed,
                "run_id": run_id,
                "global_batch": global_batch,
            }
        )

    def _emit(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()

    def record(self, step: int, batch: Dict[str, np.ndarray]) -> str:
        digest, n_real = batch_digest(
            batch["image"], batch["label"], batch["mask"], seed=self.seed
        )
        self._emit(
            {"type": "digest", "step": int(step), "n_real": n_real, "digest": digest}
        )
        return digest

    def record_digest(self, step: int, digest: str, n_real: int) -> None:
        self._emit(
            {"type": "digest", "step": int(step), "n_real": int(n_real), "digest": digest}
        )

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
