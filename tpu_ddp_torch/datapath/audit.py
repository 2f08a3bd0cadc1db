"""Batch-provenance digests and the determinism audit.

Counterpart of ``tpu_ddp/datapath/audit.py`` (``batch_digest``, ``xor_hex``,
``DataDigestWriter`` :78, ``read_digest_files``, ``audit_digests`` and
``format_audit`` :143-316), record for record: both packages' host batches
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
- :func:`read_digest_files` and :func:`audit_digests` — the reader's half
  (``tpu-ddp-torch data audit``): every step two lives of a run both
  recorded must carry the same global digest (the XOR of the ranks'),
  fail-closed naming the first diverging step.

The digests import numpy when they run; the reader and the audit are
stdlib only.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from tpu_ddp_torch.telemetry import parse_sink_name, sink_file_name

#: bump on any breaking change to the digest-sink record shape
DATA_DIGEST_SCHEMA_VERSION = 1

DIGEST_SINK_PREFIX = "data"


def batch_digest(image, label, mask, *, seed: int = 0) -> Tuple[str, int]:
    """XOR-of-keyed-blake2b digest over the batch's mask-true samples.

    Returns ``(hex16, n_real)``. Order-independent and
    partition-invariant by construction (XOR is commutative), so the
    same global sample set digests identically regardless of shuffle
    order within the step or host/device placement.
    """
    import numpy as np

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


def xor_row_digests(row_digests, mask) -> Tuple[str, int]:
    """``batch_digest`` from each row's 8 digest bytes (``(n, 8)`` uint8,
    each the keyed blake2b that ``batch_digest`` takes of the row, as the
    native prefetcher writes them): the XOR over the mask-true rows, read
    big-endian. Returns ``(hex16, n_real)``."""
    import numpy as np

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

    def record(self, step: int, batch: Dict[str, Any]) -> str:
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


# -- reading + auditing ------------------------------------------------


def read_digest_files(run_dir: str) -> List[Dict[str, Any]]:
    """Load every ``data-p<i>[.i<k>].jsonl`` sink in ``run_dir``.

    Returns one entry per file:
    ``{path, process_index, incarnation, header, steps: {step: (digest, n_real)}}``.
    Malformed lines are skipped (a kill can tear the last line).
    """
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return out
    for name in names:
        parsed = parse_sink_name(name)
        if parsed is None:
            continue
        prefix, pid, inc, ext = parsed
        if prefix != DIGEST_SINK_PREFIX or ext != "jsonl":
            continue
        header: Optional[Dict[str, Any]] = None
        steps: Dict[int, Tuple[str, int]] = {}
        try:
            with open(os.path.join(run_dir, name), "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if not isinstance(rec, dict):
                        continue
                    if rec.get("type") == "header":
                        header = rec
                    elif rec.get("type") == "digest":
                        try:
                            steps[int(rec["step"])] = (
                                str(rec["digest"]),
                                int(rec.get("n_real", 0)),
                            )
                        except (KeyError, TypeError, ValueError):
                            continue
        except OSError:
            continue
        out.append(
            {
                "path": os.path.join(run_dir, name),
                "process_index": pid,
                "incarnation": inc or 0,
                "header": header,
                "steps": steps,
            }
        )
    return out


def _merge_incarnation(files: List[Dict[str, Any]]) -> Dict[int, Tuple[str, int]]:
    """XOR per-host digests into the incarnation's global per-step digest."""
    merged: Dict[int, Tuple[str, int]] = {}
    for rec in files:
        for step, (digest, n_real) in rec["steps"].items():
            if step in merged:
                merged[step] = (xor_hex(merged[step][0], digest), merged[step][1] + n_real)
            else:
                merged[step] = (digest, n_real)
    return merged


def audit_digests(run_dir: str) -> Dict[str, Any]:
    """Cross-incarnation determinism verdict for a run directory.

    Every step recorded by two or more incarnations must carry the
    same global digest. Returns a verdict dict::

        {ok, incarnations: [..], steps_recorded, steps_compared,
         pairs: [{incarnations: (a, b), overlap, ok,
                  first_diverging_step, digest_a, digest_b}, ...],
         error}

    ``ok`` is ``None`` (with ``error`` set) when there is no evidence
    to audit — no sinks, or no incarnation overlap at all is still
    ``ok=True`` with ``steps_compared=0`` only if multiple incarnations
    exist; a single incarnation trivially passes.
    """
    files = read_digest_files(run_dir)
    if not files:
        return {
            "ok": None,
            "error": f"no data digest sinks (data-p*.jsonl) found in {run_dir!r}",
            "incarnations": [],
            "steps_recorded": 0,
            "steps_compared": 0,
            "pairs": [],
        }
    by_inc: Dict[int, List[Dict[str, Any]]] = {}
    for rec in files:
        by_inc.setdefault(rec["incarnation"], []).append(rec)
    # refuse to merge hosts benched with different digest seeds
    seeds = {
        h.get("seed")
        for recs in by_inc.values()
        for h in (r["header"] for r in recs)
        if isinstance(h, dict)
    }
    if len(seeds) > 1:
        return {
            "ok": False,
            "error": f"digest sinks disagree on seed ({sorted(seeds)}): not comparable",
            "incarnations": sorted(by_inc),
            "steps_recorded": sum(len(r["steps"]) for r in files),
            "steps_compared": 0,
            "pairs": [],
        }
    merged = {inc: _merge_incarnation(recs) for inc, recs in by_inc.items()}
    incs = sorted(merged)
    pairs: List[Dict[str, Any]] = []
    ok = True
    steps_compared = 0
    for i, a in enumerate(incs):
        for b in incs[i + 1 :]:
            overlap = sorted(set(merged[a]) & set(merged[b]))
            steps_compared += len(overlap)
            first_bad: Optional[int] = None
            da = db = None
            for step in overlap:
                if merged[a][step][0] != merged[b][step][0]:
                    first_bad = step
                    da, db = merged[a][step][0], merged[b][step][0]
                    break
            pair_ok = first_bad is None
            ok = ok and pair_ok
            pairs.append(
                {
                    "incarnations": (a, b),
                    "overlap": len(overlap),
                    "ok": pair_ok,
                    "first_diverging_step": first_bad,
                    "digest_a": da,
                    "digest_b": db,
                }
            )
    return {
        "ok": ok,
        "error": None,
        "incarnations": incs,
        "steps_recorded": sum(len(m) for m in merged.values()),
        "steps_compared": steps_compared,
        "pairs": pairs,
    }


def format_audit(verdict: Dict[str, Any]) -> str:
    lines = ["data determinism audit"]
    if verdict.get("error"):
        lines.append(f"  error: {verdict['error']}")
        return "\n".join(lines)
    lines.append(
        f"  incarnations: {verdict['incarnations']}  "
        f"steps recorded: {verdict['steps_recorded']}  "
        f"overlapping steps compared: {verdict['steps_compared']}"
    )
    for p in verdict["pairs"]:
        a, b = p["incarnations"]
        if p["ok"]:
            lines.append(f"  i{a} vs i{b}: OK ({p['overlap']} overlapping steps match)")
        else:
            lines.append(
                f"  i{a} vs i{b}: FAIL at step {p['first_diverging_step']} "
                f"({p['digest_a']} != {p['digest_b']}) — the resumed run did not "
                f"see the same batches"
            )
    lines.append(f"  verdict: {'PASS' if verdict['ok'] else 'FAIL'}")
    return "\n".join(lines)
