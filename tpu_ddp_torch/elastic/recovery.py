"""Verified-checkpoint recovery + the elastic decision log.

The port's copy of ``tpu_ddp/elastic/recovery.py``, with the same
``elastic.jsonl`` schema: the goodput ledger reads the decision log. The
supervisor that writes it (``supervisor.py``, ``policy.py``,
``remesh.py``), and the capacity file it reads (``read_capacity``), are
not ported yet.

Two supervisor-side concerns, both stdlib-only file archaeology:

- **Where can the next incarnation resume from?** ``resume_assessment``
  walks the checkpoint dir through the checksum manifests
  (``checkpoint/manifest.py``) exactly like the child's restore will:
  the newest verified step wins, a corrupt step is refused BY NAME and
  recorded, an unmanifested legacy step is accepted with a note. The
  supervisor logs the verdict *before* relaunching so the decision
  record says what the child is about to do — and a checkpoint dir with
  nothing restorable stops the loop instead of launching a child that
  will refuse anyway.

- **What did the supervisor decide, and why?** ``append_decision``
  writes the schema-versioned ``<run_dir>/elastic.jsonl``: one record
  per lifecycle decision (launch / restart / stop), carrying the fault
  class, policy verdict, backoff, the re-mesh plan, and the resume
  assessment. ``tpu-ddp-torch goodput`` joins it (ledger/report.py) so every
  ``restart_gap`` second in the badput taxonomy is attributed to a
  *decision*, not just observed.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from tpu_ddp_torch.checkpoint import manifest as ckpt_manifest

ELASTIC_SCHEMA_VERSION = 1

ELASTIC_LOG = "elastic.jsonl"


def elastic_log_path(run_dir: str) -> str:
    return os.path.join(run_dir, ELASTIC_LOG)


def resume_assessment(checkpoint_dir: Optional[str]) -> dict:
    """The supervisor's pre-launch restore verdict (see module doc)."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return {"resume_step": None, "refused": [], "verified": False,
                "note": "no checkpoint dir"}
    step, refusals = ckpt_manifest.latest_verified_step(checkpoint_dir)
    refused = [r for r in refusals if r["verdict"] == "refused"]
    unverifiable = any(
        r["verdict"] == "unverifiable" and r["step"] == step
        for r in refusals
    )
    return {
        "resume_step": step,
        "refused": [
            {"step": r["step"], "problems": r["problems"][:8]}
            for r in refused
        ],
        "verified": step is not None and not unverifiable,
    }


def append_decision(run_dir: str, record: dict) -> dict:
    """Append one schema-versioned decision record (line-buffered JSONL,
    one atomic-enough line per decision — the log is append-only and
    single-writer by construction: one supervisor per run dir)."""
    record = {
        "elastic_schema_version": ELASTIC_SCHEMA_VERSION,
        "wall_time": time.time(),
        **record,
    }
    os.makedirs(run_dir, exist_ok=True)
    with open(elastic_log_path(run_dir), "a") as f:
        f.write(json.dumps(record) + "\n")
        f.flush()
    return record


def read_decisions(run_dir: str) -> List[dict]:
    """Every parseable decision record, in write order; torn/over-new
    lines are skipped (a reader must survive a supervisor killed
    mid-write)."""
    path = elastic_log_path(run_dir)
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(record, dict):
                    continue
                version = record.get("elastic_schema_version")
                if (not isinstance(version, int)
                        or version > ELASTIC_SCHEMA_VERSION):
                    continue
                out.append(record)
    except OSError:
        pass
    return out
