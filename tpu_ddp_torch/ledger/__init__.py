"""Goodput ledger: cross-incarnation run accounting + checkpoint advisor.

Every other observability surface in-tree looks at ONE process lifetime —
trace/health post-hoc, analyze/lint pre-hoc, watch/profile live. The
ledger looks at the LOGICAL run: every incarnation (kill → ``--resume``
life) that executed in a run dir, stitched into one wall-clock timeline
from the artifacts the other subsystems already write:

- ``trace-p<i>[.i<k>].jsonl``  — per-incarnation span/instant/counters
  records (the telemetry JSONL sink; incarnation-stamped filenames keep
  a resumed run from destroying the dead life's evidence);
- ``heartbeat-p<i>.json``      — the watchdog's last-liveness signal,
  the evidence tail of a hung incarnation;
- checkpoint / restore spans   — the save/restore cost the Young–Daly
  advisor turns into a ``--checkpoint-steps`` recommendation.

Every second of elapsed wall-clock is classified into a fixed badput
taxonomy (``taxonomy.CATEGORIES``) that provably sums back to the
elapsed total: productive steps, compile, checkpoint save/restore, data
wait, eval, host overhead, stall, restart gap, and replayed work (steps
re-executed because resume rewound to the last checkpoint). ``tpu-ddp-torch
goodput <run_dir>`` renders the report; ``--json`` emits the
schema-versioned artifact ``tpu-ddp-torch bench compare`` gates on.

Stdlib-only end to end (no torch import): ledgers are computed wherever
the run dir lands. See ``docs/goodput.md``.

The port's copy of ``tpu_ddp/ledger/``, reading the port's run dirs and
the JAX package's alike. The ``compile`` category stays in the taxonomy
at 0 s (nothing in the port compiles a step, so no
``jax/compile_seconds`` is written), and the ``stall`` row names no
``likely_cause`` until ``diagnose/`` is ported; a ``hang`` life carries the
hang bundle's suspect collective in its notes (``comms/forensics.py``). The
ledger's identity carries ``torch_version`` for ``jax_version``.
"""

from tpu_ddp_torch.ledger.advisor import (
    mtbf_seconds,
    recommend_interval,
    young_daly_interval,
)
from tpu_ddp_torch.ledger.report import (
    LEDGER_SCHEMA_VERSION,
    ledger_json,
    render_ledger,
)
from tpu_ddp_torch.ledger.stitch import IncarnationRecord, StitchedRun, stitch_run
from tpu_ddp_torch.ledger.taxonomy import CATEGORIES, RunLedger, build_ledger

__all__ = [
    "CATEGORIES",
    "IncarnationRecord",
    "LEDGER_SCHEMA_VERSION",
    "RunLedger",
    "StitchedRun",
    "build_ledger",
    "ledger_json",
    "mtbf_seconds",
    "recommend_interval",
    "render_ledger",
    "stitch_run",
    "young_daly_interval",
]
