"""Elastic runtime: supervised re-mesh restarts + verified recovery.

The port's copy of ``tpu_ddp/elastic/``, with the same ``__all__``. The
supervisor starts each life through the port's launcher, one process a
rank (``supervisor.py``).

The sense–act loop: the observatories are the *sense* half (FLT001
lost-host detection, the goodput ledger's restart pricing, watchdog hang
forensics, exit classification) — this package is the *act* half. ``tpu-ddp-torch elastic train …`` wraps the
training launch in a restart loop that classifies each death via the
ledger's exit taxonomy, applies a per-failure-class bounded-backoff
retry budget, re-meshes to the surviving device set (with named
refusals and an optional auto-tuner fallback plan), resumes from the
newest *verified* checkpoint, and accounts every decision in a
schema-versioned ``elastic.jsonl`` the goodput ledger joins
(docs/resilience.md).

Stdlib-only throughout: the supervisor never imports torch — it must
keep working precisely when the training runtime is the thing dying.
"""

from tpu_ddp_torch.elastic.policy import (
    DEFAULT_BUDGETS,
    BackoffPolicy,
    Decision,
    RestartPolicy,
    parse_budgets,
)
from tpu_ddp_torch.elastic.recovery import (
    ELASTIC_SCHEMA_VERSION,
    append_decision,
    read_capacity,
    read_decisions,
    resume_assessment,
)
from tpu_ddp_torch.elastic.remesh import (
    RemeshPlan,
    RemeshRefusal,
    fallback_from_tune,
    plan_remesh,
)

__all__ = [
    "BackoffPolicy",
    "DEFAULT_BUDGETS",
    "Decision",
    "ELASTIC_SCHEMA_VERSION",
    "RemeshPlan",
    "RemeshRefusal",
    "RestartPolicy",
    "append_decision",
    "fallback_from_tune",
    "parse_budgets",
    "plan_remesh",
    "read_capacity",
    "read_decisions",
    "resume_assessment",
]
