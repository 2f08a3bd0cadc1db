"""Cross-observatory root-cause engine (``tpu-ddp-torch diagnose``).

The port's copy of ``tpu_ddp/diagnose/``: the same evidence table, rule
registry (DIA001-DIA009), verdicts and ``--json`` artifact, on the port's
readers of the same names. DIA005 reads ``jax/cache/*`` counters, which a
port run never writes, so it fires on JAX run dirs only.

Joins every artifact family a run dir can contain — trace summaries
across incarnations, health sinks, the goodput ledger, mem/data-health
sinks, comms exposure/forensics, ``elastic.jsonl``, ``alerts.jsonl``,
profile bundle metas, lint/analyze/curves artifacts — into one
evidence table where every datum carries a citation, and runs a causal
rule registry (DIA001..) over it to name the dominant badput cause.
Stdlib-only end to end (neither torch nor numpy loads): the supervisor
attaches a verdict to each death and ``tpu-ddp-torch watch --once``
renders a likely cause from the same rules. See docs/diagnose.md.
"""

from tpu_ddp_torch.diagnose.evidence import (  # noqa: F401
    DIAG_SCHEMA_VERSION,
    Evidence,
    Source,
    gather_evidence,
)
from tpu_ddp_torch.diagnose.rules import (  # noqa: F401
    RULES,
    Verdict,
    diagnose,
    likely_cause,
    rule_counts,
)
from tpu_ddp_torch.diagnose.report import (  # noqa: F401
    build_artifact,
    render_report,
)
