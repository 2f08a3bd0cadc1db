"""Elastic runtime: verified recovery and the elastic decision log.

The port has ``recovery.py`` alone so far (``read_decisions``,
``append_decision``, ``resume_assessment``): the goodput
ledger joins the ``elastic.jsonl`` decision log it reads. The supervised
restart loop of the JAX package (``tpu_ddp/elastic/supervisor.py``,
``policy.py``, ``remesh.py``) is not ported yet. Stdlib-only.
"""

from tpu_ddp_torch.elastic.recovery import (
    ELASTIC_SCHEMA_VERSION,
    append_decision,
    read_decisions,
    resume_assessment,
)

__all__ = [
    "ELASTIC_SCHEMA_VERSION",
    "append_decision",
    "read_decisions",
    "resume_assessment",
]
