"""Deterministic fault injection (``--chaos spec.json``).

Counterpart of ``tpu_ddp/chaos/``: step-triggered, rank-targeted, seeded
faults injected into a live training run, so the recovery paths (verified
checkpoint fallback, save retries, the watchdog's hang class, the forensics
bundles) are exercised on demand. ``inject.py`` has the spec's schema and
the fault catalog.
"""

from tpu_ddp_torch.chaos.inject import (
    CHAOS_SCHEMA_VERSION,
    FAULT_KINDS,
    KILL_EXIT_CODE,
    ChaosInjector,
    load_spec,
)

__all__ = [
    "CHAOS_SCHEMA_VERSION",
    "FAULT_KINDS",
    "KILL_EXIT_CODE",
    "ChaosInjector",
    "load_spec",
]
