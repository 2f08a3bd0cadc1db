"""Perf registry: the cross-run, cross-commit results archive.

The port's copy of ``tpu_ddp/registry/`` (``store.py``, ``trend.py``,
``cli.py``): the same ``registry.jsonl`` entry shape and schema version
and the same ``TPU_DDP_REGISTRY`` variable, so one registry holds entries
recorded by either package and either package reads them. The one
difference: the stamp carries ``torch_version`` where the JAX package's
carries ``jax_version``.

PRs 5–9 built a full per-run observability arc (analyze/lint pre-hoc,
watch/profile live, trace/health/goodput post-hoc) — but every artifact
died with its run: ``bench compare`` needed a human to hand-point at one
committed baseline JSON, and nothing could answer "did this commit make
fsdp slower than the last one did?". This package is the memory those
artifacts were missing:

- ``store.py`` — an append-only JSONL archive (``registry.jsonl`` in a
  workspace dir). Every artifact the framework already emits —
  ``bench.py`` records, ``benchmarks/aot_v5e.py`` captures, ``tpu-ddp-torch
  analyze/lint/goodput/trace summarize --json``, ``watch --once
  --json`` — ingests through ``analysis/regress.py``'s artifact loader
  into one metric namespace and is stamped with provenance: git commit
  + dirty flag, the deterministic config digest (the PR 7 ``run_id``
  recipe), strategy, mesh, device kind, torch version, artifact schema
  version.
- ``trend.py`` — groups entries into per-(metric × config digest ×
  chip) time series and flags drift with the same rolling-median +
  k×MAD estimator the health/monitor stack uses (REG-prefixed finding
  ids, lint-``RULES``-pattern registry).
- ``cli.py`` — ``tpu-ddp-torch registry record|list|show|trend|diff``; diff
  reuses ``regress.compare`` so any two archived entries diff with the
  exact gating semantics CI already trusts.

``bench compare --against <registry>`` auto-selects its baseline from
the archive (newest clean entry matching the candidate's config digest
+ chip, refusing with a named reason when none matches) — no
hand-maintained committed JSON. Stdlib-only end to end, like the
ledger/monitor packages: the registry works wherever the JSON lands.
See docs/registry.md.
"""

from tpu_ddp_torch.registry.store import (
    REGISTRY_SCHEMA_VERSION,
    RegistryEntry,
    default_registry_dir,
    extract_metrics,
    read_entries,
    record_artifact,
    select_baseline,
)
from tpu_ddp_torch.registry.trend import TREND_RULES, TrendConfig, trend_findings

__all__ = [
    "REGISTRY_SCHEMA_VERSION",
    "RegistryEntry",
    "TREND_RULES",
    "TrendConfig",
    "default_registry_dir",
    "extract_metrics",
    "read_entries",
    "record_artifact",
    "select_baseline",
    "trend_findings",
]
