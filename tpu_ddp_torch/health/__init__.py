"""Numerics flight recorder: health stats on the device, NaN/Inf
sentinels, the skip-step guard, and anomaly-triggered diagnostics.

Counterpart of ``tpu_ddp/health/`` (``docs/health.md``), in three layers:

- ``stats``: the step's half: global and per-layer norms, the update
  ratio and the finiteness sentinels, computed on the device inside the
  step, and the skip-step guard that leaves the state as it was after a
  non-finite step. Imports torch.
- ``monitor``: the host half: the per-step JSONL record, the rolling
  median + MAD loss-spike detector, the one-shot anomaly dump
  (``run_dir/anomalies/step_<n>/``) with the offending batch and recent
  history, and the policy verdict. numpy and stdlib.
- ``summarize``: the read-back half, ``python -m tpu_ddp_torch.cli.main health
  DIR``. Stdlib only.

The exports are those of the JAX package, loaded lazily so the summary
never imports torch.
"""

from tpu_ddp_torch.health.summarize import (  # noqa: F401  (stdlib only)
    HEALTH_SCHEMA_VERSION,
    summarize_health,
)

_LAZY = {
    "HealthConfig": "tpu_ddp_torch.health.stats",
    "HEALTH_SCALAR_KEYS": "tpu_ddp_torch.health.stats",
    "health_stats": "tpu_ddp_torch.health.stats",
    "assemble_stats": "tpu_ddp_torch.health.stats",
    "tree_sq": "tpu_ddp_torch.health.stats",
    "tree_nonfinite": "tpu_ddp_torch.health.stats",
    "per_layer_sq": "tpu_ddp_torch.health.stats",
    "tree_select_": "tpu_ddp_torch.health.stats",
    "SkipGuard": "tpu_ddp_torch.health.stats",
    "HealthMonitor": "tpu_ddp_torch.health.monitor",
    "SpikeDetector": "tpu_ddp_torch.health.monitor",
    "POLICIES": "tpu_ddp_torch.health.monitor",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "HEALTH_SCHEMA_VERSION",
    "summarize_health",
    *sorted(_LAZY),
]
