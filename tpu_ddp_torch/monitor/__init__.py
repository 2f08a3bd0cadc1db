"""Live fleet monitor: the while-it-runs observability surface.

The port's copy of ``tpu_ddp/monitor/``: the same snapshot, alert and
report shapes and schema versions, so either package's ``watch`` reads
either's run dirs. The rest of the port's readers are post-hoc (``trace
summarize``, ``health``, ``goodput`` read the JSONL after the run); this
package watches a run *while it is running*:

- ``exporter``: a stdlib-only per-rank HTTP endpoint (``--monitor-port``)
  serving ``/metrics`` (OpenMetrics text from the telemetry registry,
  labeled with the run header), ``/snapshot.json``, and ``/healthz``
  (backed by the watchdog heartbeat), plus ``POST /profile``.
- ``aggregate``: a fleet aggregator that tails a run dir's per-rank
  telemetry/health/heartbeat files into a rolling ``FleetSnapshot`` and
  flags stragglers (k×MAD off the fleet median) and lost hosts (stale
  heartbeat). A host is a rank: one process each in the port.
- ``alerts``: a declarative rule engine over snapshots, emitting
  schema-versioned ``alerts.jsonl`` plus log/file/webhook/capture actions.
- ``watch``: ``tpu-ddp-torch watch <run_dir>``: a live terminal dashboard,
  with ``--once --json`` for scripting and CI.

Stdlib-only end to end: snapshots are read wherever the run dir lands.
"""

from tpu_ddp_torch.monitor.aggregate import (
    SNAPSHOT_SCHEMA_VERSION,
    FleetAggregator,
    FleetSnapshot,
    HostSnapshot,
    MonitorConfig,
    host_skew,
    read_fleet_snapshot,
)
from tpu_ddp_torch.monitor.alerts import (
    ALERT_RULES,
    ALERT_SCHEMA_VERSION,
    CAPTURE_PROFILE_RULES,
    Alert,
    AlertEngine,
    alert_history,
)
from tpu_ddp_torch.monitor.exporter import MonitorExporter, render_openmetrics

__all__ = [
    "SNAPSHOT_SCHEMA_VERSION",
    "ALERT_SCHEMA_VERSION",
    "ALERT_RULES",
    "CAPTURE_PROFILE_RULES",
    "Alert",
    "AlertEngine",
    "alert_history",
    "FleetAggregator",
    "FleetSnapshot",
    "HostSnapshot",
    "MonitorConfig",
    "MonitorExporter",
    "host_skew",
    "read_fleet_snapshot",
    "render_openmetrics",
]
