"""Memory truth loop: live device-memory telemetry, OOM forensics.

The port's copy of ``tpu_ddp/memtrack/``:

- ``sampler.py``: the per-step :class:`MemorySampler` riding in the
  trainer beside the watchdog beat: ``torch.cuda.memory_stats`` of this
  rank's card into ``memory/*`` gauges and a schema-versioned,
  incarnation-stamped ``mem-p<i>[.i<k>].jsonl`` sink; also the one copy of
  the gauge writer that ``metrics/memory.py`` uses.
- ``reconcile.py``: the measured summary of a run's mem records, and the
  measured-vs-planned join (its planned side waits for the port's static
  plan).
- ``postmortem.py``: OOM forensics: the trainer writes a one-shot bundle
  (``<run_dir>/oom/step_<n>-p<i>/``) on an allocation failure before
  re-raising, and the goodput ledger classifies the exit as ``oom``.
- ``report.py``: ``tpu-ddp-torch mem <run_dir>``: memory timeline
  sparkline, measured-vs-planned table, fragmentation, postmortems;
  ``--json`` is a registry-recordable artifact.

Everything here but the sampler's device read is stdlib-only.
"""

from tpu_ddp_torch.memtrack.postmortem import (
    OOM_SCHEMA_VERSION,
    is_resource_exhausted,
    list_postmortems,
    write_postmortem,
)
from tpu_ddp_torch.memtrack.sampler import (
    MEM_SCHEMA_VERSION,
    MemorySampler,
    host_rss_bytes,
    mem_file_name,
    publish_memory_gauges,
)

__all__ = [
    "MEM_SCHEMA_VERSION",
    "MemorySampler",
    "OOM_SCHEMA_VERSION",
    "host_rss_bytes",
    "is_resource_exhausted",
    "list_postmortems",
    "mem_file_name",
    "publish_memory_gauges",
    "write_postmortem",
]
