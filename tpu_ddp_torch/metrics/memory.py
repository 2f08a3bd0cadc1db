"""Device memory gauges at an epoch's end: the card's allocator statistics
and the host's RSS.

Counterpart of ``tpu_ddp/metrics/memory.py`` (``record_memory_gauges``).
The gauge writer it routes through, ``publish_memory_gauges``, with
``sample_devices`` and ``host_rss_bytes``, lives in
``memtrack/sampler.py`` (the JAX ``tpu_ddp/memtrack/sampler.py``:52-180),
as one copy that the per-step ``MemorySampler`` shares; they are imported
here under their old names. The gauges:

- ``memory/d<i>/bytes_in_use``: card i's allocated bytes now;
- ``memory/bytes_in_use_max`` and ``memory/bytes_in_use_total``: the worst
  card's and the sum (one card a rank here: the same number);
- ``memory/high_water_bytes`` (and its alias
  ``memory/peak_bytes_in_use_max``): the allocator's peak, monotone over
  the run;
- ``memory/bytes_limit_per_device``, ``memory/high_water_frac`` and
  ``memory/fragmentation_bytes`` (peak minus current);
- ``memory/host_rss_bytes``: this process's resident set.

On the card a rank reads its own device: ``torch.cuda.memory_stats(d)``
(``allocated_bytes.all.current`` and ``.peak``, so the high-water is
``torch.cuda.max_memory_allocated(d)``) and
``get_device_properties(d).total_memory``. On the CPU only the host-RSS
gauge is written: the JAX package falls back to accounting its live arrays
there, which the port does not do.
"""

from tpu_ddp_torch.memtrack.sampler import (  # noqa: F401 (the old names)
    host_rss_bytes,
    publish_memory_gauges,
    sample_devices,
)


def record_memory_gauges(registry, device=None) -> None:
    """The epoch-boundary adapter (the JAX ``record_memory_gauges``):
    this rank's card's picture and the host RSS as gauges."""
    publish_memory_gauges(registry, sample_devices(device))
