"""Device memory gauges: the card's allocator statistics and the host's RSS.

Counterpart of ``tpu_ddp/metrics/memory.py`` (``record_memory_gauges``) and
of the gauge writer it routes through (``tpu_ddp/memtrack/sampler.py``:
``host_rss_bytes`` :52, ``publish_memory_gauges`` :125-180), with the same
gauge names:

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
there, which the port does not do. The per-step sampler and its
``mem-p<i>.jsonl`` sink (``memtrack/``) are not ported yet.
"""

from __future__ import annotations

import os
from typing import List, Optional


def host_rss_bytes() -> Optional[int]:
    """This process's resident set size in bytes: ``/proc/self/statm``
    where it exists (Linux), ``ru_maxrss`` (a high-water, KiB on Linux)
    as the portable fallback, None when neither works."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def sample_devices(device=None) -> List[dict]:
    """One record for this rank's card (``device``: a ``torch.device``,
    the current CUDA device by default): ``{"d", "kind", "bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}``; empty on the CPU."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return []
    if not torch.cuda.is_available():
        return []
    d = torch.device(device).index if device is not None else None
    d = torch.cuda.current_device() if d is None else d
    stats = torch.cuda.memory_stats(d)
    return [{
        "d": d,
        "kind": torch.cuda.get_device_name(d),
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
    }]


def publish_memory_gauges(registry, device_samples: List[dict],
                          rss: Optional[int] = None) -> None:
    """Publish one sample into the telemetry registry (the JAX
    ``publish_memory_gauges``, name for name; module docstring)."""
    in_use, peaks, limits, frags = [], [], [], []
    for rec in device_samples:
        used = rec.get("bytes_in_use")
        if isinstance(used, (int, float)):
            registry.gauge(f"memory/d{rec.get('d')}/bytes_in_use").set(used)
            in_use.append(used)
        peak = rec.get("peak_bytes_in_use")
        if isinstance(peak, (int, float)):
            peaks.append(peak)
            if isinstance(used, (int, float)):
                frags.append(max(peak - used, 0))
        limit = rec.get("bytes_limit")
        if isinstance(limit, (int, float)):
            limits.append(limit)
    if in_use:
        registry.gauge("memory/bytes_in_use_max").set(max(in_use))
        registry.gauge("memory/bytes_in_use_total").set(sum(in_use))
    high_water = max(peaks) if peaks else (max(in_use) if in_use else None)
    if high_water is not None:
        # monotone across the run: a gauge is last-write-wins, and the
        # high-water must never move backwards
        prev = registry.gauge("memory/high_water_bytes").value
        high_water = max(high_water, prev or 0)
        registry.gauge("memory/high_water_bytes").set(high_water)
        registry.gauge("memory/peak_bytes_in_use_max").set(high_water)
    if limits:
        registry.gauge("memory/bytes_limit_per_device").set(min(limits))
        if high_water is not None and min(limits) > 0:
            registry.gauge("memory/high_water_frac").set(high_water / min(limits))
    if frags:
        registry.gauge("memory/fragmentation_bytes").set(max(frags))
    if rss is None:
        rss = host_rss_bytes()
    if rss is not None:
        registry.gauge("memory/host_rss_bytes").set(rss)


def record_memory_gauges(registry, device=None) -> None:
    """The epoch-boundary adapter (the JAX ``record_memory_gauges``):
    this rank's card's picture and the host RSS as gauges."""
    publish_memory_gauges(registry, sample_devices(device))
