"""Per-step live memory sampler — the measured half of the memory truth loop.

The port's copy of ``tpu_ddp/memtrack/sampler.py``, with the same gauge
names, record keys and file names. The sampler rides in each training
process beside the watchdog beat (``Trainer._run_loop``), dormant when
disabled: one None-check a step when off, and when on it reads this
rank's card into:

- the telemetry registry's ``memory/*`` gauges (scrapeable live through
  the monitor exporter's ``/metrics``, snapshotted into the trace JSONL so
  the fleet aggregator and MEM001 see them after the run too), and
- a schema-versioned ``mem-p<i>[.i<k>].jsonl`` sink following the
  incarnation-stamped naming grammar (``telemetry.sink_file_name``), so a
  resumed run never truncates the dead life's memory record, the evidence
  an OOM postmortem needs.

On the card a record's source is ``memory_stats``: the allocator's
statistics of ``torch.cuda.memory_stats(d)`` (``allocated_bytes.all.
current`` and ``.peak``, so the high-water is
``torch.cuda.max_memory_allocated(d)``) and the card's ``total_memory`` as
the limit: host-side allocator reads, no device sync.
On the CPU the port keeps no live-array accounting (the JAX package counts
its live arrays there): a CPU record keeps the JAX keys with
``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` null and the
source ``none``, and only the host RSS is measured.

``host_rss_bytes``, ``sample_devices`` and ``publish_memory_gauges`` are
the one copy of the gauge writer; ``metrics/memory.py``'s epoch-boundary
adapter imports them. The module imports no torch at import time.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

#: bump on any breaking change to the mem JSONL record shape
MEM_SCHEMA_VERSION = 1

#: how many recent samples the in-process ring retains — the "last
#: memory samples" evidence an OOM postmortem bundles
RECENT_SAMPLES = 64

#: a device record's source when the backend reports nothing (the CPU)
NO_STATS_SOURCE = "none"


def mem_file_name(process_index: int, incarnation: int = 0) -> str:
    """``mem-p<i>[.i<k>].jsonl`` — the memory sink's view of the shared
    incarnation-stamped naming grammar (``telemetry.sink_file_name``;
    ``parse_sink_name`` is the inverse)."""
    from tpu_ddp_torch.telemetry import sink_file_name

    return sink_file_name("mem", process_index, incarnation, "jsonl")


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


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple:
    """(name, total bytes) of CUDA device ``index``: fixed for the
    process, so read once."""
    import torch

    return (torch.cuda.get_device_name(index),
            torch.cuda.get_device_properties(index).total_memory)


def sample_devices(device=None) -> List[dict]:
    """One point-in-time reading of this rank's device: ``[{d, kind,
    bytes_in_use, peak_bytes_in_use, bytes_limit, source}]``.

    ``device`` is a ``torch.device`` (or its string), the current CUDA
    device by default when there is one. On a CUDA device the byte fields
    are the allocator's ``allocated_bytes.all`` current and peak, read from
    ``torch.cuda.memory_stats_as_nested_dict`` (the statistics
    ``torch.cuda.memory_stats`` flattens and sorts, at about ten times the
    cost), and the card's total memory; anywhere else the record is the
    CPU's, with the byte fields null (module docstring)."""
    import torch

    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return [{"d": 0, "kind": device.type, "bytes_in_use": None,
                 "peak_bytes_in_use": None, "bytes_limit": None,
                 "source": NO_STATS_SOURCE}]
    d = torch.cuda.current_device() if device.index is None else device.index
    allocated = (torch.cuda.memory_stats_as_nested_dict(d)
                 .get("allocated_bytes", {}).get("all", {}))
    name, total = _card(d)
    return [{
        "d": d,
        "kind": name,
        "bytes_in_use": allocated.get("current", 0),
        "peak_bytes_in_use": allocated.get("peak", 0),
        "bytes_limit": total,
        "source": "memory_stats",
    }]


def publish_memory_gauges(registry, device_samples: List[dict],
                          rss: Optional[int] = None) -> None:
    """Publish one sample into the telemetry registry — the ONE gauge
    writer behind the sampler and ``metrics/memory.py``'s epoch-boundary
    adapter, so the two can't drift:

    - ``memory/d<i>/bytes_in_use``   per-device current residency
    - ``memory/bytes_in_use_max``    worst device current
      (``memory/bytes_in_use_total``: the sum; one card a rank here)
    - ``memory/high_water_bytes``    worst-device peak, monotone over the
      run (alias ``memory/peak_bytes_in_use_max``)
    - ``memory/bytes_limit_per_device``  min limit
    - ``memory/high_water_frac``     high-water / limit — MEM001's input
    - ``memory/fragmentation_bytes`` worst per-device (peak − in_use)
    - ``memory/host_rss_bytes``      host process residency
    """
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
            registry.gauge("memory/high_water_frac").set(
                high_water / min(limits))
    if frags:
        registry.gauge("memory/fragmentation_bytes").set(max(frags))
    if rss is None:
        rss = host_rss_bytes()
    if rss is not None:
        registry.gauge("memory/host_rss_bytes").set(rss)


class MemorySampler:
    """Per-step memory telemetry: gauges + the ``mem-p*`` JSONL sink.

    Built by the trainer exactly when telemetry is on (the sink lives in
    the run dir); ``every`` > 1 strides the sampling. ``on_step`` is the
    only per-step call; everything it does is host-side reads.
    ``recent()`` hands the OOM postmortem its last-samples evidence."""

    def __init__(
        self,
        run_dir: str,
        *,
        process_index: int = 0,
        incarnation: int = 0,
        telemetry=None,
        every: int = 1,
        run_meta: Optional[dict] = None,
        device=None,
    ):
        self.run_dir = run_dir
        self.process_index = process_index
        self.incarnation = incarnation
        self.telemetry = telemetry
        self.every = max(int(every), 1)
        self._device = device
        self._recent: deque = deque(maxlen=RECENT_SAMPLES)
        self._lock = threading.Lock()
        self._samples = 0
        self._next_wall = 0.0   # duty-cycle gate (see on_step)
        self._last_step: Optional[int] = None  # stride bookkeeping
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(
            run_dir, mem_file_name(process_index, incarnation))
        self._fh = open(self.path, "w")
        header = {
            "type": "header",
            "mem_schema_version": MEM_SCHEMA_VERSION,
            "pid": process_index,
            "incarnation": incarnation,
            "epoch_unix": time.time(),
        }
        if run_meta:
            header["run_meta"] = run_meta
        self._write(header)

    def _write(self, record: dict) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()  # crash-safe like the trace sink: an OOM
            # death must not take the evidence with it

    def on_step(self, step: int) -> None:
        """Sample if the stride (and the duty-cycle budget) say so.
        Never raises — memory telemetry must not kill the training it
        observes.

        The budget: sampling may spend at most ~2% of wall-clock, so
        after each sample the next one is gated ``50 × its cost`` away.
        A card's ``memory_stats`` read plus one JSONL line takes tens of
        microseconds; the gate bites only where a sample costs more than
        a fiftieth of a step."""
        # stride by boundary CROSSING, not `step % every == 0`: under
        # --steps-per-call the step counter advances K at a time, and the
        # modulo form would alias to lcm(K, every)
        crossed = (self._last_step is None
                   or (step // self.every) > (self._last_step // self.every))
        self._last_step = step
        if not crossed:
            return
        if time.time() < self._next_wall:
            return
        try:
            t0 = time.perf_counter()
            self.sample(step)
            cost = time.perf_counter() - t0
            self._next_wall = time.time() + min(cost * 50.0, 30.0)
        except Exception:
            pass

    def sample(self, step: Optional[int] = None) -> dict:
        """Take one sample now: write the JSONL record, refresh the
        gauges, remember it in the ring. Returns the record."""
        devices = sample_devices(self._device)
        rss = host_rss_bytes()
        record = {
            "schema_version": MEM_SCHEMA_VERSION,
            "type": "mem",
            "step": step,
            "wall_time": time.time(),
            "host_rss_bytes": rss,
            "devices": devices,
        }
        self._recent.append(record)
        self._samples += 1
        self._write(record)
        if self.telemetry is not None and self.telemetry.enabled:
            publish_memory_gauges(self.telemetry.registry, devices, rss)
        return record

    def recent(self) -> List[dict]:
        """The last ``RECENT_SAMPLES`` records, oldest first — the OOM
        postmortem's sample evidence."""
        return list(self._recent)

    @property
    def samples_taken(self) -> int:
        return self._samples

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
