"""Structured telemetry: step-phase tracing, counters, sinks, watchdog.

Counterpart of ``tpu_ddp/telemetry`` (``__init__.py``, ``events.py``,
``registry.py``, ``core.py``, ``sinks.py``, ``provenance.py``,
``watchdog.py``, ``summarize.py``), with the same span, counter, gauge,
instant and file names and the same schema versions, so a reader of the
JAX package's run dirs reads the port's. The trainer, the loaders, the
checkpoint manager, the health monitor and the launcher emit into one
``Telemetry`` object, which fans out to pluggable sinks:

- ``jsonl``: schema-versioned JSON Lines (``trace-p<rank>.jsonl``), flushed
  a line at a time, the run header first; read back by ``python -m
  tpu_ddp_torch.cli.main trace summarize DIR``.
- ``chrome``: Chrome trace_event JSON (``trace-p<rank>.trace.json``),
  loadable in Perfetto.
- ``summary``: the per-phase duration table, printed at the end by rank 0.

Alongside: a process-wide registry of counters, gauges and histograms, and
a hang watchdog (a heartbeat file a rank and a stack dump on a stall).

The JAX package's ``jax_hooks.py`` (XLA compile counters) has no
counterpart: nothing in the port compiles a step, so no ``jax/*`` counter
is written. The package is stdlib-only: the launcher emits job events from
a process that imports no torch, and traces summarize on any machine.
"""


from tpu_ddp_torch.telemetry.core import NULL, Telemetry
from tpu_ddp_torch.telemetry.events import (
    EVAL_POINT_SCHEMA_VERSION,
    RUN_META_SCHEMA_VERSION,
    SCHEMA_VERSION,
    Clock,
    Event,
)
from tpu_ddp_torch.telemetry.provenance import (
    PROVENANCE_SCHEMA_VERSION,
    artifact_provenance,
    config_digest,
    git_provenance,
    quality_digest,
)
from tpu_ddp_torch.telemetry.registry import (
    Registry,
    default_registry,
    reset_default_registry,
)
from tpu_ddp_torch.telemetry.sinks import (
    ChromeTraceSink,
    JsonlTraceSink,
    Sink,
    TerminalSummarySink,
)
from tpu_ddp_torch.telemetry.watchdog import HANG_EXIT_CODE, HangWatchdog

#: Default sink set when a run dir is given but no sink list.
DEFAULT_SINKS = "jsonl,chrome,summary"


def sink_file_name(prefix: str, process_index: int, incarnation: int = 0,
                   ext: str = "jsonl") -> str:
    """The per-host, per-incarnation sink naming grammar shared by every
    file family a run writes (``trace`` / ``health`` / ``mem``):
    ``<prefix>-p<i>[.i<k>].<ext>``. Incarnation 0 keeps the legacy
    unstamped names so single-incarnation run dirs look exactly as
    before; a resumed run's incarnation ``k`` stamps ``.i<k>`` instead
    of truncating the previous incarnation's file — the previous life's
    records are evidence the goodput ledger stitches, not scratch to
    overwrite. ``parse_sink_name`` is the inverse; keep them together."""
    suffix = f".i{incarnation}" if incarnation else ""
    return f"{prefix}-p{process_index}{suffix}.{ext}"


def parse_sink_name(name: str, prefix: str = None):
    """Inverse of ``sink_file_name``: ``(prefix, process_index,
    incarnation, ext)`` for a sink basename, None for anything else (or
    for a different family when ``prefix`` is given). The ONE parser of
    the naming grammar — trace/health/mem discovery and
    ``next_incarnation`` all route through it, so the writers and their
    readers cannot drift."""
    import re

    m = re.match(
        r"^([a-z]+)-p(\d+)(?:\.i(\d+))?\.(jsonl|trace\.json)$", name)
    if not m:
        return None
    if prefix is not None and m.group(1) != prefix:
        return None
    return m.group(1), int(m.group(2)), int(m.group(3) or 0), m.group(4)


def trace_file_name(process_index: int, incarnation: int = 0,
                    kind: str = "jsonl") -> str:
    """Trace-sink filename (``trace-p<i>[.i<k>].jsonl`` /
    ``.trace.json``) — the trace family's view of the shared
    :func:`sink_file_name` grammar."""
    ext = {"jsonl": "jsonl", "chrome": "trace.json"}[kind]
    return sink_file_name("trace", process_index, incarnation, ext)


def parse_trace_name(name: str):
    """``(process_index, incarnation, kind)`` for a trace sink basename,
    None for anything else; routes through :func:`parse_sink_name` so
    there is exactly one grammar parser."""
    parsed = parse_sink_name(name, prefix="trace")
    if parsed is None:
        return None
    _, pid, inc, ext = parsed
    return pid, inc, "jsonl" if ext == "jsonl" else "chrome"


def next_incarnation(run_dir, process_index: int = 0, *,
                     prefix: str = "trace") -> int:
    """The incarnation index a process booting into ``run_dir`` should
    stamp its artifacts with: one past the highest incarnation whose
    trace files already exist for this host (0 in a fresh dir). Derived
    purely from the files on disk — no coordination, no sidecar state —
    so a ``--resume`` after a SIGKILL lands on the right index even
    though the killed life never ran any shutdown code. ``prefix`` names
    another file family to count instead (the health monitor's
    ``health``, for a run that writes health records and no trace)."""
    import os

    if not run_dir or not os.path.isdir(run_dir):
        return 0
    newest = -1
    for name in os.listdir(run_dir):
        parsed = parse_sink_name(name, prefix=prefix)
        if parsed and parsed[1] == process_index:
            newest = max(newest, parsed[2])
    return newest + 1


def build_telemetry(
    run_dir,
    sinks: str = DEFAULT_SINKS,
    *,
    process_index: int = 0,
    run_meta=None,
    incarnation: int = 0,
) -> Telemetry:
    """Construct a Telemetry for ``run_dir`` with the named sinks
    (comma-separated subset of ``jsonl,chrome,summary``), or the disabled
    ``NULL`` instance when ``run_dir`` is falsy.

    Per-host trace files (``trace-p<i>.jsonl`` / ``trace-p<i>.trace.json``)
    keep multi-rank runs collision-free in a shared run dir; the terminal
    summary only prints from rank 0. ``incarnation`` > 0 (a resumed
    run's next life in the same dir — see ``next_incarnation``) stamps
    the filenames ``trace-p<i>.i<k>.*`` so each life writes its own
    files instead of destroying the previous life's record.

    ``run_meta`` (a JSON-serializable dict: config snapshot, torch and
    CUDA versions, device kind, mesh shape, strategy, schema_version) is
    written as the first record of every file sink, so the summarizer can
    label the run instead of treating run dirs as anonymous.
    """
    if not run_dir:
        return NULL
    import os

    os.makedirs(run_dir, exist_ok=True)
    clock = Clock()
    built = []
    names = [s.strip() for s in (sinks or DEFAULT_SINKS).split(",") if s.strip()]
    for name in names:
        if name == "jsonl":
            built.append(JsonlTraceSink(
                os.path.join(run_dir, trace_file_name(
                    process_index, incarnation, "jsonl")),
                clock=clock, process_index=process_index,
                run_meta=run_meta,
            ))
        elif name == "chrome":
            built.append(ChromeTraceSink(
                os.path.join(run_dir, trace_file_name(
                    process_index, incarnation, "chrome")),
                process_index=process_index, run_meta=run_meta,
            ))
        elif name == "summary":
            if process_index == 0:
                built.append(TerminalSummarySink())
        else:
            raise ValueError(
                f"unknown telemetry sink {name!r} "
                f"(expected a subset of {DEFAULT_SINKS})"
            )
    return Telemetry(built, process_index=process_index, clock=clock)


__all__ = [
    "NULL",
    "Telemetry",
    "Clock",
    "Event",
    "SCHEMA_VERSION",
    "RUN_META_SCHEMA_VERSION",
    "EVAL_POINT_SCHEMA_VERSION",
    "PROVENANCE_SCHEMA_VERSION",
    "artifact_provenance",
    "config_digest",
    "git_provenance",
    "quality_digest",
    "Registry",
    "default_registry",
    "reset_default_registry",
    "Sink",
    "JsonlTraceSink",
    "ChromeTraceSink",
    "TerminalSummarySink",
    "HANG_EXIT_CODE",
    "HangWatchdog",
    "DEFAULT_SINKS",
    "build_telemetry",
    "next_incarnation",
    "parse_sink_name",
    "parse_trace_name",
    "sink_file_name",
    "trace_file_name",
]
