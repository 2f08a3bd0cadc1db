"""Measured-vs-planned reconciliation of a run's memory.

The port's copy of ``tpu_ddp/memtrack/reconcile.py``. Reading the mem
record (``find_mem_files``, ``read_mem_records``, ``measured_summary``) is
the JAX code. :func:`reconcile` joins the measured high-water against the
static plan of the recorded program; the port has no plan yet
(``memtrack/postmortem.py::plan_for_run_meta``), so its planned side is
None with the note saying why, and the measured side is whole. A CPU run's
record has no device bytes at all (``memtrack/sampler.py``), which the
join notes too. Stdlib-only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from tpu_ddp_torch.memtrack.sampler import MEM_SCHEMA_VERSION


def find_mem_files(run_dir: str) -> Dict[int, List[str]]:
    """{process_index: [paths, incarnation order]} of the run dir's mem
    sinks — ALL incarnations (the reconciliation wants the whole run's
    high-water, not just the last life's)."""
    from tpu_ddp_torch.telemetry import parse_sink_name

    by_host: Dict[int, List[tuple]] = {}
    for path in glob.glob(os.path.join(run_dir, "mem-p*.jsonl")):
        parsed = parse_sink_name(os.path.basename(path), prefix="mem")
        if parsed is None:
            continue
        _, pid, inc, _ = parsed
        by_host.setdefault(pid, []).append((inc, path))
    return {pid: [p for _, p in sorted(pairs)]
            for pid, pairs in sorted(by_host.items())}


def read_mem_records(run_dir: str):
    """``(headers, records)`` across every host and incarnation, each
    annotated with ``pid``/``incarnation``. Torn lines are skipped, a
    future-schema header refuses (misreading a newer record shape is
    worse than stopping)."""
    files = find_mem_files(run_dir)
    if not files:
        raise FileNotFoundError(
            f"no memory record under {run_dir!r} (expected "
            "mem-p*[.i<k>].jsonl — run with --telemetry-dir; "
            "docs/memory.md)")
    headers: List[dict] = []
    records: List[dict] = []
    for pid, paths in files.items():
        for path in paths:
            from tpu_ddp_torch.telemetry import parse_sink_name

            _, _, inc, _ = parse_sink_name(
                os.path.basename(path), prefix="mem")
            try:
                fh = open(path)
            except OSError:
                continue
            with fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    rec["pid"], rec["incarnation"] = pid, inc
                    if rec.get("type") == "header":
                        version = rec.get("mem_schema_version", 0)
                        if isinstance(version, int) \
                                and version > MEM_SCHEMA_VERSION:
                            raise ValueError(
                                f"{path}: mem_schema_version {version} "
                                "is newer than this tool understands "
                                f"({MEM_SCHEMA_VERSION})")
                        headers.append(rec)
                    elif rec.get("type") == "mem":
                        records.append(rec)
    return headers, records


def _worst(values: List) -> Optional[float]:
    vals = [v for v in values if isinstance(v, (int, float))]
    return max(vals) if vals else None


def measured_summary(run_dir: str) -> dict:
    """Reduce the run dir's mem records to the measured picture: per
    host — per-device high-water, limit, fragmentation, host RSS, and
    the worst-device in-use series the CLI sparklines — plus the fleet
    roll-up (worst chip anywhere, min limit)."""
    headers, records = read_mem_records(run_dir)
    hosts: Dict[int, dict] = {}
    for rec in records:
        pid = rec["pid"]
        h = hosts.setdefault(pid, {
            "host": pid, "samples": 0, "incarnations": set(),
            "per_device": {}, "series": [], "steps": [],
            "host_rss_max_bytes": None, "sources": set(),
        })
        h["samples"] += 1
        h["incarnations"].add(rec["incarnation"])
        rss = rec.get("host_rss_bytes")
        if isinstance(rss, (int, float)):
            h["host_rss_max_bytes"] = max(
                h["host_rss_max_bytes"] or 0, rss)
        worst_in_use = None
        for d in rec.get("devices") or []:
            idx = d.get("d")
            dev = h["per_device"].setdefault(idx, {
                "d": idx, "kind": d.get("kind"),
                "high_water_bytes": None, "bytes_limit": None,
                "fragmentation_bytes": None,
            })
            used = d.get("bytes_in_use")
            peak = d.get("peak_bytes_in_use")
            high = _worst([used, peak])
            if high is not None:
                dev["high_water_bytes"] = max(
                    dev["high_water_bytes"] or 0, high)
            if isinstance(d.get("bytes_limit"), (int, float)):
                dev["bytes_limit"] = d["bytes_limit"]
            if isinstance(peak, (int, float)) \
                    and isinstance(used, (int, float)):
                frag = max(peak - used, 0)
                dev["fragmentation_bytes"] = max(
                    dev["fragmentation_bytes"] or 0, frag)
            if d.get("source"):
                h["sources"].add(d["source"])
            if isinstance(used, (int, float)):
                worst_in_use = max(worst_in_use or 0, used)
        h["series"].append(worst_in_use)
        h["steps"].append(rec.get("step"))
    out_hosts = {}
    for pid, h in hosts.items():
        devices = [h["per_device"][k]
                   for k in sorted(h["per_device"],
                                   key=lambda x: (x is None, x))]
        limits = [d["bytes_limit"] for d in devices
                  if d["bytes_limit"] is not None]
        out_hosts[pid] = {
            "host": pid,
            "samples": h["samples"],
            "incarnations": sorted(h["incarnations"]),
            "per_device": devices,
            "high_water_bytes": _worst(
                [d["high_water_bytes"] for d in devices]),
            "bytes_limit": min(limits) if limits else None,
            "fragmentation_bytes": _worst(
                [d["fragmentation_bytes"] for d in devices]),
            "host_rss_max_bytes": h["host_rss_max_bytes"],
            "source": ("+".join(sorted(h["sources"]))
                       if h["sources"] else None),
            "series": h["series"],
            "steps": h["steps"],
        }
    limits = [h["bytes_limit"] for h in out_hosts.values()
              if h["bytes_limit"] is not None]
    high = _worst([h["high_water_bytes"] for h in out_hosts.values()])
    run_ids = {(h.get("run_meta") or {}).get("run_id")
               for h in headers if (h.get("run_meta") or {}).get("run_id")}
    return {
        "hosts": out_hosts,
        "n_hosts": len(out_hosts),
        "high_water_bytes": high,
        "bytes_limit": min(limits) if limits else None,
        "high_water_frac": (high / min(limits)
                            if high is not None and limits
                            and min(limits) > 0 else None),
        "run_ids": sorted(run_ids),
        "headers": headers,
    }


#: the caveat of a join whose record holds no device statistics (the
#: port keeps no live-array accounting on the CPU)
CPU_DEGRADATION_NOTE = (
    "no device memory statistics in this record (a CPU run: the port "
    "keeps no live-array accounting, so bytes_in_use is null and only the "
    "host RSS is measured) — the measured-over-planned ratio is undefined "
    "and must not calibrate a memory cap")


def read_run_meta(run_dir: str) -> dict:
    """The run-metadata header the JSONL telemetry sink writes as its
    first line (the JAX ``analysis/explain.py::read_run_meta``). Raises
    for a run without one: refusing beats mis-labelling."""
    from tpu_ddp_torch.telemetry.events import RUN_META_SCHEMA_VERSION
    from tpu_ddp_torch.telemetry.summarize import find_trace_files

    files = find_trace_files(run_dir)
    with open(files[0]) as f:
        first = f.readline()
    try:
        rec = json.loads(first) if first.strip() else {}
    except json.JSONDecodeError:
        rec = {}
    if rec.get("type") == "header":
        meta = rec.get("run_meta")
        if meta:
            version = meta.get("run_meta_schema_version", 0)
            if version > RUN_META_SCHEMA_VERSION:
                raise ValueError(
                    f"{files[0]}: run_meta_schema_version {version} is "
                    "newer than this tool understands "
                    f"({RUN_META_SCHEMA_VERSION})")
            return meta
    raise ValueError(
        f"{files[0]}: no run-metadata header (the run predates the "
        "metadata header, or the trace is hand-rolled)")


def reconcile(run_dir: str, *, chip: Optional[str] = None,
              expect_strategy: Optional[str] = None,
              measured: Optional[dict] = None) -> dict:
    """Join the measured high-water against the recorded program's
    static plan. Raises ``ValueError`` on join-contract violations
    (mem record from a different run than the trace header, recorded
    strategy != ``expect_strategy``) — the same refuse-don't-mislabel
    stance as the JAX ``tpu-ddp analyze`` run-dir mode. The plan side
    degrades to a note (module docstring). ``measured`` accepts an
    already-computed :func:`measured_summary` (the CLI computes one
    anyway; don't parse every mem file twice)."""
    if measured is None:
        measured = measured_summary(run_dir)
    meta = read_run_meta(run_dir)
    notes: List[str] = []
    run_id = meta.get("run_id")
    if run_id and measured["run_ids"] \
            and run_id not in measured["run_ids"]:
        raise ValueError(
            f"{run_dir}: the memory record belongs to run_id "
            f"{measured['run_ids']} but the trace header says "
            f"{run_id!r} — mixed run dirs cannot be reconciled")
    strategy = meta.get("strategy")
    if expect_strategy and strategy != expect_strategy:
        raise ValueError(
            f"{run_dir}: recorded strategy is {strategy!r}, not "
            f"{expect_strategy!r} — refusing the join (the plan would "
            "price a different program than was measured)")
    planned = None
    try:
        from tpu_ddp_torch.memtrack.postmortem import plan_for_run_meta

        planned = plan_for_run_meta(meta)
    except Exception as e:
        notes.append(f"static plan unavailable: {e}")
    device_kind = meta.get("device_kind")
    chip_key = None
    hbm_bytes = measured["bytes_limit"]
    try:
        from tpu_ddp_torch.profiler.device import chip_spec

        spec = chip_spec(chip or device_kind)
        if spec is not None:
            chip_key = spec.key
            if hbm_bytes is None:
                hbm_bytes = spec.hbm_bytes
    except Exception:
        pass
    high = measured["high_water_bytes"]
    ratio = None
    if planned and planned.get("peak_bytes") and high is not None:
        ratio = round(high / planned["peak_bytes"], 4)
    sources = {h.get("source") for h in measured["hosts"].values()}
    exact = sources <= {"memory_stats"} and bool(sources)
    if not exact:
        notes.append(CPU_DEGRADATION_NOTE)
    return {
        "run_id": run_id,
        "strategy": strategy,
        "device_kind": device_kind,
        "chip": chip_key,
        "planned": planned,
        "measured_high_water_bytes": high,
        "bytes_limit": hbm_bytes,
        "high_water_frac": (high / hbm_bytes
                            if high is not None and hbm_bytes else None),
        "measured_over_planned": ratio,
        # only device-runtime measurements may calibrate an HBM cap:
        # the tuner's ingest keys on this flag, not on the note text
        "calibratable": bool(exact and ratio is not None),
        "notes": notes,
    }
