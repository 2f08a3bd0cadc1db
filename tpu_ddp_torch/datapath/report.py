"""Post-hoc data-path attribution of a run dir: the summarizer's data
section.

Counterpart of ``tpu_ddp/datapath/report.py`` (``datapath_measured``,
``format_datapath_measured``). Reads a run dir's JSONL traces and
decomposes the trainer's ``data_wait`` into the loader's stage spans
(``data/<stage>``, ``data/loader.py``) and the staged prefetcher's queue
gauges (``datapath/prefetch_*``, ``datapath/prefetch.py``):

- the synchronous path (``--prefetch-depth 0``): the stage spans nest
  inside ``data_wait``, so their p50s should sum to it;
- the staged prefetcher (``--prefetch-batches N``): the stages run on the
  background thread and the queue gauges carry the verdict;
- the native ring (the default ``--prefetch-depth 2``): no stage runs in
  Python, so there is no evidence and the section is empty.

Stdlib-only. The JAX package's ``data report`` CLI and stage monitor
(``datapath/stages.py``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List

#: the loader's stages in pipeline order, and the host ones (the JAX
#: ``datapath/stages.py`` ``STAGES`` and ``HOST_STAGES``)
STAGES = ("index", "gather", "augment", "collate", "shard", "h2d")
HOST_STAGES = STAGES[:-1]

#: |1 - coverage| beyond this flags the decomposition as not accounting
#: for the wait (eval-loader spans and first-batch effects both skew the
#: p50s, so this is deliberately loose)
COVERAGE_TOLERANCE = 0.5

#: prefetch verdict needs one side to dominate by this factor
_PREFETCH_DOMINANCE = 2.0

_STAGE_SPAN = {s: f"data/{s}" for s in HOST_STAGES}
_STAGE_SPAN["h2d"] = "h2d"


def datapath_measured(path: str) -> Dict[str, Any]:
    """The run dir's measured data-path evidence: per-stage span
    percentiles, the ``data_wait`` they decompose, and the prefetch
    queue counters. Empty dict when the run left no stage spans and no
    prefetch counters (the native-prefetch default path)."""
    from tpu_ddp_torch.telemetry.summarize import (
        aggregate_phases,
        find_trace_files,
        last_counters,
        read_records,
    )

    try:
        files = find_trace_files(path)
    except FileNotFoundError:
        return {}
    records = read_records(files)
    phases = aggregate_phases(records)

    stages: Dict[str, Dict[str, float]] = {}
    for stage in STAGES:
        h = phases.get(_STAGE_SPAN[stage])
        if h is None or not h.count:
            continue
        stages[stage] = {
            "count": h.count,
            "p50_s": h.percentile(50),
            "p95_s": h.percentile(95),
            "total_s": h.sum,
        }
    wait = phases.get("data_wait")
    data_wait = (
        {
            "count": wait.count,
            "p50_s": wait.percentile(50),
            "p95_s": wait.percentile(95),
            "total_s": wait.sum,
        }
        if wait is not None and wait.count
        else None
    )

    prefetch: Dict[str, float] = {}
    for snap in last_counters(records).values():
        flat = dict(snap.get("counters", {}))
        flat.update(snap.get("gauges", {}))
        for key, val in flat.items():
            if key.startswith("datapath/prefetch_") and isinstance(
                val, (int, float)
            ):
                short = key[len("datapath/") :]
                prefetch[short] = prefetch.get(short, 0.0) + float(val)

    if not stages and not prefetch:
        return {}

    out: Dict[str, Any] = {
        "stages": stages,
        "data_wait": data_wait,
        "prefetch": prefetch or None,
    }
    host = {s: v for s, v in stages.items() if s in HOST_STAGES}
    if host:
        out["dominant_stage"] = max(host, key=lambda s: host[s]["total_s"])
        out["stage_sum_p50_s"] = sum(v["p50_s"] for v in host.values())
    else:
        out["dominant_stage"] = None
        out["stage_sum_p50_s"] = None
    # sync-path coverage: the host stages run INSIDE data_wait, so their
    # p50s should sum to it; meaningless under the background prefetcher
    if data_wait and out["stage_sum_p50_s"] and not prefetch and data_wait["p50_s"] > 0:
        out["coverage"] = out["stage_sum_p50_s"] / data_wait["p50_s"]
    else:
        out["coverage"] = None
    out["verdict"] = _verdict(out)
    return out


def _verdict(d: Dict[str, Any]) -> str:
    pf = d.get("prefetch") or {}
    put = float(pf.get("prefetch_put_wait_total_s", 0.0))
    get = float(pf.get("prefetch_get_wait_total_s", 0.0))
    dominant = d.get("dominant_stage")
    if pf:
        if put > _PREFETCH_DOMINANCE * get:
            return (
                "device-bound: the prefetcher spent "
                f"{put:.2f}s blocked on a full queue vs {get:.2f}s of "
                "trainer get-wait — the loader keeps up"
            )
        if get > _PREFETCH_DOMINANCE * put and get > 0:
            return (
                "input-bound: the trainer spent "
                f"{get:.2f}s waiting on an empty prefetch queue vs "
                f"{put:.2f}s of producer put-wait"
                + (f" — dominant stage: {dominant}" if dominant else "")
            )
        return (
            f"balanced: put-wait {put:.2f}s vs get-wait {get:.2f}s "
            "(neither side dominates)"
        )
    if dominant:
        return f"dominant stage: {dominant} (synchronous staged path)"
    return "no stage evidence"


def format_datapath_measured(d: Dict[str, Any]) -> List[str]:
    """The measured data-path block the summarizer renders. Empty list
    for an empty measurement."""
    if not d:
        return []
    lines = ["data path (measured):"]
    stages = d.get("stages") or {}
    if stages:
        lines.append(
            f"  {'stage':<10} {'count':>7} {'p50 ms':>9} {'p95 ms':>9} "
            f"{'total s':>9}"
        )
        for stage in STAGES:
            v = stages.get(stage)
            if v is None:
                continue
            lines.append(
                f"  {stage:<10} {v['count']:>7} {v['p50_s'] * 1e3:>9.3f} "
                f"{v['p95_s'] * 1e3:>9.3f} {v['total_s']:>9.2f}"
            )
    wait = d.get("data_wait")
    if wait:
        lines.append(
            f"  data_wait  {wait['count']:>7} {wait['p50_s'] * 1e3:>9.3f} "
            f"{wait['p95_s'] * 1e3:>9.3f} {wait['total_s']:>9.2f}"
        )
    cov = d.get("coverage")
    if cov is not None:
        ok = abs(1.0 - cov) <= COVERAGE_TOLERANCE
        lines.append(
            f"  stage p50 sum / data_wait p50 = {cov:.2f} "
            f"({'accounts for the wait' if ok else 'does NOT account for the wait'})"
        )
    pf = d.get("prefetch")
    if pf:
        occ = pf.get("prefetch_occupancy")
        parts = []
        if occ is not None:
            parts.append(f"occupancy {occ:.1f}")
        for key, label in (
            ("prefetch_put_wait_total_s", "put-wait"),
            ("prefetch_get_wait_total_s", "get-wait"),
        ):
            if key in pf:
                parts.append(f"{label} {pf[key]:.2f}s")
        if parts:
            lines.append("  prefetch queue: " + ", ".join(parts))
    lines.append(f"  verdict: {d.get('verdict')}")
    return lines
