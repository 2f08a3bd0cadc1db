"""Exposed-comm attribution: measure the NON-overlapped comm share.

The port's copy of ``tpu_ddp/comms/exposure.py``. The roofline's
``comm_share_of_step`` is a model (static wire bytes over link bandwidth);
this module measures what actually stayed exposed: time the recorded
program (rebuilt at the run's ``TrainConfig`` through the path ``tpu-ddp-torch
analyze`` itself uses, ``train/strategy.py::build_step_program``) over the
launched ranks, against its COMM-STRIPPED TWIN: the same config on one
rank, whose per-rank compute is the same and which issues no collective.
The difference is the step time the collectives could not hide:

    exposed_comm_s      = max(0, t_full - t_stripped)
    measured_comm_share = exposed_comm_s / t_full

dp-family only (dp, +zero1, +grad-compress): those strategies replicate
compute, so the one-rank twin really is compute-identical. Model,
sequence and pipeline sharding change per-rank compute with the mesh, so
this refuses them by name, as JAX does; and a run of one rank (nothing to
expose), or one recorded on more ranks than were launched.

Each rank is a process: run it under ``python -m tpu_ddp_torch.cli.launch
--nproc-per-node N`` with N the recorded ranks, as ``comms bench`` runs.
Every rank times the full program (a warm step, then the minimum over
``reps`` steps, each followed by a wait for the card); then the group is
left and rank 0 times the twin alone, and writes.

The record lands in ``<run_dir>/comms-exposure.json``, where ``tpu-ddp-torch
analyze`` and ``trace summarize`` join it (``read_exposure``, stdlib-only).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

COMMS_EXPOSURE_SCHEMA_VERSION = 1

#: the run-dir filename the analyze/summarize joins look for
EXPOSURE_FILENAME = "comms-exposure.json"

#: strategies whose one-rank twin is compute-identical (replicated
#: compute; collectives are pure overhead)
_DP_FAMILY = ("dp",)


def _time_program(cfg, reps: int) -> float:
    """Min-of-reps wall time of one optimizer step of ``cfg``'s program
    over the process group that is up (none: one rank), after a warm
    step; each timed step ends with a wait for the card."""
    import torch

    from tpu_ddp_torch.train.strategy import build_step_program

    prog = build_step_program(cfg)
    dev = prog.trainer.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        prog.step()
        sync()
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            prog.step()
            sync()
            best = min(best, time.perf_counter() - t0)
    finally:
        prog.close()
    return best


def check_exposure(meta: dict, launched: int) -> int:
    """The recorded program's rank count, after the JAX refusals
    (``ValueError``): a family other than dp, a run on one rank, a run on
    more ranks than launched (or fewer: the launch must match it)."""
    parallelism = meta.get("strategy", "dp")
    if parallelism not in _DP_FAMILY:
        raise ValueError(
            f"exposure twin needs replicated compute; {parallelism!r} "
            "shards compute with the mesh, so its 1-device twin would "
            "mis-attribute model/pipeline compute as comm (dp-family "
            "runs only)"
        )
    n_needed = 1
    for s in (meta.get("mesh") or {}).values():
        n_needed *= int(s)
    if n_needed < 2:
        raise ValueError(
            "run trained on a single device: there is no comm to expose")
    if n_needed > launched:
        raise ValueError(
            f"run trained on {n_needed} devices; only {launched} "
            "launched here — re-run under python -m tpu_ddp_torch.cli.launch "
            f"--nproc-per-node {n_needed}"
        )
    if n_needed < launched:
        raise ValueError(
            f"run trained on {n_needed} devices; {launched} launched — "
            f"launch exactly {n_needed}")
    return n_needed


def measure_exposure(run_dir: str, *, reps: int = 10,
                     device: str = "cuda") -> Optional[dict]:
    """Measure the run's exposed comm share over the process group that
    is up (module docstring); every rank calls it, rank 0 gets the record
    and the others None. The group is left before the twin runs. Raises
    ``ValueError`` for runs the twin method cannot attribute, on every
    rank, before any rank times anything."""
    import dataclasses

    import torch

    from tpu_ddp_torch.analysis.explain import (
        measured_phases,
        read_run_meta,
        run_meta_config,
        run_strategy_label,
    )
    from tpu_ddp_torch.parallel import runtime

    meta = read_run_meta(run_dir)
    n = check_exposure(meta, runtime.world_size())
    cfg = run_meta_config(meta, device)
    t_full = _time_program(cfg, reps)
    primary = runtime.is_primary_process()
    runtime.shutdown()
    if not primary:
        return None
    # the twin strips the whole comm PATH, not just the wire hops: the
    # quantized ring's pack/unpack and zero1's shard bookkeeping exist
    # only to serve the exchange, so their cost belongs to exposed comm
    twin = dataclasses.replace(cfg, grad_compress="none",
                               grad_compress_error_feedback=False, zero1=False,
                               zero3=False, synthetic_size=cfg.per_shard_batch)
    t_stripped = _time_program(twin, reps)
    exposed = max(0.0, t_full - t_stripped)
    try:
        phases = measured_phases(run_dir)
        step_rec = phases.get("compiled_step", {})
        # the port's step: its dispatch and the wait for the card behind it
        telemetry_step = step_rec.get("with_device_sync_p50_s") \
            or step_rec.get("per_step_p50_s") or step_rec.get("p50_s")
    except Exception:
        telemetry_step = None
    dev = torch.device(device)
    return {
        "comms_exposure_schema_version": COMMS_EXPOSURE_SCHEMA_VERSION,
        "run_id": meta.get("run_id"),
        "strategy": run_strategy_label(meta),
        "mesh": {a: int(s) for a, s in (meta.get("mesh") or {}).items()},
        "n_devices": n,
        "device_kind": (torch.cuda.get_device_name() if dev.type == "cuda" else "cpu"),
        "reps": reps,
        "t_full_s": t_full,
        "t_stripped_s": t_stripped,
        "exposed_comm_s": exposed,
        "measured_comm_share": (exposed / t_full) if t_full > 0 else None,
        "telemetry_step_p50_s": telemetry_step,
    }


def write_exposure(run_dir: str, rec: dict) -> str:
    """Atomically land the record where the joins look for it."""
    path = os.path.join(run_dir, EXPOSURE_FILENAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_exposure(run_dir: str) -> Optional[dict]:
    """The run's exposure record, or None — stdlib-only so the analyze/
    summarize joins can call it without loading torch."""
    path = os.path.join(run_dir, EXPOSURE_FILENAME)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(rec, dict) \
            or "comms_exposure_schema_version" not in rec:
        return None
    return rec
