"""Device-side capture: ``torch.profiler`` arming + per-op attribution.

The port's copy of ``tpu_ddp/profiler/device.py``. Two independent halves:

- **Device trace arming**: ``start_device_trace``/``stop_device_trace``
  run one ``torch.profiler.profile`` session for a capture window (and
  for the trainer's ``--profile-dir`` epoch), with the CPU and CUDA
  activities on the card and the CPU alone on the CPU, and write its
  Chrome trace to ``<out_dir>/trace.json`` (Perfetto loads it; on the
  card it names every kernel launched in the window, K1's
  ``fused_update_kernel`` included). One session runs at a time in a
  process: an arm while another trace runs degrades to a *note*, as does
  a profiler that fails to start, exactly as the JAX package degrades
  ``jax.profiler``. The host sampler and the measured phases still
  capture. The first session in a process pays CUPTI's set-up (a second
  or more on the card), inside the window it opens.

- **Per-op attribution**: the roofline predicts where a step's time
  *should* go from the compiled program's cost model; a capture window
  measures where the ``compiled_step`` span time *did* go, as one number.
  :func:`per_op_attribution` joins the two at op granularity: it models a
  time term for every row of an anatomy record (fused math at the bf16
  peak, memory traffic at the memory rate, and each collective bucket's
  wire bytes at the interconnect rate) and distributes the window's
  measured per-step span time across the rows in proportion. Pure
  arithmetic over the record and the chip table of
  ``analysis/roofline.py``.

``attribution_for_bundle`` takes the anatomy of the recorded program
from ``analysis/explain.py::anatomy_for_run_meta`` (the step rebuilt at
the bundle's recorded config and run once); a program that cannot be
rebuilt gives the JAX degrade shape, ``{"note": "per-op attribution
unavailable: ..."}``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

# the one chip table, as the JAX module imports it (its :97): the JAX rows
# and the port's h100, re-exported for the readers of this module
from tpu_ddp_torch.analysis.roofline import (  # noqa: F401
    CHIP_SPECS,
    _KIND_PATTERNS,
    ChipSpec,
    chip_spec,
)

log = logging.getLogger(__name__)

#: bump on any breaking change to the attribution record shape
ATTRIBUTION_SCHEMA_VERSION = 1

#: chip the attribution falls back to when the recorded device kind has
#: no published peak (the CPU) and no --chip was passed: the port's card
_FALLBACK_CHIP = "h100"


# -- device trace arming ---------------------------------------------------

#: the one running session: (profile, out_dir), None when idle
_session = None


def start_device_trace(out_dir: str, cuda: bool = False) -> Optional[str]:
    """Arm a ``torch.profiler`` session that ``stop_device_trace`` writes
    into ``out_dir``; CUDA activity too when ``cuda``. Returns None on
    success, else a one-line note for the bundle manifest."""
    global _session
    if _session is not None:
        return "torch.profiler trace unavailable: a trace already running"
    try:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:  # degrade to a note by contract
        return f"torch.profiler trace unavailable: {e}"
    _session = (prof, out_dir)
    return None


def stop_device_trace() -> Optional[str]:
    """Stop the running session and write its Chrome trace. Returns None
    on success, else a note (a failed stop must not lose the rest of the
    bundle)."""
    global _session
    if _session is None:
        return "torch.profiler trace did not finalize: no trace running"
    prof, out_dir = _session
    _session = None
    try:
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        return None
    except Exception as e:
        return f"torch.profiler trace did not finalize: {e}"


# -- per-op attribution ----------------------------------------------------

def _anatomy_fields(anatomy) -> dict:
    """Accept an anatomy record or an object with ``to_json()``."""
    if isinstance(anatomy, dict):
        return anatomy
    return anatomy.to_json()


def per_op_attribution(anatomy, measured_step_s: Optional[float],
                       chip: Optional[str] = None) -> dict:
    """Distribute a measured per-step time over the anatomy's op rows.

    Every row gets ``model_s`` (its roofline time term), ``share`` (of
    the summed model time), and, when a measurement is given,
    ``attributed_s = measured_step_s * share``. Attributed times sum to
    the measured span by construction. The JAX function, with the chip
    table above.
    """
    rec = _anatomy_fields(anatomy)
    notes: List[str] = []
    kind = chip or rec.get("device_kind")
    spec = chip_spec(kind)
    if spec is None or spec.peak_bf16_flops is None:
        notes.append(
            f"no published peak for {kind!r}: attributing against "
            f"{_FALLBACK_CHIP} (pass --chip to choose)"
        )
        spec = chip_spec(_FALLBACK_CHIP)

    rows: List[Dict[str, object]] = []
    flops = rec.get("flops")
    if flops:
        rows.append({
            "op": "compute (fused math)",
            "model_s": float(flops) / spec.peak_bf16_flops,
            "detail": f"{float(flops):.3e} flops @ bf16 peak",
        })
    accessed = rec.get("bytes_accessed")
    if accessed:
        rows.append({
            "op": "hbm traffic",
            "model_s": float(accessed) / spec.hbm_bw,
            "detail": f"{float(accessed):.3e} bytes @ hbm bw",
        })
    for c in rec.get("collectives") or ():
        c = c if isinstance(c, dict) else c.__dict__
        key = (f"{c['kind']}/{c['dtype']}/{c['axis']}"
               f"/g{c['group_size']}")
        wire = float(c.get("wire_bytes") or 0)
        rows.append({
            "op": key,
            "model_s": wire / spec.ici_bw if spec.ici_bw else 0.0,
            "detail": (f"{c.get('count')}x, {int(wire)} wire bytes "
                       "@ ici link bw"),
        })

    model_total = sum(r["model_s"] for r in rows)
    if not rows or model_total <= 0:
        notes.append("anatomy carries no cost-model figures to "
                     "distribute over (backend exposed no cost analysis)")
    for r in rows:
        share = r["model_s"] / model_total if model_total > 0 else 0.0
        r["share"] = share
        if measured_step_s:
            r["attributed_s"] = measured_step_s * share
    rows.sort(key=lambda r: (-r["model_s"], r["op"]))
    # >1 means the step runs slower than the serial roofline sum: host
    # gaps, launch overhead, or a chip mismatch
    vs_model = (measured_step_s / model_total
                if measured_step_s and model_total > 0 else None)
    return {
        "schema_version": ATTRIBUTION_SCHEMA_VERSION,
        "chip": spec.key,
        "measured_step_s": measured_step_s,
        "model_step_s": model_total if rows else None,
        "measured_vs_model": vs_model,
        "strategy": rec.get("strategy"),
        "model": rec.get("model"),
        "ops": rows,
        "notes": notes,
    }


def measured_step_from_meta(meta: dict) -> Optional[float]:
    """The window's measured per-STEP time from a bundle's
    ``measured_phases`` (total time / optimizer steps covered: right
    under ``--steps-per-call``, where a span covers K steps). The port's
    step is its dispatch (``compiled_step``) plus the wait for the card
    behind it (``device_sync``); the JAX one is ``compiled_step`` alone."""
    phases = meta.get("measured_phases") or {}
    compiled = phases.get("compiled_step") or {}
    total = compiled.get("total_s")
    steps = (meta.get("window") or {}).get("steps")
    if not isinstance(total, (int, float)) or not steps:
        return None
    sync = (phases.get("device_sync") or {}).get("total_s")
    if isinstance(sync, (int, float)):
        total += sync
    return total / steps


def attribution_for_bundle(meta: dict,
                           chip: Optional[str] = None) -> dict:
    """Rebuild the recorded program from the bundle's run metadata (the
    ``anatomy_for_run_meta`` path, on the device the run recorded) and
    attribute the window's measured step time per op; ``rebuilt_on``
    names that device's kind. Any failure — no torch, a program the
    rebuild can't reproduce, a card run read where there is no card —
    returns ``{"note": ...}``: the report must keep rendering."""
    run_meta = meta.get("run_meta") or {}
    measured = measured_step_from_meta(meta)
    try:
        from tpu_ddp_torch.analysis.explain import anatomy_for_run_meta

        anatomy = anatomy_for_run_meta(run_meta)
        return {**per_op_attribution(anatomy, measured, chip),
                "rebuilt_on": anatomy.device_kind}
    except Exception as e:  # degrade, never take the report down
        return {"note": f"per-op attribution unavailable: {e}"}