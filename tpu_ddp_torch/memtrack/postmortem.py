"""OOM forensics: turn an allocation failure into evidence.

The port's copy of ``tpu_ddp/memtrack/postmortem.py``, with the same
bundle layout and ``meta.json`` keys:

- :func:`is_resource_exhausted` recognizes allocation failures by their
  message, without importing torch: ``torch.cuda.OutOfMemoryError``'s
  "CUDA out of memory" matches the JAX pattern's "out of memory".
- :func:`write_postmortem` writes the one-shot bundle the trainer emits
  BEFORE re-raising::

    <run_dir>/oom/step_<n>-p<i>/
      meta.json       # schema version, step, incarnation, error, sources
      samples.jsonl   # the sampler's last memory samples (the curve
                      # that walked into the wall)
      config.json     # TrainConfig snapshot
      run_meta.json   # the run-metadata header

  The dying process writes only what it already holds.
- the trainer also emits an ``oom_abort`` trace instant, which
  ``ledger/stitch.py`` classifies as the ``oom`` exit.

The plan side of a bundle (the JAX ``attach_plan``) is rebuilt at report
time: :func:`plan_for_run_meta` runs the recorded step once on the device
the run recorded (``analysis/explain.py::program_for_run_meta``, the
``analyze`` rule: a card run read where there is no card raises its
refusal, the JAX "plan rebuild skipped" case) under the memory planner's
measurement (``tools/memplan.py``): the allocator's bytes on the card, the
live-tensor tracker's on the CPU, and the largest tensors alive at the
step's peak (``top_buffers``, the counterpart of the JAX
``largest_buffers``, which reads XLA's buffer assignment).
:func:`attach_plan` writes it as ``plan.json``, atomically. Only the
rebuild imports torch.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import List, Optional

#: bump on any breaking change to the bundle meta.json shape
OOM_SCHEMA_VERSION = 1

OOM_DIRNAME = "oom"

#: allocation-failure signatures (the JAX package's: XLA runtimes and
#: allocators; torch's "CUDA out of memory" matches "out of memory")
_OOM_PATTERNS = re.compile(
    r"RESOURCE[ _]?EXHAUSTED|out of memory|OOM when allocating"
    r"|[Aa]llocation .*failed|failed to allocate|memory exhausted",
)


def is_resource_exhausted(exc: BaseException) -> bool:
    """Does this exception look like an allocation failure? Matched on
    the rendered type name and message, so the check needs no torch and
    works on synthetic exceptions in tests."""
    text = f"{type(exc).__name__}: {exc}"
    return bool(_OOM_PATTERNS.search(text))


def bundle_dir_name(step: int, process_index: int) -> str:
    return f"step_{step}-p{process_index}"


def write_postmortem(
    run_dir: str,
    *,
    step: int,
    process_index: int = 0,
    incarnation: int = 0,
    error: Optional[BaseException] = None,
    samples: Optional[List[dict]] = None,
    config_snapshot: Optional[dict] = None,
    run_meta: Optional[dict] = None,
) -> Optional[str]:
    """Write the one-shot postmortem bundle; returns its path, or the
    existing path when this (step, host) already has one (one-shot: a
    retry loop must not spam bundles), or None when nothing could be
    written (forensics never mask the original failure)."""
    try:
        path = os.path.join(run_dir, OOM_DIRNAME,
                            bundle_dir_name(step, process_index))
        if os.path.isdir(path) and os.path.isfile(
                os.path.join(path, "meta.json")):
            return path
        os.makedirs(path, exist_ok=True)
        samples = samples or []
        with open(os.path.join(path, "samples.jsonl"), "w") as f:
            for rec in samples:
                f.write(json.dumps(rec) + "\n")
        if config_snapshot is not None:
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(config_snapshot, f, indent=1)
        if run_meta is not None:
            with open(os.path.join(path, "run_meta.json"), "w") as f:
                json.dump(run_meta, f, indent=1)
        meta = {
            "oom_schema_version": OOM_SCHEMA_VERSION,
            "type": "oom_postmortem",
            "step": step,
            "process_index": process_index,
            "incarnation": incarnation,
            "wall_time": time.time(),
            "error_type": type(error).__name__ if error else None,
            "error": (str(error)[:2000] if error is not None else None),
            "n_samples": len(samples),
            "sources": sorted(os.listdir(path)) + ["meta.json"],
        }
        # meta.json last and atomically: its presence IS the bundle's
        # completeness marker (mirrors the profiler bundle contract)
        tmp = os.path.join(path, f"meta.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(path, "meta.json"))
        return path
    except Exception:
        return None


def read_postmortem(bundle_dir: str) -> Optional[dict]:
    """One bundle's meta.json (+ parsed samples), None when absent/torn;
    raises ValueError on a future schema (refusing beats misreading)."""
    try:
        with open(os.path.join(bundle_dir, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    version = meta.get("oom_schema_version", 0)
    if isinstance(version, int) and version > OOM_SCHEMA_VERSION:
        raise ValueError(
            f"{bundle_dir}: oom_schema_version {version} is newer than "
            f"this tool understands ({OOM_SCHEMA_VERSION})")
    meta["path"] = bundle_dir
    samples: List[dict] = []
    try:
        with open(os.path.join(bundle_dir, "samples.jsonl")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    samples.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    meta["samples"] = samples
    for name in ("config", "run_meta", "plan"):
        try:
            with open(os.path.join(bundle_dir, f"{name}.json")) as f:
                meta[name] = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    return meta


def list_postmortems(run_dir: str) -> List[dict]:
    """Every complete OOM bundle under ``<run_dir>/oom/``, step order."""
    root = os.path.join(run_dir, OOM_DIRNAME)
    if not os.path.isdir(root):
        return []
    out: List[dict] = []
    for entry in sorted(os.listdir(root)):
        meta = read_postmortem(os.path.join(root, entry))
        if meta is not None:
            out.append(meta)
    out.sort(key=lambda m: (m.get("step") or 0,
                            m.get("process_index") or 0))
    return out


# -- plan attachment (report-time) ----------------------------------------

def plan_for_run_meta(meta: dict, k: int = 10) -> dict:
    """The memory plan of a recorded run: memplan's peak (arguments +
    temps, per device) and the ``k`` largest tensors alive at the step's
    peak, from the run's RECORDED program run once (module docstring).
    Raises ``ValueError`` with the analyze refusal for a program the
    rebuild does not reproduce, or a card run where there is no card.

    A rebuild that runs out of device memory (as the run it plans may
    have) is memplan's verdict, not a crash: ``fits`` False, the byte
    keys None, the most the allocator held during the rebuild, when it
    failed, in ``peak_lower_bound_bytes`` (None off the card), a ``note``,
    and the largest tensors the tracker had seen alive."""
    import contextlib

    import torch

    from tpu_ddp_torch.analysis.anatomy import fake_world
    from tpu_ddp_torch.analysis.explain import program_for_run_meta, run_meta_mesh
    from tpu_ddp_torch.analysis.lint import audit_program
    from tpu_ddp_torch.tools.memplan import live_arguments

    _, n = run_meta_mesh(meta)
    live = None

    def rebuild():
        nonlocal live
        with fake_world(n) if n > 1 else contextlib.nullcontext():
            prog = program_for_run_meta(meta)
            try:
                live = live_arguments(prog, k)
                return audit_program(prog, live=live)
            finally:
                prog.close()

    if torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()     # the lower bound is the rebuild's
    try:
        audit = rebuild()
    except torch.cuda.OutOfMemoryError:
        audit = None
    if audit is None:
        # the rebuilt state is out of scope here, so the cache can go back
        cuda = torch.cuda.is_initialized()
        reached = torch.cuda.max_memory_allocated() if cuda else None
        if cuda:
            torch.cuda.empty_cache()
        return {
            "argument_bytes": None,
            "temp_bytes": None,
            "output_bytes": None,
            "peak_bytes": None,
            "top_buffers": list(live.at_peak) if live is not None else [],
            "fits": False,
            "peak_lower_bound_bytes": reached,
            "note": ("the rebuilt step ran out of device memory"
                     + (f": {reached} B allocated when it failed, a lower "
                        "bound of the step's peak" if reached is not None else "")),
        }
    a = audit.anatomy
    if a.argument_bytes is not None:      # the card's allocator
        arg, temp, out = a.argument_bytes, a.temp_bytes, a.output_bytes
    else:                                 # the CPU's tracker
        arg, temp, out = live.start, live.peak - live.start, live.live
    return {
        "argument_bytes": int(arg),
        "temp_bytes": int(temp),
        "output_bytes": int(out),
        "peak_bytes": int(arg + temp),   # memplan's steady-state convention
        "top_buffers": list(live.at_peak),
    }


def attach_plan(bundle_dir: str, k: int = 10) -> Optional[dict]:
    """Compute the bundle's plan from its recorded ``run_meta`` and write
    it as ``plan.json`` (idempotent: an existing plan is returned, not
    recomputed; a rebuild that ran out of memory writes its verdict).
    Returns None, the bundle untouched, when the rebuild is refused here
    (``plan_for_run_meta``'s ``ValueError``)."""
    plan_path = os.path.join(bundle_dir, "plan.json")
    if os.path.isfile(plan_path):
        try:
            with open(plan_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    try:
        with open(os.path.join(bundle_dir, "run_meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    try:
        plan = plan_for_run_meta(meta, k)
    except ValueError:
        return None
    tmp = f"{plan_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(plan, f, indent=1)
    os.replace(tmp, plan_path)
    return plan
