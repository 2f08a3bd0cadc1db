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

The plan side of a bundle (the JAX ``attach_plan``: the static peak and
the largest buffers of the recorded program's compiled HLO, rebuilt at
report time through ``analysis/explain.py`` and ``tools/memplan.py``) has
no counterpart in the port yet: :func:`plan_for_run_meta` raises and
:func:`attach_plan` returns None, the JAX functions' answers where the
rebuild cannot run.
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
    """The static memory plan of a recorded run: the JAX package rebuilds
    the recorded program (``analysis/explain.py::compiled_for_run_meta``)
    and reads its memory analysis. The port has no such rebuild yet, so
    this raises, as the JAX function does where the rebuild cannot run."""
    del meta, k
    raise ValueError("the port has no static plan of a recorded run yet "
                     "(analysis/ and tools/memplan.py are not ported)")


def attach_plan(bundle_dir: str, k: int = 10) -> Optional[dict]:
    """A bundle's static plan, ``plan.json``: an existing one is returned
    (a bundle the JAX package planned); else None, the JAX answer when
    the plan cannot be rebuilt here."""
    del k
    try:
        with open(os.path.join(bundle_dir, "plan.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
