"""Provenance stamping: git identity + deterministic config digests.

Counterpart of ``tpu_ddp/telemetry/provenance.py``, digest for digest: the
same config gives the same ``config_digest`` and ``quality_digest`` in both
packages. Every durable artifact (the run-metadata header the sinks write,
the summarizer's JSON) says which commit produced it and which logical
configuration it measured.

Three pieces, all stdlib-only (the launcher and the readers must never pull
in torch):

- :func:`git_provenance` — subprocess probe of the working tree
  (``git rev-parse HEAD`` + ``git status --porcelain``). Graceful
  ``None``/``None`` outside a repo or without a git binary.
- :func:`config_digest` — the deterministic run-id recipe (sha1 of the
  sort-keyed JSON, first 10 hex chars), the one digest function.
- :func:`artifact_provenance` — the header dict an artifact embeds
  (``git_commit``/``git_dirty``, ``config_digest``, device kind, torch
  version, strategy/mesh when known, schema version).
"""

from __future__ import annotations

import functools
import hashlib
import json
import subprocess
from typing import Any, Dict, Optional

#: bump on any breaking change to the provenance header shape
PROVENANCE_SCHEMA_VERSION = 1

_GIT_TIMEOUT_S = 5.0


@functools.lru_cache(maxsize=16)
def _git_probe(cwd: Optional[str]) -> tuple:
    """(commit, dirty) for the repo containing ``cwd`` — cached per
    process (the probe is two subprocesses; Trainer init and every
    artifact writer call this). ``(None, None)`` outside a repo or
    without git; a dirty probe that fails after the commit succeeded
    reports ``dirty=None`` (unknown), never a guess."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd, capture_output=True, text=True,
            timeout=_GIT_TIMEOUT_S,
        )
    except (OSError, subprocess.SubprocessError):
        return None, None
    if out.returncode != 0:
        return None, None
    commit = out.stdout.strip() or None
    if commit is None:
        return None, None
    try:
        st = subprocess.run(
            ["git", "status", "--porcelain"],
            cwd=cwd, capture_output=True, text=True,
            timeout=_GIT_TIMEOUT_S,
        )
        dirty = bool(st.stdout.strip()) if st.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        dirty = None
    return commit, dirty


def git_provenance(cwd: Optional[str] = None) -> Dict[str, Any]:
    """``{"git_commit": <40-hex or None>, "git_dirty": bool or None}``
    for the repository containing ``cwd`` (default: the process cwd)."""
    commit, dirty = _git_probe(cwd)
    return {"git_commit": commit, "git_dirty": dirty}


def config_digest(obj: Any) -> str:
    """Deterministic 10-hex digest of a JSON-serializable config — the
    recipe the Trainer stamps as ``run_id``, so the same config yields the same digest on every host (and every
    commit) with no coordination."""
    return hashlib.sha1(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:10]


#: TrainConfig keys excluded from :func:`quality_digest`: the RNG seed
#: (different seeds of one recipe must form ONE seed-band series) and
#: every run-local knob — filesystem paths, resume/observability wiring —
#: that changes between launches without changing what the run LEARNS.
#: Learning-relevant knobs (lr, batch, model, overlays, dtype, ...) stay
#: in; two configs that differ only in these keys train interchangeable
#: trajectories by construction.
QUALITY_DIGEST_EXCLUDED = (
    "seed",
    "resume",
    # run-local paths
    "data_dir",
    "checkpoint_dir",
    "health_dir",
    "telemetry_dir",
    "jsonl_path",
    "tensorboard_dir",
    "profile_dir",
    "compilation_cache_dir",
    "plot_curves",
    "dump_predictions",
    # run-local observability/process wiring (no effect on the update rule)
    "download",
    "monitor_port",
    "monitor_bind",
    "monitor_allow_remote_trigger",
    "profile_steps",
    "profile_window_steps",
    "profile_host_hz",
    "telemetry_sinks",
    "telemetry_snapshot_steps",
    "mem_sample_steps",
    "watchdog_deadline_seconds",
    "log_every_epochs",
    "log_every_steps",
    "lint_on_start",
    "checkpoint_every_epochs",
    "checkpoint_steps",
    "keep_best",
    # fault wiring: injected faults / watchdog escalation change what a
    # run SURVIVES, not what it learns
    "chaos_spec",
    "watchdog_abort",
)

#: keys that name the physical LAYOUT of a run, not its learning recipe
#: — dropped from :func:`quality_digest` when the caller supplies the
#: data-axis size, because the recipe-relevant quantity they encode is
#: the GLOBAL batch (folded in as a derived key instead). This is what
#: makes the seed band *mesh-invariant by construction*: an elastic
#: re-mesh (8 ranks -> 4 survivors at the same global batch) stays in
#: the same band series.
#: ``kernels`` rides along: the hand-written kernels are bit-identical to
#: their plain versions BY CONTRACT (ops/fused_update.py,
#: ops/fused_quant.py), so flipping the switch must not split a seed-band
#: series — the learning recipe is the same recipe.
QUALITY_DIGEST_LAYOUT_KEYS = ("n_devices", "mesh", "per_shard_batch",
                              "kernels")


def quality_digest(config_snapshot: dict,
                   data_size: Optional[int] = None) -> str:
    """Seed-invariant sibling of the run's ``config_digest``: the digest
    of the config with :data:`QUALITY_DIGEST_EXCLUDED` keys dropped.

    ``run_id`` (= ``config_digest`` of the full snapshot) folds ``seed``,
    so every seed is a DIFFERENT registry series — useless for a seed
    band. ``quality_digest`` names the learning recipe itself: N seeded
    runs of one recipe share it, which is what the curve readers key
    their baseline envelopes on.

    With ``data_size`` (the mesh's data-axis size — the Trainer always
    passes it) the digest is additionally MESH-invariant: the layout
    keys are replaced by the derived ``global_batch`` they determine, so
    one recipe trained on 8 devices and re-meshed to 4 survivors at the
    same global batch keeps one digest. Without ``data_size`` (pure
    config-side callers) the layout keys stay in — a conservative
    fallback that can only split series, never wrongly merge them."""
    reduced = {
        k: v for k, v in config_snapshot.items()
        if k not in QUALITY_DIGEST_EXCLUDED
    }
    if data_size is not None:
        for key in QUALITY_DIGEST_LAYOUT_KEYS:
            reduced.pop(key, None)
        per_shard = config_snapshot.get("per_shard_batch")
        if isinstance(per_shard, int):
            reduced["global_batch"] = per_shard * int(data_size)
    return config_digest(reduced)


def artifact_provenance(
    *,
    descriptor: Any = None,
    run_id: Optional[str] = None,
    quality_digest: Optional[str] = None,
    device_kind: Optional[str] = None,
    torch_version: Optional[str] = None,
    strategy: Optional[str] = None,
    mesh: Optional[dict] = None,
    cwd: Optional[str] = None,
) -> Dict[str, Any]:
    """The provenance header an artifact writer embeds.

    ``config_digest`` is ``run_id`` when the artifact came from a run
    (the Trainer's deterministic config digest IS its identity),
    otherwise the digest of ``descriptor`` — a small stable dict naming
    what was measured (e.g. ``{"artifact": "trace_summary",
    "strategy": "dp"}``), so re-captures of the same thing land in the same
    registry series across commits.
    """
    prov: Dict[str, Any] = {
        "provenance_schema_version": PROVENANCE_SCHEMA_VERSION,
        **git_provenance(cwd),
        "config_digest": run_id if run_id else (
            config_digest(descriptor) if descriptor is not None else None),
    }
    if run_id:
        prov["run_id"] = run_id
    if quality_digest:
        # the seed-invariant series key, carried BESIDE run_id wherever
        # the run stamped one
        prov["quality_digest"] = quality_digest
    if device_kind is not None:
        prov["device_kind"] = device_kind
    if torch_version is not None:
        prov["torch_version"] = torch_version
    if strategy is not None:
        prov["strategy"] = strategy
    if mesh is not None:
        prov["mesh"] = dict(mesh)
    return prov
