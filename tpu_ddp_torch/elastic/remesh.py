"""Re-mesh planning: fit the run onto the surviving device set.

The port's copy of ``tpu_ddp/elastic/remesh.py``. Pure arithmetic over the
mesh/strategy constraints — deliberately NOT a torch import (counting
cards would initialize CUDA inside the supervisor, whose whole job is to
outlive the runtime). The divisibility
rules mirror ``parallel/mesh.py::MeshSpec.resolve`` and the strategy
axis table in ``train/strategy.py``; a survivor count that cannot
satisfy them is a **named refusal** (``RemeshRefusal``), which the
supervisor either escalates to the operator or resolves through the
auto-tuner's next-ranked lint-clean candidate (``--fallback-plan``,
the ``tpu-ddp-torch tune --json`` artifact).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional

#: mirror of parallel/mesh.py::AXIS_ORDER (kept literal: importing the
#: mesh module would pull torch into the supervisor)
MESH_AXES = ("data", "pipeline", "expert", "sequence", "model")


class RemeshRefusal(Exception):
    """The survivor set cannot run the strategy — with the reason named."""


@dataclasses.dataclass
class RemeshPlan:
    """What the supervisor relaunches with."""

    n_devices: int
    parallelism: Optional[str]      # None = dp/inferred (child default)
    mesh: Optional[Dict[str, int]]  # explicit axis sizes, or None
    source: str                     # "initial" | "shrink" | "fallback"
    candidate_name: Optional[str] = None   # tuner candidate, on fallback
    extra_flags: Optional[Dict[str, str]] = None  # overlay flags a
                                    # fallback candidate carries
    notes: Optional[List[str]] = None

    def mesh_arg(self) -> Optional[str]:
        if not self.mesh:
            return None
        return ",".join(f"{axis}={size}"
                        for axis, size in self.mesh.items())

    def to_json(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "parallelism": self.parallelism,
            "mesh": dict(self.mesh) if self.mesh else None,
            "source": self.source,
            "candidate_name": self.candidate_name,
            "extra_flags": dict(self.extra_flags or {}),
            "notes": list(self.notes or []),
        }


def _fixed_product(mesh: Dict[str, int]) -> int:
    return math.prod(v for k, v in mesh.items()
                     if k != "data" and v not in (-1, None))


def plan_remesh(
    *,
    n_devices: int,
    parallelism: Optional[str] = None,
    mesh: Optional[Dict[str, int]] = None,
    global_batch: Optional[int] = None,
    source: str = "shrink",
) -> RemeshPlan:
    """Fit (strategy, mesh) onto ``n_devices`` survivors, or refuse by
    name.

    The data axis absorbs the shrink (it is the elastic axis — data
    parallel replicas are interchangeable); the strategy-owned axes
    (model/pipeline/sequence/expert) keep their sizes, because shrinking
    them changes the compiled program family, which is the fallback
    plan's business, not a shrink's. Refusals name the exact constraint:
    non-data axes that no longer divide the survivors, a data axis that
    would go to zero, a global batch the new data axis cannot split.
    """
    if n_devices < 1:
        raise RemeshRefusal(f"no survivors ({n_devices} devices)")
    notes: List[str] = []
    sizes = dict(mesh or {})
    for axis in sizes:
        if axis not in MESH_AXES:
            raise RemeshRefusal(
                f"unknown mesh axis {axis!r} (axes: {MESH_AXES})")
    fixed = _fixed_product(sizes)
    if fixed > 1:
        if n_devices % fixed:
            non_data = {k: v for k, v in sizes.items()
                        if k != "data" and v != 1}
            raise RemeshRefusal(
                f"{n_devices} survivor(s) cannot satisfy the "
                f"strategy's non-data axes {non_data} "
                f"(product {fixed} does not divide {n_devices}); "
                "shrinking a strategy-owned axis would change the "
                "program family — use --fallback-plan to re-plan")
        data = n_devices // fixed
        if data < 1:
            raise RemeshRefusal(
                f"{n_devices} survivor(s) leave no room for a data "
                f"axis beside the non-data axes (product {fixed})")
        new_mesh = {**sizes, "data": data}
    else:
        data = n_devices
        # a 1-D (dp/fsdp) mesh needs no explicit --mesh: --n-devices
        # does the whole job and the child infers the rest
        new_mesh = dict(sizes, data=n_devices) if sizes else None
    if global_batch is not None:
        if global_batch % data:
            raise RemeshRefusal(
                f"global batch {global_batch} does not divide across "
                f"{data} data shard(s) on {n_devices} survivor(s) — "
                "the recipe's global batch is held fixed across a "
                "re-mesh so the seed band stays comparable")
        notes.append(
            f"global batch {global_batch} held fixed: "
            f"{global_batch // data} rows/shard on {data} shard(s)")
    return RemeshPlan(
        n_devices=n_devices,
        parallelism=parallelism,
        mesh=new_mesh,
        source=source,
        notes=notes,
    )


def fallback_from_tune(
    artifact_path: str,
    *,
    n_devices: int,
    global_batch: Optional[int] = None,
) -> RemeshPlan:
    """The next-ranked lint-clean tuner candidate that FITS the
    survivors (``tpu-ddp-torch tune --json`` artifact, docs/tuning.md): walked
    in rank order, each candidate's non-data axes re-checked against the
    survivor count (its data axis re-absorbs the difference). Raises
    ``RemeshRefusal`` naming every candidate tried when none fits."""
    try:
        with open(artifact_path) as f:
            artifact = json.load(f)
    except (OSError, ValueError) as e:
        raise RemeshRefusal(
            f"--fallback-plan {artifact_path!r} is unreadable: {e}")
    ranked = artifact.get("ranked")
    if not isinstance(ranked, list) or not ranked:
        raise RemeshRefusal(
            f"--fallback-plan {artifact_path!r} has no ranked "
            "candidates (is it a `tpu-ddp-torch tune --json` artifact?)")
    tried: List[str] = []
    for row in ranked:
        if not isinstance(row, dict):
            continue
        if row.get("status") not in (None, "ok", "ranked"):
            tried.append(f"{row.get('name')}: status {row.get('status')}")
            continue
        mesh = {
            k: v for k, v in (row.get("mesh") or {}).items() if v != 1
        }
        mesh.pop("data", None)
        try:
            plan = plan_remesh(
                n_devices=n_devices,
                parallelism=row.get("parallelism"),
                mesh=mesh or None,
                global_batch=global_batch,
                source="fallback",
            )
        except RemeshRefusal as e:
            tried.append(f"{row.get('name')}: {e}")
            continue
        extra: Dict[str, str] = {}
        if row.get("zero1"):
            extra["--zero1"] = ""
        if row.get("grad_compress") not in (None, "none"):
            extra["--grad-compress"] = str(row["grad_compress"])
        if row.get("steps_per_call") not in (None, 1):
            extra["--steps-per-call"] = str(row["steps_per_call"])
        plan.candidate_name = row.get("name")
        plan.extra_flags = extra
        plan.notes = list(plan.notes or []) + [
            f"fallback to tuner candidate {row.get('name')!r}"]
        return plan
    raise RemeshRefusal(
        "no ranked tuner candidate fits "
        f"{n_devices} survivor(s): " + "; ".join(tried[:8]))
