"""Input-cost model assembled from measured data-path evidence.

Counterpart of ``tpu_ddp/datapath/model.py`` (``stage_baselines``,
``DataModel``, ``data_model_from_sources``), line for line: ``tpu-ddp-torch
data bench`` artifacts (plus registry entries of kind ``"data"``) merge by
the median into a :class:`DataModel`, whose load-bearing number is seconds
of host input work per image, and whose per-stage rate table baselines the
DAT001 stage-throughput-collapse alert (``monitor/alerts.py``).

Data evidence is not chip-filtered: the input pipeline runs on the host
CPU, so a bench from any host of the same fleet is admissible;
``device_kind`` rides along as provenance only.

Stdlib-only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Any, Dict, List, Mapping, Optional, Sequence

#: bump on any breaking change to the ``data bench --json`` artifact
DATA_SCHEMA_VERSION = 1


def data_record(art: Mapping) -> Optional[Mapping]:
    """The ``"data"`` object of a bench artifact (accepts the full
    artifact or the object itself), or None when it isn't one."""
    if not isinstance(art, Mapping):
        return None
    rec = art.get("data") if isinstance(art.get("data"), Mapping) else art
    if not isinstance(rec, Mapping):
        return None
    if not isinstance(rec.get("stages"), Mapping) and not isinstance(
        rec.get("per_image_s"), (int, float)
    ):
        return None
    return rec


def stage_baselines(rec: Mapping) -> Dict[str, float]:
    """Per-stage benched throughput reference for the DAT001 alert:
    ``{stage: batches_per_s}`` from an artifact (or its ``"data"``
    object). Stages without a positive measured rate are dropped."""
    rec = data_record(rec)
    if rec is None:
        return {}
    stages = rec.get("stages")
    if not isinstance(stages, Mapping):
        return {}
    out: Dict[str, float] = {}
    for stage, view in stages.items():
        if not isinstance(view, Mapping):
            continue
        rate = view.get("batches_per_s")
        if isinstance(rate, (int, float)) and rate > 0:
            out[str(stage)] = float(rate)
    return out


@dataclasses.dataclass
class DataModel:
    """Merged measured input-cost evidence for one fleet's hosts."""

    per_image_s: float = 0.0
    batch_time_s: float = 0.0
    global_batch: int = 0
    dominant_stage: Optional[str] = None
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)
    source: str = "none"

    def __bool__(self) -> bool:
        return self.per_image_s > 0.0

    def input_floor_s(self, images_per_step: int, *, overlap: float = 1.0) -> float:
        """Seconds of host input work per step for a candidate moving
        ``images_per_step`` images, discounted by the prefetch overlap
        factor (1.0 = fully serialized with the step; N means the
        pipeline hides all but 1/N of the input time)."""
        ov = max(float(overlap), 1.0)
        return self.per_image_s * max(int(images_per_step), 0) / ov

    def to_json(self) -> dict:
        return {
            "per_image_s": self.per_image_s,
            "batch_time_s": self.batch_time_s,
            "global_batch": self.global_batch,
            "dominant_stage": self.dominant_stage,
            "stages": dict(self.stages),
            "source": self.source,
        }


def _model_fields(rec: Mapping) -> Optional[Dict[str, Any]]:
    per_image = rec.get("per_image_s")
    if not isinstance(per_image, (int, float)) or per_image <= 0:
        return None
    return {
        "per_image_s": float(per_image),
        "batch_time_s": float(rec.get("batch_time_s") or 0.0),
        "global_batch": int(rec.get("global_batch") or 0),
        "dominant_stage": rec.get("dominant_stage"),
        "stages": stage_baselines(rec),
    }


def _record_from_file(path: str) -> Optional[Mapping]:
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return data_record(art)


def data_model_from_sources(
    sources: Sequence[str] = (),
    *,
    registry_dir: Optional[str] = None,
) -> DataModel:
    """Assemble the input-cost model from every applicable piece of
    evidence — ``data bench --json`` artifact files plus registry
    entries of kind ``"data"`` — merged by the median per-image cost
    (the ``comms_model_for_chip`` shape). With no evidence the model is
    empty (falsy) and the tuner prices no input floor."""
    fields: List[Dict[str, Any]] = []
    used: List[str] = []
    for src in sources:
        if os.path.isdir(src):
            continue  # data evidence is artifact files, not run dirs
        rec = _record_from_file(src)
        f = _model_fields(rec) if rec is not None else None
        if f is not None:
            fields.append(f)
            used.append(os.path.basename(src) or src)
    if registry_dir:
        from tpu_ddp_torch.registry.store import read_entries

        try:
            entries = read_entries(registry_dir)
        except (OSError, ValueError):
            entries = []
        found = False
        for entry in entries:
            if entry.artifact_kind != "data":
                continue
            rec = data_record((entry.programs or {}).get("data") or {})
            f = _model_fields(rec) if rec is not None else None
            if f is not None:
                fields.append(f)
                found = True
        if found:
            used.append(f"registry:{registry_dir}")
    if not fields:
        return DataModel()
    per_image = statistics.median(f["per_image_s"] for f in fields)
    batch_time = statistics.median(
        f["batch_time_s"] for f in fields if f["batch_time_s"] > 0
    ) if any(f["batch_time_s"] > 0 for f in fields) else 0.0
    # per-stage rates: median across the evidence that measured the stage
    per_stage: Dict[str, List[float]] = {}
    for f in fields:
        for stage, rate in f["stages"].items():
            per_stage.setdefault(stage, []).append(rate)
    stages = {s: statistics.median(rs) for s, rs in per_stage.items()}
    # dominant stage: slowest per-batch, i.e. the lowest benched rate
    dominant = min(stages, key=stages.get) if stages else None
    return DataModel(
        per_image_s=per_image,
        batch_time_s=batch_time,
        global_batch=max((f["global_batch"] for f in fields), default=0),
        dominant_stage=dominant,
        stages=stages,
        source="+".join(used) if used else "none",
    )
