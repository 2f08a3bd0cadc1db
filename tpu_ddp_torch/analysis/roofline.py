"""Chip-spec table + roofline attribution for one train step.

The port's copy of ``tpu_ddp/analysis/roofline.py``, with the JAX names
and the JAX table, and the port's card first: the ``h100`` row (NVIDIA's
H100 SXM data sheet: 989.4 TFLOP/s dense bf16, 80 GB at 3.35 TB/s, NVLink
4 at 450 GB/s a direction over 18 links). As in JAX it is the one home of
the chip peaks: ``profiler/device.py`` (the per-op table), ``comms/model.py``
(the link evidence's chip key), ``ops/model.py`` and ``metrics/mfu.py``
read it.

``roofline()`` converts a :class:`tpu_ddp_torch.analysis.anatomy.StepAnatomy`
(or any object with its fields) into the three time terms a step is made
of --

- **compute**: the step's FLOPs / the bf16 peak,
- **hbm**: the step's bytes accessed / the memory bandwidth,
- **ici**: ring-model collective wire bytes / one link's bandwidth
  (the NVLink row on the card),

-- classifies which term bounds the step, and predicts the step time under
a stated overlap assumption (``overlapped`` = max of the terms; ``serial``
= their sum, the no-overlap upper bound). A chip with no published peak
(the CPU) yields ``bound="unknown"`` rather than a made-up denominator;
pass an explicit ``chip=`` to ask how the program would sit on an H100.

Stdlib-only at module level: ``peak_flops_per_chip`` imports torch when
it is called.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

#: bump on any breaking change to the RooflineReport dict shape
ROOFLINE_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip peak figures. ``None`` means "no published peak" — every
    consumer must treat that as "cannot classify", never as zero."""

    key: str                           # short name: "v5e", "v4", "cpu"
    description: str
    peak_bf16_flops: Optional[float]   # MXU peak, FLOP/s per chip
    hbm_bytes: Optional[int]           # capacity (decimal units where the
                                       # spec is quoted decimal; v2-v4 GiB)
    hbm_bw: Optional[float]            # bytes/s per chip
    ici_bw: Optional[float]            # one-way bytes/s per ICI link
    ici_links: int = 0                 # links per chip (torus degree)


CHIP_SPECS: Dict[str, ChipSpec] = {
    # the port's card (module docstring)
    "h100": ChipSpec("h100", "NVIDIA H100 80GB HBM3", 989.4e12,
                     80_000_000_000, 3.35e12, 4.5e11, 18),
    "v6e": ChipSpec("v6e", "TPU v6e (Trillium)", 918e12,
                    32_000_000_000, 1.64e12, 9.0e10, 4),
    "v5p": ChipSpec("v5p", "TPU v5p", 459e12,
                    95_000_000_000, 2.765e12, 9.0e10, 6),
    "v5e": ChipSpec("v5e", "TPU v5e", 197e12,
                    16_000_000_000, 8.1e11, 4.5e10, 4),
    "v4": ChipSpec("v4", "TPU v4", 275e12,
                   32 * 1024**3, 1.228e12, 4.5e10, 6),
    "v3": ChipSpec("v3", "TPU v3", 123e12,
                   32 * 1024**3, 9.0e11, 2.0e10, 4),
    "v2": ChipSpec("v2", "TPU v2", 45e12,
                   16 * 1024**3, 7.0e11, 1.5e10, 4),
    # CPU hosts (the 8-virtual-device test mesh): programs compile and the
    # collective inventory is exact, but there is no peak to quote.
    "cpu": ChipSpec("cpu", "CPU host (no published peak)",
                    None, None, None, None, 0),
}

# Substring-matched against a device kind (lowercased: the JAX
# ``device_kind`` strings, and ``torch.cuda.get_device_name`` on the card);
# first hit wins, so more specific patterns come first. The bare "v5" pattern is
# load-bearing: v5p chips report device_kind "TPU v5" (v5e reports
# "TPU v5 lite", matched earlier).
_KIND_PATTERNS = (
    ("h100", "h100"),
    ("v6e", "v6e"),
    ("v6 lite", "v6e"),
    ("trillium", "v6e"),
    ("v5p", "v5p"),
    ("v5e", "v5e"),
    ("v5 lite", "v5e"),
    ("v5litepod", "v5e"),
    ("v5", "v5p"),
    ("v4", "v4"),
    ("v3", "v3"),
    ("v2", "v2"),
    ("cpu", "cpu"),
)


def chip_spec(kind_or_key: Optional[str]) -> Optional[ChipSpec]:
    """Resolve a chip spec from a short key ("h100", "v5e") or a device
    kind string ("NVIDIA H100 80GB HBM3", "TPU v5 lite"). None if
    unknown."""
    if not kind_or_key:
        return None
    text = kind_or_key.lower()
    if text in CHIP_SPECS:
        return CHIP_SPECS[text]
    for pattern, key in _KIND_PATTERNS:
        if pattern in text:
            return CHIP_SPECS[key]
    return None


def peak_flops_per_chip(device=None) -> Optional[float]:
    """The dense bf16 peak of ``device`` (a ``torch.device`` or its
    string; default: the current CUDA device when there is one), None on
    the CPU and on a card the table does not hold. (The figure
    ``metrics/mfu.py`` re-exports: MFU is quoted against the bf16 peak.)"""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    index = None if device is None else torch.device(device).index
    spec = chip_spec(torch.cuda.get_device_name(index))
    return spec.peak_bf16_flops if spec else None


def hbm_bytes_per_chip(device_kind: str) -> Optional[int]:
    """HBM capacity for a device-kind string (the JAX memory planner's fit
    verdict routes through this)."""
    spec = chip_spec(device_kind)
    return spec.hbm_bytes if spec else None


@dataclasses.dataclass
class RooflineReport:
    """Where the step time must go, per the cost model + chip spec."""

    chip: Optional[str]                # ChipSpec.key, or None (no spec)
    overlap: str                       # "overlapped" | "serial"
    compute_s: Optional[float]
    hbm_s: Optional[float]
    ici_s: Optional[float]
    bound: str                         # compute | hbm | ici | unknown
    predicted_step_s: Optional[float]
    notes: List[str] = dataclasses.field(default_factory=list)

    def fractions(self) -> Dict[str, float]:
        """Each term as a fraction of the serial total (reads as "share of
        the un-overlapped step"); empty when nothing is quantified."""
        terms = {"compute": self.compute_s, "hbm": self.hbm_s,
                 "ici": self.ici_s}
        total = sum(v for v in terms.values() if v)
        if not total:
            return {}
        return {k: v / total for k, v in terms.items() if v is not None}

    def to_json(self) -> dict:
        rec = dataclasses.asdict(self)
        rec["schema_version"] = ROOFLINE_SCHEMA_VERSION
        rec["fractions"] = self.fractions()
        return rec


def _ici_term(anatomy, spec, comms_model, notes: List[str]):
    """The roofline's collective-time term. With a measured comms model
    (``comms/model.py``), every inventoried collective is priced through
    its fitted α-β line (``count·α + wire/β``, measured ``tpu-ddp-torch
    comms bench`` evidence); collectives the model has no evidence for fall
    back to the spec-sheet link bandwidth. Without a model, the whole
    term is the classic single-link ``wire / ici_bw``."""
    wire = sum(c.wire_bytes for c in anatomy.collectives)
    if not wire:
        return 0.0
    spec_bw = spec.ici_bw if spec else None
    if comms_model:
        total = 0.0
        fallback_wire = 0
        for c in anatomy.collectives:
            t = comms_model.time_for(
                c.kind, c.dtype, c.axis, c.wire_bytes, count=c.count)
            if t is not None:
                total += t
            else:
                fallback_wire += c.wire_bytes
        if fallback_wire and spec_bw:
            total += fallback_wire / spec_bw
        elif fallback_wire:
            notes.append(
                f"comms model has no evidence for {fallback_wire} wire "
                "bytes of collectives and the chip has no spec-sheet "
                "link bandwidth: those collectives are unpriced"
            )
        notes.append(
            "ici term uses the measured comms model "
            f"(source {comms_model.source})"
        )
        return total
    # one link: the conservative single-ring assumption (a torus or
    # NVLink's 18 links can stripe a ring over more; that would shrink
    # this term)
    return wire / spec_bw if spec_bw else None


def roofline(anatomy, chip: Optional[str] = None, *,
             overlap: str = "overlapped",
             comms_model=None) -> RooflineReport:
    """Attribute ``anatomy`` (a StepAnatomy) onto ``chip``'s roofline.

    ``chip`` defaults to the anatomy's own device kind; pass a short key
    ("h100") to ask how a step counted on the CPU would sit on real
    hardware (the step's flops/bytes/collective inventory are properties
    of the partitioned program, not of the executing backend).

    ``comms_model`` (a ``comms/model.py`` LinkModel with evidence)
    replaces the spec-sheet ICI term with measured per-link α-β pricing.
    It also unlocks peak-less chips (CPU hosts): compute/hbm stay
    unquantified, but the comm term is real measurement, so the report
    carries a comm-only prediction (``bound="ici"``) instead of
    refusing outright.
    """
    if overlap not in ("overlapped", "serial"):
        raise ValueError(
            f"overlap must be 'overlapped' or 'serial', got {overlap!r}"
        )
    spec = chip_spec(chip or anatomy.device_kind)
    notes: List[str] = []
    if spec is not None and chip and spec.key != "cpu" \
            and chip_spec(anatomy.device_kind) is not spec:
        notes.append(
            f"program compiled for {anatomy.device_kind!r}, attributed "
            f"against the {spec.key} spec"
        )
    if spec is None or spec.peak_bf16_flops is None:
        kind = spec.key if spec else (chip or anatomy.device_kind)
        if comms_model:
            ici_s = _ici_term(anatomy, spec, comms_model, notes)
            return RooflineReport(
                chip=spec.key if spec else None, overlap=overlap,
                compute_s=None, hbm_s=None, ici_s=ici_s,
                bound="ici" if ici_s else "unknown",
                predicted_step_s=ici_s or None,
                notes=notes + [
                    f"no published peak for {kind!r}: compute/hbm terms "
                    "unquantified — prediction covers the MEASURED comm "
                    "term only"
                ],
            )
        return RooflineReport(
            chip=spec.key if spec else None, overlap=overlap,
            compute_s=None, hbm_s=None, ici_s=None,
            bound="unknown",
            predicted_step_s=None,
            notes=notes + [
                f"no published peak for {kind!r}: pass chip='v5e' (or "
                "another CHIP_SPECS key) to classify against real hardware"
            ],
        )

    compute_s = (anatomy.flops / spec.peak_bf16_flops
                 if anatomy.flops else None)
    hbm_s = (anatomy.bytes_accessed / spec.hbm_bw
             if anatomy.bytes_accessed and spec.hbm_bw else None)
    ici_s = _ici_term(anatomy, spec, comms_model, notes)
    if anatomy.flops is None:
        notes.append("cost model exposed no flops: compute term missing")
    if anatomy.bytes_accessed is None:
        notes.append("cost model exposed no bytes-accessed: hbm term "
                     "missing")

    terms = {"compute": compute_s, "hbm": hbm_s, "ici": ici_s}
    known = {k: v for k, v in terms.items() if v is not None}
    if not known:
        bound, predicted = "unknown", None
    else:
        bound = max(known, key=lambda k: known[k])
        predicted = (max(known.values()) if overlap == "overlapped"
                     else sum(known.values()))
    return RooflineReport(
        chip=spec.key, overlap=overlap,
        compute_s=compute_s, hbm_s=hbm_s, ici_s=ici_s,
        bound=bound, predicted_step_s=predicted, notes=notes,
    )
